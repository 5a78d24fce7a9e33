"""Embedding lookup (counterpart of `escgnn_tpu/ops/embed.py`).

The JAX package gives `jnp.take` a one-hot-matmul backward because XLA's
gather transpose is a serial scatter on the TPU. Here the lookup is
`gather_rows` (`ops/segment.py`), whose backward adds each id's output
gradients in a fixed order (K1 over the ids' sorted view), as the
one-hot product's transpose does. `F.embedding`'s CUDA backward adds
them in no fixed order: two steps from one state gave other gradients
of an edge-type table on an H100.
"""

from __future__ import annotations

from escgnn_tpu_torch.ops.segment import gather_rows


def embed_take(table, ids):
    """table[ids] for integer ids of any leading shape."""
    rows = gather_rows(table, ids.reshape(-1))
    return rows.reshape(tuple(ids.shape) + tuple(table.shape[1:]))
