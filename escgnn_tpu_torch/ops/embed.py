"""Embedding lookup (counterpart of `escgnn_tpu/ops/embed.py`).

The JAX package gives `jnp.take` a one-hot-matmul backward because XLA's
gather transpose is a serial scatter on the TPU. In PyTorch the lookup
is `F.embedding`, whose gradient is the same sum of output gradients per
id.
"""

from __future__ import annotations

import torch.nn.functional as F


def embed_take(table, ids):
    """table[ids] for integer ids of any leading shape."""
    return F.embedding(ids.long(), table)
