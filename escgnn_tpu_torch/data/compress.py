"""Lossless compressed batch pools (counterpart of
`escgnn_tpu/data/compress.py`).

A stacked train pool is almost entirely small non-negative integers: ESC
bucket ids and counts, categorical features, block-local indices, and
the host count matrix `enc_countmat`, an f32 tensor whose entries are
small integers. `compress_tree` downcasts every tensor of a host batch
to the smallest integer dtype that holds its exact values (an f32 tensor
only when every entry is a finite integer), so the cast back is exact;
`make_decoder` returns that cast back, which the pool steps apply to each
batch on the card (inside the captured step on a CUDA device) before the
model sees it. The kernels never see a compressed tensor.

Tensors are keyed by their flat `GraphBatch.tensors()` name (an extra as
`extras.<name>`), where the JAX package keys them by pytree path. The
dtype choices are the JAX package's, leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from escgnn_tpu_torch.data.container import GraphBatch

_SMALL_INTS = (np.int8, np.int16, np.int32)


def _compress_leaf(v: np.ndarray) -> np.ndarray:
    """The smallest exact form of one host array: an integer array in the
    smallest of int8/int16/int32 that holds its range (only when that is
    narrower than its dtype), a float array whose entries are all finite
    integers in int8 or int16, else the array itself."""
    orig = v.dtype
    if v.ndim == 0 or v.size == 0 or orig == np.bool_:
        return v
    if np.issubdtype(orig, np.integer):
        lo, hi = int(v.min()), int(v.max())
        for dt in _SMALL_INTS:
            info = np.iinfo(dt)
            if info.min <= lo and hi <= info.max:
                if np.dtype(dt).itemsize < orig.itemsize:
                    return v.astype(dt)
                return v
        return v
    if np.issubdtype(orig, np.floating):
        if not np.all(np.isfinite(v)):
            return v
        r = np.round(v)
        if not np.array_equal(r, v):
            return v
        lo, hi = int(r.min()), int(r.max())
        for dt in (np.int8, np.int16):
            info = np.iinfo(dt)
            if info.min <= lo and hi <= info.max:
                return r.astype(dt)
        return v
    return v


def compress_tree(batch: GraphBatch) -> tuple:
    """Downcast each tensor of a host batch losslessly. Returns the
    compressed batch and `metas`, {flat name: original dtype}, for every
    tensor, downcast or not: one decoder then serves any other stack of
    the same fields (the val, test and refresh stacks), whichever of its
    tensors happened to compress."""
    out, metas = {}, {}
    for k, t in batch.tensors().items():
        metas[k] = t.dtype
        out[k] = torch.from_numpy(_compress_leaf(t.numpy()))
    return batch.with_tensors(out), metas


def compress_tree_like(batch: GraphBatch, ref: GraphBatch) -> GraphBatch:
    """`batch` with each tensor cast to the dtype of the same-named tensor
    of an already compressed `ref`, so that every pool shares one decoder
    and one captured step. Raises if a cast would change a value."""
    ref_t = ref.tensors()
    mine = batch.tensors()
    if set(mine) != set(ref_t):
        raise ValueError(f"the batch's tensors {sorted(mine)} are not the "
                         f"reference's {sorted(ref_t)}")
    out = {}
    for k, t in mine.items():
        want = ref_t[k].dtype
        if t.dtype == want:
            out[k] = t
            continue
        c = t.to(want)
        if not torch.equal(c.to(t.dtype), t):
            raise ValueError(
                f"pool tensor {k} does not cast losslessly to the first "
                f"pool's compressed dtype {want} (orig {t.dtype})")
        out[k] = c
    return batch.with_tensors(out)


def make_decoder(metas: dict):
    """The inverse of `compress_tree`: `decode(batch)` casts every tensor
    named in `metas` back to its original dtype (a no-op for one that was
    not downcast). Names `metas` does not hold pass through, so the
    decoder also restores a view of the batch with fields dropped or
    added (the edge shards of `parallel/edge_partition.py`)."""
    targets = dict(metas)

    def decode(batch: GraphBatch) -> GraphBatch:
        out = {}
        for k, t in batch.tensors().items():
            want = targets.get(k)
            out[k] = t if want is None or t.dtype == want else t.to(want)
        return batch.with_tensors(out)

    return decode


def pool_nbytes(batch: GraphBatch) -> int:
    """The bytes of a batch's (or a stacked pool's) tensors."""
    return sum(t.nbytes for t in batch.tensors().values())
