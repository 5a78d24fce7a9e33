"""Masked segment reductions (counterpart of `escgnn_tpu/ops/segment.py`).

Every op takes an explicit validity mask instead of relying on
out-of-range ids being dropped, so padding policy lives in one place.
The copy levels of a batch give their padding rows an out-of-range id,
which JAX drops and `index_add_` refuses: `masked_ids` sends the masked
rows to segment 0, where their neutral values change nothing.
Max and min fill masked rows with the dtype's finite extreme before the
reduce (`scatter_reduce` with `include_self=False`, whose gradient splits
a tie evenly, as JAX's does) and give `empty_value` for empty segments.
"""

from __future__ import annotations

from typing import Optional

import torch


def _apply_mask(values, mask: Optional[torch.Tensor], fill=0.0):
    if mask is None:
        return values
    m = mask.reshape(mask.shape + (1,) * (values.dim() - mask.dim()))
    return torch.where(m, values, torch.full((), fill, dtype=values.dtype,
                                             device=values.device))


def masked_ids(segment_ids, mask: torch.Tensor):
    """`segment_ids` with the rows `mask` drops sent to segment 0, so an
    out-of-range padding id never reaches a scatter or a gather."""
    return torch.where(mask, segment_ids, torch.zeros_like(segment_ids))


def segment_sum(values, segment_ids, num_segments: int,
                mask: Optional[torch.Tensor] = None):
    """sum_i values[i] into rows segment_ids[i]; masked-out rows
    contribute 0."""
    values = _apply_mask(values, mask)
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, segment_ids.long(), values)


def segment_mean(values, segment_ids, num_segments: int,
                 mask: Optional[torch.Tensor] = None):
    """Masked segment mean; empty segments yield 0."""
    s = segment_sum(values, segment_ids, num_segments, mask)
    ones = (torch.ones(values.shape[0], dtype=s.dtype, device=s.device)
            if mask is None else mask.to(s.dtype))
    cnt = segment_sum(ones, segment_ids, num_segments).clamp_min(1.0)
    return s / cnt.reshape(cnt.shape + (1,) * (s.dim() - 1))


def _segment_extreme(values, segment_ids, num_segments, mask, reduce,
                     fill, empty_value):
    values = _apply_mask(values, mask, fill)
    idx = segment_ids.long().reshape((-1,) + (1,) * (values.dim() - 1))
    out = torch.full((num_segments,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out = out.scatter_reduce(0, idx.expand_as(values), values, reduce,
                             include_self=False)
    empty = out <= fill if reduce == "amax" else out >= fill
    return torch.where(empty, torch.full((), empty_value, dtype=out.dtype,
                                         device=out.device), out)


def segment_max(values, segment_ids, num_segments: int,
                mask: Optional[torch.Tensor] = None,
                empty_value: float = 0.0):
    """Masked segment max; empty segments yield `empty_value`."""
    return _segment_extreme(values, segment_ids, num_segments, mask, "amax",
                            torch.finfo(values.dtype).min, empty_value)


def segment_min(values, segment_ids, num_segments: int,
                mask: Optional[torch.Tensor] = None,
                empty_value: float = 0.0):
    """Masked segment min; empty segments yield `empty_value`."""
    return _segment_extreme(values, segment_ids, num_segments, mask, "amin",
                            torch.finfo(values.dtype).max, empty_value)


def segment_softmax(logits, segment_ids, num_segments: int,
                    mask: Optional[torch.Tensor] = None):
    """Numerically stable softmax within segments (attention pooling).
    Masked rows are filled with the finite dtype-min before the exp: a
    masked logit can exceed its segment's max, and its exp would
    overflow to inf before the mask and reach the gradient as inf * 0."""
    neg = torch.finfo(logits.dtype).min
    filled = _apply_mask(logits, mask, neg)
    mx = segment_max(filled, segment_ids, num_segments)
    ex = torch.exp(torch.clamp_min(filled - mx[segment_ids.long()], neg))
    ex = _apply_mask(ex, mask)
    denom = segment_sum(ex, segment_ids, num_segments).clamp_min(1e-16)
    return ex / denom[segment_ids.long()]


def pool_nodes_to_graphs(values, batch, reduce: str = "sum"):
    """Pool per-node rows to per-graph rows: (N, F) -> (G, F).

    On the uniform per-graph block layout this is a masked reshape + axis
    reduction, which (as `jnp.sum` does) sums low-precision inputs in f32
    and casts the result back; otherwise the masked segment reduction.
    """
    G = batch.num_graphs
    n_u = batch.nodes_per_graph
    mask = batch.node_mask
    if n_u is not None and values.shape[0] == G * n_u:
        v = values.reshape(G, n_u, *values.shape[1:])
        m = mask.reshape(G, n_u)
        mm = m.reshape(m.shape + (1,) * (v.dim() - 2))
        s = torch.where(mm, v.float(), 0.0).sum(1)
        if reduce == "sum":
            return s.to(values.dtype)
        if reduce == "mean":
            cnt = m.float().sum(1).clamp_min(1.0)
            return (s / cnt.reshape((G,) + (1,) * (s.dim() - 1))).to(
                values.dtype)
        raise ValueError(reduce)
    s = segment_sum(values, batch.node_graph, G, mask)
    if reduce == "sum":
        return s
    if reduce == "mean":
        cnt = segment_sum(mask.to(s.dtype), batch.node_graph, G).clamp_min(1.0)
        return s / cnt.reshape((G,) + (1,) * (s.dim() - 1))
    raise ValueError(reduce)


def _block_reduce(values, mask, c: int, n: int, reduce: str):
    """(c * n, ...) rows -> (c, ...): masked sum or mean over each block of
    n rows, summed in f32 (as `jnp.sum` sums low-precision inputs) and
    cast back to the values' dtype."""
    v = values.reshape(c, n, *values.shape[1:])
    m = mask.reshape(c, n)
    mm = m.reshape(m.shape + (1,) * (v.dim() - 2))
    s = torch.where(mm, v.float(), 0.0).sum(1)
    if reduce == "mean":
        cnt = m.float().sum(1).clamp_min(1.0)
        s = s / cnt.reshape((c,) + (1,) * (s.dim() - 1))
    elif reduce != "sum":
        raise ValueError(reduce)
    return s.to(values.dtype)


def pool_copy_blocks(values, batch, num_segments: int, reduce: str = "mean"):
    """Pool node rows to subgraph-copy rows on the uniform per-copy layout
    (`data/uniform_copies.py`): (N, F) -> (S, F) as a masked reshape and
    axis reduction, block index == copy segment id, so the rows align
    with the copy-level segment arrays. On the bucketed layout
    (`batch.seg_regions`) each region is reduced the same way and the two
    are concatenated. Returns None when the batch is not copy-uniform (the
    caller then takes the masked segment reduction)."""
    regions = batch.seg_regions
    if regions is not None:
        (cs, n_s, _), (cl, n_l, _) = regions
        if (num_segments != cs + cl
                or values.shape[0] != cs * n_s + cl * n_l):
            return None
        outs, off = [], 0
        for c, n in ((cs, n_s), (cl, n_l)):
            if c == 0:
                continue
            outs.append(_block_reduce(values[off:off + c * n],
                                      batch.node_mask[off:off + c * n], c, n,
                                      reduce))
            off += c * n
        return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
    n_c = batch.nodes_per_seg
    if n_c is None or values.shape[0] != num_segments * n_c:
        return None
    return _block_reduce(values, batch.node_mask, num_segments, n_c, reduce)


def masked_mean(values, mask, axis=None):
    """Mean of `values` over the positions where `mask` is true; `mask`
    covers the leading axes of `values` and counts once per position (a
    masked row of F features is one count, as in JAX). No position
    selected gives 0."""
    m = mask.reshape(mask.shape + (1,) * (values.dim() - mask.dim()))
    s = torch.where(m, values, torch.zeros((), dtype=values.dtype,
                                           device=values.device))
    if axis is None:
        return s.sum() / m.sum().clamp_min(1)
    return s.sum(axis) / m.sum(axis).clamp_min(1)
