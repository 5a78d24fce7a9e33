"""Masked segment reductions (counterpart of `escgnn_tpu/ops/segment.py`).

Every op takes an explicit validity mask instead of relying on
out-of-range ids being dropped, so padding policy lives in one place.
The copy levels of a batch give their padding rows an out-of-range id,
which JAX drops and a gather refuses: `masked_ids` sends the masked
rows to segment 0, where their neutral values change nothing. A sorted
view keeps that in-range id for its gather and sorts the masked rows
last, under the id `num_segments`, where K1 drops them unread as JAX's
sums drop out-of-range ids.
Max and min fill masked rows with the dtype's finite extreme before the
reduce (`scatter_reduce` with `include_self=False`, whose gradient splits
a tie evenly, as JAX's does) and give `empty_value` for empty segments.

Sums add in a fixed order, so one input gives one result on every run,
as the JAX package's do. `segment_sum` sorts the ids stably into a
`SortedIds` view and adds each segment's run with the sorted segment sum
(K1, `ops/expand_cuda.py`) in f32, cast back to the values' dtype; its
backward is a gather. `gather_rows` is its adjoint: a row gather whose
backward is K1 over the ids' view. `index_add_` adds with atomics on the
card, in no fixed order, and it is also `index_select`'s backward. On
the CPU the same routing runs, with K1's plain version as the final sum.

Inside a `sorted_views()` scope (each train, eval or refresh step opens
one) a view is built once per ids tensor, mask and segment count, and
dies with the scope: a view never outlives the step that built it, so a
captured step sorts inside its graph and each replay sorts the batch its
buffers then hold. Outside a scope every call sorts.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from escgnn_tpu_torch.ops import expand_cuda


def _apply_mask(values, mask: Optional[torch.Tensor], fill=0.0):
    if mask is None:
        return values
    m = mask.reshape(mask.shape + (1,) * (values.dim() - mask.dim()))
    return torch.where(m, values, torch.full((), fill, dtype=values.dtype,
                                             device=values.device))


def masked_ids(segment_ids, mask: torch.Tensor):
    """`segment_ids` with the rows `mask` drops sent to segment 0, so an
    out-of-range padding id never reaches a sum or a gather."""
    return torch.where(mask, segment_ids, torch.zeros_like(segment_ids))


@dataclasses.dataclass(frozen=True)
class SortedIds:
    """A stable sort of an id array: `ids` (E,) int32 in range (the rows a
    mask drops sent to 0), for the gather; `ids_sorted` (E,) int32
    non-decreasing, the ids with the dropped rows sent to `num_segments`
    (so sorted last, and dropped by K1), and `perm` (E,) int32 the stable
    order that sorts them; the segment count."""
    ids: torch.Tensor
    perm: torch.Tensor
    ids_sorted: torch.Tensor
    num_segments: int


# the open scopes' caches, innermost last
_SCOPES: list = []


@contextlib.contextmanager
def sorted_views():
    """A scope, one step, in which `sorted_ids` builds each view once."""
    _SCOPES.append({})
    try:
        yield
    finally:
        _SCOPES.pop()


def _version(t) -> int:
    return -1 if t is None else t._version


def sorted_ids(segment_ids, num_segments: int,
               mask: Optional[torch.Tensor] = None) -> SortedIds:
    """The sorted view of `segment_ids` (any integer dtype) over
    `num_segments` segments: the rows `mask` drops gather row 0 and sort
    last, past every segment. In a `sorted_views()` scope the view of one
    (ids, mask, count) is built once, keyed on the tensors and their
    versions: an in-place refill of either builds a new one."""
    cache = _SCOPES[-1] if _SCOPES else None
    key = (id(segment_ids), id(mask), int(num_segments))
    versions = (_version(segment_ids), _version(mask))
    if cache is not None:
        hit = cache.get(key)
        # the entry holds its tensors alive, so their ids name them alone
        if hit is not None and hit[0] == versions:
            return hit[2]
    ids = segment_ids.to(torch.int32)
    order = ids
    if mask is not None:
        order = torch.where(mask, ids, int(num_segments))
        ids = masked_ids(ids, mask)
    ids_sorted, perm = torch.sort(order, stable=True)
    view = SortedIds(ids, perm.to(torch.int32), ids_sorted,
                     int(num_segments))
    if cache is not None:
        cache[key] = (versions, (segment_ids, mask), view)
    return view


def sum_by_view(values, view: SortedIds):
    """sum_i values[i] into rows view.ids[i] by K1 -> (num_segments, ...)
    in the values' dtype. Values of any rank are summed as (E, -1) rows;
    K1 adds f32 or bf16 rows in f32 (other float types go in as f32)."""
    E = values.shape[0]
    shape = (view.num_segments,) + tuple(values.shape[1:])
    if E == 0:
        return values.new_zeros(shape)
    rows = values.reshape(E, -1)
    if rows.dtype not in (torch.float32, torch.bfloat16):
        rows = rows.to(torch.float32)
    out = expand_cuda.sorted_segment_sum(expand_cuda.as_rows(rows),
                                         view.perm, view.ids_sorted,
                                         view.num_segments)
    return out.reshape(shape).to(values.dtype)


class _SegmentSum(torch.autograd.Function):
    """out[s] = sum_{i: ids[i] = s} values[i] by K1; backward the gather
    dValues = dOut[ids]."""

    @staticmethod
    def forward(ctx, values, view: SortedIds):
        ctx.view = view
        return sum_by_view(values, view)

    @staticmethod
    def backward(ctx, d_out):
        return _GatherRows.apply(d_out, ctx.view), None


class _GatherRows(torch.autograd.Function):
    """y = x[ids]; backward dX = dY summed by ids (K1)."""

    @staticmethod
    def forward(ctx, x, view: SortedIds):
        ctx.view = view
        return x.index_select(0, view.ids)

    @staticmethod
    def backward(ctx, d_y):
        return _SegmentSum.apply(d_y, ctx.view), None


def gather_rows(x, ids, view: Optional[SortedIds] = None):
    """`x.index_select(0, ids)` whose backward adds the rows' gradients
    in a fixed order: K1 over `view`, else the sorted view of `ids` over
    x's rows. Without a gradient to carry, a plain `index_select`."""
    if not (x.requires_grad and torch.is_grad_enabled()):
        idx = ids if view is None else view.ids
        if idx.dtype not in (torch.int32, torch.int64):
            idx = idx.long()
        return x.index_select(0, idx)
    if view is None:
        view = sorted_ids(ids, x.shape[0])
    return _GatherRows.apply(x, view)


def segment_sum(values, segment_ids, num_segments: int,
                mask: Optional[torch.Tensor] = None,
                view: Optional[SortedIds] = None):
    """sum_i values[i] into rows segment_ids[i]; masked-out rows
    contribute 0. Added in a fixed order by K1, in f32, and cast back to
    the values' dtype; `view` is the ids' (and mask's) view if given."""
    values = _apply_mask(values, mask)
    if view is None:
        view = sorted_ids(segment_ids, num_segments, mask)
    return _SegmentSum.apply(values, view)


def segment_mean(values, segment_ids, num_segments: int,
                 mask: Optional[torch.Tensor] = None):
    """Masked segment mean; empty segments yield 0."""
    view = sorted_ids(segment_ids, num_segments, mask)
    s = segment_sum(values, segment_ids, num_segments, mask, view=view)
    ones = (torch.ones(values.shape[0], dtype=s.dtype, device=s.device)
            if mask is None else mask.to(s.dtype))
    cnt = segment_sum(ones, segment_ids, num_segments,
                      view=view).clamp_min(1.0)
    return s / cnt.reshape(cnt.shape + (1,) * (s.dim() - 1))


def _segment_extreme(values, segment_ids, num_segments, mask, reduce,
                     fill, empty_value):
    values = _apply_mask(values, mask, fill)
    if mask is not None:
        segment_ids = masked_ids(segment_ids, mask)
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
    view = sorted_ids(segment_ids, num_segments, mask)
    mx = segment_max(filled, view.ids, num_segments)
    ex = torch.exp(torch.clamp_min(filled - gather_rows(mx, None, view),
                                   neg))
    ex = _apply_mask(ex, mask)
    denom = segment_sum(ex, None, num_segments, view=view).clamp_min(1e-16)
    return ex / gather_rows(denom, None, view)


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
    if reduce == "sum":
        return segment_sum(values, batch.node_graph, G, mask)
    if reduce == "mean":
        return segment_mean(values, batch.node_graph, G, mask)
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
