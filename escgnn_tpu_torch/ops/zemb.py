"""Structural-embedding reduce: the z_emb hot op (counterpart of
`escgnn_tpu/ops/zemb.py`, dedup, width and flat layouts).

Per edge e:  z_emb[e] = sum_{k in nnz(e)} count_k * table[bucket_k].

On the dedup layout the reduce runs over the batch's R unique histogram
rows and is expanded to the E edges with one gather (`expand_rows`), whose
backward is the sorted-segment-sum kernel (K1) on CUDA tensors. With
bucket compaction the (Zc, H) active table is gathered first; with the
host count matrix `enc_countmat` the reduce is one matmul C @ table.
On the width layout the reduce runs over the E edge rows directly. On
the flat layout (`zemb_weighted_flat`) the K COO entries are gathered,
weighted and summed into their edges; its backward sums them once more
into the table by bucket id (dTable) and takes a gathered dot per entry
(dCnt), where JAX scans 128-entry blocks of one-hot matmuls, a TPU
workaround for scatters. Both sums sort the entries by their target row
on the device (`ops/segment.py`'s sorted views) and add the runs with the
sorted segment sum (K1), which
adds every row's terms in a fixed order, so the flat path gives the same
sums on every run: `index_add_` adds with atomics in no fixed order, and
on dTable, where hundreds of entries share a bucket and largely cancel,
Adam carried that noise into graphed and eager losses 1% apart within
four steps on an H100.

Without a host count matrix, `zemb_weighted_gather` reduces by impl:
  * "countmat" (the default): C built in PyTorch, then C @ table;
  * "countmat_pallas": the fused count-matrix kernel (K2), which also
    returns C;
  * "gather": the plain gather-reduce;
  * "pallas": the row-gather kernel (K3).
The names are the JAX package's. "gather" and "pallas" share one
backward, dT = C^T @ dZ with C built in PyTorch.

`set_backward_matmul_dtype` sets the dtype the table backwards of the
gather, K2 and flat paths round their operands to, as JAX's does (it
accumulates in f32 either way). JAX defaults to bf16 for MXU throughput;
the port's default is f32, so the gradients are exact unless a caller
asks for bf16. The products of two bf16 values are exact in f32, so the
port's bf16 option gives JAX's bf16 gradients up to summation order.
"""

from __future__ import annotations

import torch

from escgnn_tpu_torch.ops import segment, zemb_cuda, zemb_gather
from escgnn_tpu_torch.ops.embed import embed_take
from escgnn_tpu_torch.ops.zemb_cuda import count_matrix as _count_matrix

IMPLS = ("countmat", "countmat_pallas", "gather", "pallas")
_IMPL = "countmat"
_BWD_MATMUL_DTYPE = torch.float32


def set_backward_matmul_dtype(dtype):
    """torch.float32 (the default) or torch.bfloat16: the dtype the table
    backwards round their operands to before accumulating in f32."""
    global _BWD_MATMUL_DTYPE
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"backward matmul dtype {dtype}: float32 or "
                         "bfloat16")
    _BWD_MATMUL_DTYPE = dtype


def _bwd_operand(t):
    """`t` in f32 after rounding to the backward matmul dtype."""
    return t.to(_BWD_MATMUL_DTYPE).to(torch.float32)


def set_impl(impl: str):
    global _IMPL
    if impl not in IMPLS:
        raise NotImplementedError(
            f"zemb impl {impl!r}: the ported impls are {IMPLS}")
    _IMPL = impl


def _countmat_reduce(table, enc_idx, enc_cnt):
    return _count_matrix(enc_idx, enc_cnt, table.shape[0]) @ table


class _ZembCountmat(torch.autograd.Function):
    """K2 forward (z and C in one kernel); backward dT = C^T @ dU."""

    @staticmethod
    def forward(ctx, table, enc_idx, enc_cnt):
        z, C = zemb_cuda.zemb_countmat(table, enc_idx, enc_cnt)
        ctx.save_for_backward(C)
        return z

    @staticmethod
    def backward(ctx, dZ):
        (C,) = ctx.saved_tensors
        return _bwd_operand(C).t() @ _bwd_operand(dZ), None, None


class _ZembGather(torch.autograd.Function):
    """Counterpart of `_zemb_core`: forward K3 (impl "pallas") or the
    plain gather-reduce (impl "gather"); backward dT = C^T @ dZ in f32,
    C built from the ids and counts (no gradient for either); the
    operands rounded as `set_backward_matmul_dtype` says."""

    @staticmethod
    def forward(ctx, table, enc_idx, enc_cnt, kernel: bool):
        ctx.save_for_backward(enc_idx, enc_cnt)
        ctx.num_buckets = table.shape[0]
        if kernel:
            return zemb_gather.zemb_gather(table, enc_idx, enc_cnt)
        return zemb_gather.zemb_gather_plain(table, enc_idx, enc_cnt)

    @staticmethod
    def backward(ctx, dZ):
        enc_idx, enc_cnt = ctx.saved_tensors
        C = _count_matrix(enc_idx, enc_cnt, ctx.num_buckets)
        return _bwd_operand(C).t() @ _bwd_operand(dZ), None, None, None


def zemb_weighted_gather(table, enc_idx, enc_cnt):
    """Per-row weighted sum of embedding-table rows -> (R, H) f32.
    Accepts the int16 wire format from the batcher."""
    enc_idx = enc_idx.to(torch.int32).contiguous()
    enc_cnt = enc_cnt.to(torch.float32).contiguous()
    if _IMPL == "countmat":
        return _countmat_reduce(table, enc_idx, enc_cnt)
    if _IMPL == "countmat_pallas":
        return _ZembCountmat.apply(table.contiguous(), enc_idx, enc_cnt)
    return _ZembGather.apply(table.contiguous(), enc_idx, enc_cnt,
                             _IMPL == "pallas")


class _ZembFlat(torch.autograd.Function):
    """Counterpart of `_zemb_flat_core`: z[e] = sum_{k: edge_k = e}
    cnt_k * table[idx_k]; dTable[z] = sum_{k: idx_k = z} cnt_k *
    dZ[edge_k] and dCnt[k] = table[idx_k] . dZ[edge_k]. `edge` and `idx`
    are the entries' sorted views."""

    @staticmethod
    def forward(ctx, table, cnt, edge, idx):
        ctx.save_for_backward(table, cnt)
        ctx.views = (edge, idx)
        rows = (table.index_select(0, idx.ids).to(torch.float32)
                * cnt[:, None])
        return segment.sum_by_view(rows, edge)

    @staticmethod
    def backward(ctx, dZ):
        table, cnt = ctx.saved_tensors
        edge, idx = ctx.views
        dZ_k = dZ.to(torch.float32).index_select(0, edge.ids)
        dT = segment.sum_by_view(
            _bwd_operand(cnt)[:, None] * _bwd_operand(dZ_k), idx)
        dCnt = (table.index_select(0, idx.ids).to(torch.float32)
                * dZ_k).sum(-1)
        return dT.to(table.dtype), dCnt, None, None


def zemb_weighted_flat(table, flat_idx, flat_cnt, flat_edge,
                       num_edges: int):
    """Per-edge weighted sum of table rows from flat COO entries ->
    (num_edges, H) f32. Padding entries have cnt == 0. Accepts the int16
    wire format from the batcher; the counts are differentiable."""
    return _ZembFlat.apply(table, flat_cnt.to(torch.float32),
                           segment.sorted_ids(flat_edge, num_edges),
                           segment.sorted_ids(flat_idx, table.shape[0]))


def zemb_unique_rows(table, batch):
    """Dedup layout only: the (R, H) reduce over the batch's UNIQUE
    histogram rows (no edge expansion). Returns None on other layouts."""
    if batch.enc_edge_row is None:
        return None
    if batch.enc_bucket_ids is not None:
        # bucket compaction: gather the batch's active table rows
        table = embed_take(table, batch.enc_bucket_ids)
        if batch.enc_countmat is not None:
            # host-precomputed C: the whole reduce is one matmul
            return batch.enc_countmat @ table
    return zemb_weighted_gather(table, batch.enc_idx, batch.enc_cnt)


def expand_rows(u, batch):
    """Expand unique-row values (R, H) to edges (E, H) via
    `batch.enc_edge_row`: a `gather_rows` whose backward is K1 over the
    batch's host-sorted view (`enc_edge_perm` / `enc_row_sorted`). The
    flagship's dZ is a column slice of the (E, H + 32) gradient of
    [z_emb | edge-type embedding]: K1 reads it in place."""
    view = segment.SortedIds(batch.enc_edge_row, batch.enc_edge_perm,
                             batch.enc_row_sorted, u.shape[0])
    return segment.gather_rows(u, None, view)


def zemb_from_batch(table, batch):
    """Dispatch on the batch's encoding layout: unique rows + expansion
    on the dedup layout, the COO entries on the flat layout, the per-edge
    reduce on the width layout."""
    u = zemb_unique_rows(table, batch)
    if u is not None:
        return expand_rows(u, batch)
    if batch.enc_flat_idx is not None:
        return zemb_weighted_flat(table, batch.enc_flat_idx,
                                  batch.enc_flat_cnt, batch.enc_flat_edge,
                                  batch.num_edges)
    return zemb_weighted_gather(table, batch.enc_idx, batch.enc_cnt)
