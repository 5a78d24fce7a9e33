"""Structural-embedding reduce: the z_emb hot op (counterpart of
`escgnn_tpu/ops/zemb.py`, dedup and width layouts).

Per edge e:  z_emb[e] = sum_{k in nnz(e)} count_k * table[bucket_k].

On the dedup layout the reduce runs over the batch's R unique histogram
rows and is expanded to the E edges with one gather (`expand_rows`), whose
backward is the sorted-segment-sum kernel (K1) on CUDA tensors. With
bucket compaction the (Zc, H) active table is gathered first; with the
host count matrix `enc_countmat` the reduce is one matmul C @ table.
On the width layout the reduce runs over the E edge rows directly.

Without a host count matrix, `zemb_weighted_gather` reduces by impl:
  * "countmat" (the default): C built in PyTorch, then C @ table;
  * "countmat_pallas": the fused count-matrix kernel (K2), which also
    returns C;
  * "gather": the plain gather-reduce;
  * "pallas": the row-gather kernel (K3).
The names are the JAX package's. "gather" and "pallas" share one
backward, dT = C^T @ dZ in f32 with C built in PyTorch.
"""

from __future__ import annotations

import torch

from escgnn_tpu_torch.ops import expand_cuda, zemb_cuda, zemb_gather
from escgnn_tpu_torch.ops.embed import embed_take
from escgnn_tpu_torch.ops.zemb_cuda import count_matrix as _count_matrix

IMPLS = ("countmat", "countmat_pallas", "gather", "pallas")
_IMPL = "countmat"


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
        return C.t() @ dZ.to(torch.float32), None, None


class _ZembGather(torch.autograd.Function):
    """Counterpart of `_zemb_core`: forward K3 (impl "pallas") or the
    plain gather-reduce (impl "gather"); backward dT = C^T @ dZ in f32,
    C built from the ids and counts (no gradient for either)."""

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
        return C.t() @ dZ.to(torch.float32), None, None, None


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


class _ExpandRows(torch.autograd.Function):
    """z = u[edge_row]; backward dU = segsum(dZ[perm], rows_sorted) (K1).
    The flagship's dZ is a column slice of the (E, H + 32) gradient of
    [z_emb | edge-type embedding]: K1 reads it in place."""

    @staticmethod
    def forward(ctx, u, edge_row, perm, rows_sorted):
        ctx.save_for_backward(perm, rows_sorted)
        ctx.num_rows = u.shape[0]
        return u.index_select(0, edge_row.long())

    @staticmethod
    def backward(ctx, dZ):
        perm, rows_sorted = ctx.saved_tensors
        dU = expand_cuda.sorted_segment_sum(
            expand_cuda.as_rows(dZ), perm, rows_sorted, ctx.num_rows
        )
        return dU, None, None, None


def expand_rows(u, batch):
    """Expand unique-row values (R, H) to edges (E, H) via
    `batch.enc_edge_row`; the backward is the sorted-segment-sum over the
    batch's sorted-CSR view (K1 on CUDA tensors)."""
    return _ExpandRows.apply(
        u, batch.enc_edge_row, batch.enc_edge_perm, batch.enc_row_sorted
    )


def zemb_from_batch(table, batch):
    """Dispatch on the batch's encoding layout: unique rows + expansion
    on the dedup layout, the per-edge reduce on the width layout."""
    u = zemb_unique_rows(table, batch)
    if u is not None:
        return expand_rows(u, batch)
    return zemb_weighted_gather(table, batch.enc_idx, batch.enc_cnt)
