"""Count-matrix z-embedding reduce over unique rows (K2).

Counterpart of the count-matrix part of `escgnn_tpu/ops/zemb_pallas.py`
(`zemb_countmat_pallas`). For the dedup + bucket-compacted layout,
`csrc/zemb_countmat.cu` writes C[r, z] = sum_p cnt[r, p] * [idx[r, p] == z]
and z = C @ table over the (Zc, H) active table in f32, a warp per row
walking the row's nonzero entries with the table held in each SM's shared
memory (read through L1 when its slice does not fit: `ops/smem_plan.py`;
see `csrc/zemb_rows.cuh` for the design and the source for its bound). C
makes the table backward one matmul, dT = C^T @ dU.

`zemb_countmat` launches the kernel for CUDA tensors and takes the plain
PyTorch version only for CPU tensors. Either way it charges one call to an
active `utils/cost.py` `CostMode` (`countmat_cost`).
Each launch counts under `k2.launches` (`utils/trace.py`).
"""

from __future__ import annotations

import torch

from escgnn_tpu_torch import _build
from escgnn_tpu_torch.ops import smem_plan
from escgnn_tpu_torch.utils import cost, trace


def count_matrix(enc_idx, enc_cnt, num_buckets: int):
    """Dense (R, Z) f32 count matrix from (R, P) ids and counts: one
    scatter-add of the counts along Z, so nothing of size (R, P, Z) is
    built (ids outside [0, Z) contribute 0). The counts are small
    integers, so the f32 sums are exact in any order."""
    idx = enc_idx.long()
    ok = (idx >= 0) & (idx < num_buckets)
    cnt = torch.where(ok, enc_cnt.to(torch.float32), 0.0)
    C = torch.zeros(idx.shape[0], num_buckets, dtype=torch.float32,
                    device=idx.device)
    # an atomic sum may stay: small-integer counts, exact in any order
    return C.scatter_add_(1, torch.where(ok, idx, 0), cnt)


def zemb_countmat_plain(table, enc_idx, enc_cnt):
    C = count_matrix(enc_idx, enc_cnt, table.shape[0])
    return C @ table.to(torch.float32), C


def countmat_cost(table, enc_idx, enc_cnt) -> tuple:
    """(FLOPs, transcendentals, bytes) of one call: the plain version's
    FLOPs (the count matrix's two range compares, their and, two selects
    and the scatter-add, 6 per (row, entry); the (R, Zc) @ (Zc, H)
    product) and the kernel's boundary: the table, ids and counts read, z
    and C written."""
    Z, H = table.shape
    R, P = enc_idx.shape
    flops = 6 * R * P + 2 * R * Z * H
    return flops, 0, (cost.nbytes(table, enc_idx, enc_cnt)
                      + R * H * 4 + R * Z * 4)


def zemb_countmat(table, enc_idx, enc_cnt):
    """(Zc, H) f32 table, (R, P) int32 ids, (R, P) f32 counts ->
    (z (R, H) f32, C (R, Zc) f32)."""
    with cost.kernel_scope():
        out = _zemb_countmat(table, enc_idx, enc_cnt)
    cost.charge("zemb_countmat", *countmat_cost(table, enc_idx, enc_cnt))
    return out


def _zemb_countmat(table, enc_idx, enc_cnt):
    if table.device.type == "cpu":
        return zemb_countmat_plain(table, enc_idx, enc_cnt)
    smem_plan.check_inputs("zemb_countmat", table, enc_idx, enc_cnt)
    Z, H = table.shape
    R, P = enc_idx.shape
    plan = smem_plan.smem_plan(Z, H, smem_plan.sm_count(table.device))
    z = torch.empty(R, H, dtype=torch.float32, device=table.device)
    C = torch.empty(R, Z, dtype=torch.float32, device=table.device)
    rc = _build.load("zemb_countmat").zemb_countmat_f32(
        table.data_ptr(), enc_idx.data_ptr(), enc_cnt.data_ptr(),
        R, P, Z, H, plan.slice_cols, plan.blocks_per_slice, plan.table_bytes,
        z.data_ptr(), C.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    _build.check(rc, "zemb_countmat")
    trace.count("k2.launches")
    return z, C
