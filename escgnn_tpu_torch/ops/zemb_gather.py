"""Weighted row-gather z-embedding reduce on the width layout (K3).

Counterpart of `escgnn_tpu/ops/zemb_pallas.py` (`zemb_pallas`): per row
e of the (E, P) encoding,

    z[e] = sum_p cnt[e, p] * table[idx[e, p]]          (E, H) f32

over the full (Z, H) table. `csrc/zemb_gather.cu` walks the rows with a
warp each, skipping entries with a zero count, in f32 and in ascending p,
with the table held in each SM's shared memory when a 128-column slice of
it fits (Z <= `smem_plan.MAX_RESIDENT_ROWS`) and read through L1 otherwise
(see `csrc/zemb_rows.cuh` for the design and the source for its bound).
It is forward-only, like the TPU kernel: the table gradient is the
count-matrix product in `ops/zemb.py`.

`zemb_gather` launches the kernel for CUDA tensors and takes the plain
PyTorch version only for CPU tensors. Either way it charges one call to an
active `utils/cost.py` `CostMode` (`gather_cost`).
Each launch counts under `k3.launches` (`utils/trace.py`).
"""

from __future__ import annotations

import torch

from escgnn_tpu_torch import _build
from escgnn_tpu_torch.ops import smem_plan
from escgnn_tpu_torch.utils import cost, trace


def zemb_gather_plain(table, enc_idx, enc_cnt):
    """Gather (E, P, H) rows, weight by the counts and sum over P, in f32
    (ids outside [0, Z) contribute 0)."""
    Z = table.shape[0]
    idx = enc_idx.long()
    ok = (idx >= 0) & (idx < Z)
    cnt = torch.where(ok, enc_cnt.to(torch.float32), 0.0)
    rows = table.to(torch.float32)[torch.where(ok, idx, 0)]
    return torch.einsum("eph,ep->eh", rows, cnt)


def gather_cost(table, enc_idx, enc_cnt) -> tuple:
    """(FLOPs, transcendentals, bytes) of one call: the plain version's
    FLOPs (two range compares, their and and two selects, 5 per (edge,
    entry); the weighted sum over P as a batched product, 2 per (edge,
    entry, column)) and the kernel's boundary: the whole table, ids and
    counts read, z written."""
    Z, H = table.shape
    E, P = enc_idx.shape
    flops = 5 * E * P + 2 * E * P * H
    return flops, 0, cost.nbytes(table, enc_idx, enc_cnt) + E * H * 4


def zemb_gather(table, enc_idx, enc_cnt):
    """(Z, H) f32 table, (E, P) int32 ids, (E, P) f32 counts -> (E, H)
    f32."""
    with cost.kernel_scope():
        out = _zemb_gather(table, enc_idx, enc_cnt)
    cost.charge("zemb_gather", *gather_cost(table, enc_idx, enc_cnt))
    return out


def _zemb_gather(table, enc_idx, enc_cnt):
    if table.device.type == "cpu":
        return zemb_gather_plain(table, enc_idx, enc_cnt)
    smem_plan.check_inputs("zemb_gather", table, enc_idx, enc_cnt)
    Z, H = table.shape
    E, P = enc_idx.shape
    plan = smem_plan.smem_plan(Z, H, smem_plan.sm_count(table.device))
    out = torch.empty(E, H, dtype=torch.float32, device=table.device)
    rc = _build.load("zemb_gather").zemb_gather_f32(
        table.data_ptr(), enc_idx.data_ptr(), enc_cnt.data_ptr(),
        E, P, Z, H, plan.slice_cols, plan.blocks_per_slice, plan.table_bytes,
        out.data_ptr(), torch.cuda.current_stream(table.device).cuda_stream,
    )
    _build.check(rc, "zemb_gather")
    trace.count("k3.launches")
    return out
