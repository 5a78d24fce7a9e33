"""Sorted segment sum for the dedup expansion backward (K1).

Counterpart of `escgnn_tpu/ops/expand_pallas.py`. The dedup z path
expands unique-row values to edges with one gather (`z = u[edge_row]`);
its backward sums the (E, H) edge gradients into (R, H) rows. With the
edges pre-sorted by row on the host (`enc_edge_perm` /
`enc_row_sorted`), `csrc/expand_segsum.cu` does that in one launch:
each block sums the runs of its span of the sorted edges, the perm gather
fused into 16-byte loads, and the block that completes a cut run's ticket
count adds the run's partial sums in a fixed order (see the source for
the design and its bound). It reads dZ with any row stride, so the
step's gradient, a column slice of a wider tensor, is not copied.

`sorted_segment_sum` launches the kernel for CUDA tensors and takes the
plain PyTorch version only for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from escgnn_tpu_torch import _build
from escgnn_tpu_torch.ops import smem_plan

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0

# constants of csrc/expand_segsum.cu
MAX_SPAN = 256   # most sorted positions one block takes
SLOT_ALIGN = 4   # a partial slot is H rounded up to 4 floats
MAX_GRID = 2**20  # blocks: a counter holds two block indices of 20 bits


@dataclasses.dataclass(frozen=True)
class SegsumPlan:
    span: int            # sorted positions per block
    grid: int            # blocks
    partial_floats: int  # the head and tail slot of every block


def segsum_plan(E: int, H: int, num_sms: int = smem_plan.H100_SMS
                ) -> SegsumPlan:
    """The launch of K1 for E sorted edges of H columns: one span of E per
    SM, at most MAX_SPAN (the kernel splits a span over the groups of
    threads of its block)."""
    if E < 0 or H < 1 or num_sms < 1:
        raise ValueError(f"segsum_plan: bad shape E={E} H={H} "
                         f"num_sms={num_sms}")
    span = min(max(1, -(-E // num_sms)), MAX_SPAN)
    grid = max(1, -(-E // span))
    if grid >= MAX_GRID:
        raise ValueError(f"segsum_plan: E={E} needs {grid} blocks, the kernel "
                         f"takes fewer than {MAX_GRID}")
    hp = -(-H // SLOT_ALIGN) * SLOT_ALIGN
    return SegsumPlan(span=span, grid=grid, partial_floats=2 * grid * hp)


# per (device, size): the kernel's 64-bit per-row ticket counters, zeroed
# once; every launch leaves them at 0, so no call needs a memset
_counter_bufs: dict = {}


def _counters(device, num_rows: int):
    size = 1 << max(num_rows - 1, 0).bit_length()
    key = (device, size)
    buf = _counter_bufs.get(key)
    if buf is None:
        buf = _counter_bufs[key] = torch.zeros(size, dtype=torch.int64,
                                               device=device)
    return buf


def sorted_segment_sum_plain(dZ, perm, rows_sorted, num_rows: int):
    """sum_k dZ[perm[k]] into row rows_sorted[k] -> (num_rows, H) f32."""
    out = torch.zeros(
        num_rows, dZ.shape[1], dtype=torch.float32, device=dZ.device
    )
    return out.index_add_(
        0, rows_sorted.long(), dZ.index_select(0, perm.long()).float()
    )


def check_inputs(dZ, perm, rows_sorted) -> None:
    """Raise on inputs the kernel does not take: dZ (E, H) f32/bf16 with
    column stride 1 and row stride >= H, perm and rows_sorted (E,) int32
    contiguous, all on one CUDA device."""
    if dZ.dtype not in (torch.float32, torch.bfloat16) or dZ.dim() != 2:
        raise ValueError(
            f"dZ must be (E, H) float32/bfloat16, got {tuple(dZ.shape)} "
            f"{dZ.dtype}"
        )
    E, H = dZ.shape
    for name, t in (("perm", perm), ("rows_sorted", rows_sorted)):
        if t.dtype != torch.int32 or tuple(t.shape) != (E,):
            raise ValueError(f"{name} must be ({E},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if dZ.stride(1) != 1:
        raise ValueError(f"dZ must have column stride 1, got {dZ.stride()}")
    if dZ.stride(0) < H:
        raise ValueError(f"dZ must have a row stride >= H = {H}, got "
                         f"{dZ.stride()}")
    for t in (dZ, perm, rows_sorted):
        if t.device != dZ.device:
            raise ValueError("inputs must be on one device")
    if not (perm.is_contiguous() and rows_sorted.is_contiguous()):
        raise ValueError("perm and rows_sorted must be contiguous")
    if dZ.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum: unsupported device {dZ.device}")


def as_rows(dZ):
    """dZ itself where the kernel reads it in place (column stride 1, row
    stride >= H, as the step's column slice), else a contiguous copy."""
    if dZ.stride(1) == 1 and dZ.stride(0) >= dZ.shape[1]:
        return dZ
    return dZ.contiguous()


def sorted_segment_sum(dZ, perm, rows_sorted, num_rows: int):
    """Sum rows of `dZ` (E, H) f32/bf16 taken in the order `perm` (E,)
    int32 by the non-decreasing row ids `rows_sorted` (E,) int32 ->
    (num_rows, H) f32. Rows no id names come out 0. On a CUDA device dZ
    may have any row stride >= H (column stride 1)."""
    if dZ.device.type == "cpu":
        return sorted_segment_sum_plain(dZ, perm, rows_sorted, num_rows)
    check_inputs(dZ, perm, rows_sorted)
    E, H = dZ.shape
    out = torch.empty(num_rows, H, dtype=torch.float32, device=dZ.device)
    if H == 0 or num_rows == 0:
        return out
    plan = segsum_plan(E, H, smem_plan.sm_count(dZ.device))
    lib = _build.load("expand_segsum")
    partial = torch.empty(plan.partial_floats, dtype=torch.float32,
                          device=dZ.device)
    fn = (lib.expand_segsum_f32 if dZ.dtype == torch.float32
          else lib.expand_segsum_bf16)
    rc = fn(dZ.data_ptr(), dZ.stride(0), perm.data_ptr(),
            rows_sorted.data_ptr(), E, H, int(num_rows), plan.span,
            out.data_ptr(), partial.data_ptr(),
            _counters(dZ.device, num_rows).data_ptr(),
            torch.cuda.current_stream(dZ.device).cuda_stream)
    _build.check(rc, "expand_segsum")
    global launches
    launches += 1
    return out
