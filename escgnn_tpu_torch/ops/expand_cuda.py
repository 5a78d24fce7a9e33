"""Sorted segment sum (K1): every float segment sum of the port.

Counterpart of `escgnn_tpu/ops/expand_pallas.py`. It began as the dedup
z path's backward (`z = u[edge_row]`: the (E, H) edge gradients summed
into (R, H) rows, the edges pre-sorted by row on the host) and takes
every float `segment_sum` and row-gather backward over a device-sorted
view (`ops/segment.py`): dense sums with one long padding run, sparse
ones with gaps of thousands of unnamed rows, short ones of a few
thousand positions. `csrc/expand_segsum.cu` does each in one launch: the
R row ends and E sorted positions, merged, are dealt in equal shares of
weight (a position weighs POS_WEIGHT, a row end 1) to the blocks
(`segsum_plan`), each finding its two ends by a search over the ids, so
unnamed rows are zeroed by the whole grid; a share's ends move back to
run starts (SNAP positions back at most in a short share, SNAP // 2 in
a longer one), so a shorter run is never cut between blocks and a short
sum runs in one phase; a longer run cut between blocks is added by the
block that completes its ticket count, in a fixed order. Positions whose
id lies outside [0, R) (masked rows, sorted last) are dropped unread.
Bound: the bytes of the rows it must read and write (a short sum: its
chain of round trips to memory); see the source for the design. It reads
dZ with any row stride, so the step's gradient, a column slice of a
wider tensor, is not copied.

`sorted_segment_sum` launches the kernel for CUDA tensors and takes the
plain PyTorch version only for CPU tensors. Either way it charges one call
to an active `utils/cost.py` `CostMode` (`segsum_cost`).
Each launch counts under `k1.launches` (`utils/trace.py`).
"""

from __future__ import annotations

import dataclasses

import torch

from escgnn_tpu_torch import _build
from escgnn_tpu_torch.ops import smem_plan
from escgnn_tpu_torch.utils import cost, trace

# constants of csrc/expand_segsum.cu
POS_WEIGHT = 2    # merge-path items a sorted position weighs (a row end 1)
MAX_SHARE = 1024  # most merge-path items per block
SNAP = 64         # a short share's end moves back to a run start this far
SHORT_SHARE = 128  # at most; a longer share's end SNAP // 2 at most
SLOT_ALIGN = 4   # a partial slot is H rounded up to 4 floats
MAX_GRID = 2**20  # blocks: a counter holds two block indices of 20 bits


@dataclasses.dataclass(frozen=True)
class SegsumPlan:
    share: int           # merge-path items per block
    grid: int            # blocks
    partial_floats: int  # the head and tail slot of every block
    snap: int            # how far back a block's end moves to a run start


def segsum_plan(E: int, H: int, R: int,
                num_sms: int = smem_plan.H100_SMS) -> SegsumPlan:
    """The launch of K1 for E sorted positions of H columns into R rows:
    the merge path's R row ends and E positions (POS_WEIGHT items each)
    dealt in one share of items per SM, at most MAX_SHARE (the kernel
    splits a share's positions over the groups of threads of its
    block); a short share's ends move further back to run starts (the
    kernel takes `snap` from the share)."""
    if E < 0 or H < 1 or R < 1 or num_sms < 1:
        raise ValueError(f"segsum_plan: bad shape E={E} H={H} R={R} "
                         f"num_sms={num_sms}")
    items = R + POS_WEIGHT * E
    share = min(max(POS_WEIGHT, -(-items // num_sms)), MAX_SHARE)
    grid = max(1, -(-items // share))
    if grid >= MAX_GRID:
        raise ValueError(f"segsum_plan: {items} merge-path items need {grid} "
                         f"blocks, the kernel takes fewer than {MAX_GRID}")
    hp = -(-H // SLOT_ALIGN) * SLOT_ALIGN
    snap = SNAP if share <= SHORT_SHARE else SNAP // 2
    return SegsumPlan(share=share, grid=grid, partial_floats=2 * grid * hp,
                      snap=snap)


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
    """sum_k dZ[perm[k]] into row rows_sorted[k] -> (num_rows, H) f32; a
    position whose row lies outside [0, num_rows) is dropped (sent to a
    trash row past the end)."""
    rows = rows_sorted.long()
    rows = torch.where((rows >= 0) & (rows < num_rows), rows, num_rows)
    out = torch.zeros(
        num_rows + 1, dZ.shape[1], dtype=torch.float32, device=dZ.device
    )
    out.index_add_(0, rows, dZ.index_select(0, perm.long()).float())
    return out[:num_rows]


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


def segsum_cost(dZ, perm, rows_sorted, num_rows: int) -> tuple:
    """(FLOPs, transcendentals, bytes) of one call: the plain version's
    FLOPs (one add per element of dZ, its convert to f32 when dZ is bf16,
    and the four elementwise ops that send a row outside [0, num_rows) to
    the trash row) and the kernel's boundary: the (E, H) elements (not
    the row stride's) of dZ, perm and rows_sorted at the positions whose
    row lies in [0, num_rows), read (the others are dropped unread), and
    the (num_rows, H) f32 output written. Counting those positions reads
    the ids: a host sync, made only under an active CostMode."""
    E, H = dZ.shape
    flops = E * H * (1 if dZ.dtype == torch.float32 else 2) + 4 * E
    kept = int(((rows_sorted >= 0) & (rows_sorted < num_rows)).sum())
    nbytes = kept * (H * dZ.element_size() + perm.element_size()
                     + rows_sorted.element_size())
    return flops, 0, nbytes + num_rows * H * 4


def sorted_segment_sum(dZ, perm, rows_sorted, num_rows: int):
    """Sum rows of `dZ` (E, H) f32/bf16 taken in the order `perm` (E,)
    int32 by the non-decreasing row ids `rows_sorted` (E,) int32 ->
    (num_rows, H) f32. Rows no id names come out 0; positions whose id
    lies outside [0, num_rows) are dropped. On a CUDA device dZ may have
    any row stride >= H (column stride 1)."""
    with cost.kernel_scope():
        out = _sorted_segment_sum(dZ, perm, rows_sorted, num_rows)
        charge = (segsum_cost(dZ, perm, rows_sorted, num_rows)
                  if cost.active() else None)
    if charge is not None:
        cost.charge("sorted_segment_sum", *charge)
    return out


def _sorted_segment_sum(dZ, perm, rows_sorted, num_rows: int):
    if dZ.device.type == "cpu":
        return sorted_segment_sum_plain(dZ, perm, rows_sorted, num_rows)
    check_inputs(dZ, perm, rows_sorted)
    E, H = dZ.shape
    out = torch.empty(num_rows, H, dtype=torch.float32, device=dZ.device)
    if H == 0 or num_rows == 0:
        return out
    plan = segsum_plan(E, H, num_rows, smem_plan.sm_count(dZ.device))
    lib = _build.load("expand_segsum")
    partial = torch.empty(plan.partial_floats, dtype=torch.float32,
                          device=dZ.device)
    fn = (lib.expand_segsum_f32 if dZ.dtype == torch.float32
          else lib.expand_segsum_bf16)
    rc = fn(dZ.data_ptr(), dZ.stride(0), perm.data_ptr(),
            rows_sorted.data_ptr(), E, H, int(num_rows), plan.share,
            out.data_ptr(), partial.data_ptr(),
            _counters(dZ.device, num_rows).data_ptr(),
            torch.cuda.current_stream(dZ.device).cuda_stream)
    _build.check(rc, "expand_segsum")
    trace.count("k1.launches")
    return out
