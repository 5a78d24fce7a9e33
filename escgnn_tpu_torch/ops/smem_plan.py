"""Launch plan of the z-reduce kernels K2 and K3 (`csrc/zemb_rows.cuh`).

Both kernels run a persistent grid of one 1024-thread block per SM, a warp
per row. The output columns are cut into slices of `slice_cols` (128 or
256) columns and the SMs are split evenly over the slices. Each block
keeps 8 KB of shared memory for its row counter and its warps' packed
(id, count) pairs and, where it fits beside them, its (Z, slice_cols) f32
column slice of the table (`resident`); otherwise the table rows are read
through L1.

This module is the one place that plans it: the wrappers pass the plan to
the launchers, which refuse a plan that does not match the shapes.
"""

from __future__ import annotations

import dataclasses

import torch

# shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
# the row counter (a 128-byte line) and the packed pairs (32 warps x 32 x
# 8 bytes)
THREADS = 1024
FIXED_BYTES = 128 + THREADS * 8
SLICE_COLS = (256, 128)
# the most table rows a 128-column f32 slice can hold in shared memory
MAX_RESIDENT_ROWS = (MAX_SMEM_BYTES - FIXED_BYTES) // (128 * 4)
# the kernels keep a table row's offset (id * H) in 32 bits
MAX_TABLE_FLOATS = 2**31 - 1
# one H100 SXM; the wrappers pass the card's own count
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class SmemPlan:
    slice_cols: int
    slices: int
    blocks_per_slice: int
    table_bytes: int  # the resident slice; 0 when rows are read through L1

    @property
    def resident(self) -> bool:
        return self.table_bytes > 0

    @property
    def smem_bytes(self) -> int:
        return FIXED_BYTES + self.table_bytes

    @property
    def grid(self) -> int:
        return self.slices * self.blocks_per_slice


def smem_plan(Z: int, H: int, num_sms: int = H100_SMS) -> SmemPlan:
    """The plan for a (Z, H) f32 table: one 256-column slice per 256
    columns for H > 128, one 128-column slice otherwise; the slice is
    resident in shared memory where it fits (Z <= MAX_RESIDENT_ROWS at
    128 columns, half that at 256), and its rows are read through L1
    where it does not."""
    if Z < 1 or H < 1 or num_sms < 1:
        raise ValueError(f"smem_plan: bad shape Z={Z} H={H} num_sms={num_sms}")
    w = 256 if H > 128 else 128
    slices = -(-H // w)
    resident = FIXED_BYTES + Z * w * 4 <= MAX_SMEM_BYTES
    return SmemPlan(slice_cols=w, slices=slices,
                    blocks_per_slice=max(1, num_sms // slices),
                    table_bytes=Z * w * 4 if resident else 0)


def sm_count(device) -> int:
    """The number of SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_inputs(name: str, table, enc_idx, enc_cnt) -> None:
    """Raise on inputs the kernels do not take: a (Z, H) f32 table of at
    most MAX_TABLE_FLOATS, (R, P) int32 ids and (R, P) f32 counts,
    contiguous, on one CUDA device."""
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"{name}: table must be (Z, H) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if enc_idx.dtype != torch.int32 or enc_idx.dim() != 2:
        raise ValueError(f"{name}: enc_idx must be (R, P) int32, got "
                         f"{tuple(enc_idx.shape)} {enc_idx.dtype}")
    if enc_cnt.dtype != torch.float32 or enc_cnt.shape != enc_idx.shape:
        raise ValueError(f"{name}: enc_cnt must be {tuple(enc_idx.shape)} "
                         f"float32, got {tuple(enc_cnt.shape)} {enc_cnt.dtype}")
    if table.numel() > MAX_TABLE_FLOATS:
        raise ValueError(f"{name}: a {tuple(table.shape)} table is above the "
                         f"{MAX_TABLE_FLOATS} floats the kernels' 32-bit row "
                         f"offsets reach")
    for t in (table, enc_idx, enc_cnt):
        if t.device != table.device or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous and on one "
                             f"device")
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
