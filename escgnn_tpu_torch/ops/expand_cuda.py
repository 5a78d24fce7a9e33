"""Sorted segment sum for the dedup expansion backward (K1).

Counterpart of `escgnn_tpu/ops/expand_pallas.py`. The dedup z path
expands unique-row values to edges with one gather (`z = u[edge_row]`);
its backward sums the (E, H) edge gradients into (R, H) rows. With the
edges pre-sorted by row on the host (`enc_edge_perm` /
`enc_row_sorted`), `csrc/expand_segsum.cu` does that as a deterministic
segmented reduce: fixed-size chunks of the sorted edges first, then the
rows whose run spans chunks (located through CSR offsets), the perm
gather fused into the load, no atomics (see the source for the design
and its bound).

`sorted_segment_sum` launches the kernel for CUDA tensors and takes the
plain PyTorch version only for CPU tensors.
"""

from __future__ import annotations

import torch

from escgnn_tpu_torch import _build

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


def sorted_segment_sum_plain(dZ, perm, rows_sorted, num_rows: int):
    """sum_k dZ[perm[k]] into row rows_sorted[k] -> (num_rows, H) f32."""
    out = torch.zeros(
        num_rows, dZ.shape[1], dtype=torch.float32, device=dZ.device
    )
    return out.index_add_(
        0, rows_sorted.long(), dZ.index_select(0, perm.long()).float()
    )


def sorted_segment_sum(dZ, perm, rows_sorted, num_rows: int):
    """Sum rows of `dZ` (E, H) f32/bf16 taken in the order `perm` (E,)
    int32 by the non-decreasing row ids `rows_sorted` (E,) int32 ->
    (num_rows, H) f32. Rows no id names come out 0."""
    if dZ.device.type == "cpu":
        return sorted_segment_sum_plain(dZ, perm, rows_sorted, num_rows)
    if dZ.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum: unsupported device {dZ.device}")
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
    for t in (dZ, perm, rows_sorted):
        if t.device != dZ.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one device")
    lib = _build.load("expand_segsum")
    out = torch.empty(num_rows, H, dtype=torch.float32, device=dZ.device)
    # scratch: per-chunk partial sums and the CSR row offsets
    partial = torch.empty(lib.expand_segsum_partial_floats(E, H),
                          dtype=torch.float32, device=dZ.device)
    offsets = torch.empty(num_rows + 1, dtype=torch.int32, device=dZ.device)
    fn = (lib.expand_segsum_f32 if dZ.dtype == torch.float32
          else lib.expand_segsum_bf16)
    rc = fn(dZ.data_ptr(), perm.data_ptr(), rows_sorted.data_ptr(),
            E, H, int(num_rows), out.data_ptr(), partial.data_ptr(),
            offsets.data_ptr(),
            torch.cuda.current_stream(dZ.device).cuda_stream)
    _build.check(rc, "expand_segsum")
    global launches
    launches += 1
    return out
