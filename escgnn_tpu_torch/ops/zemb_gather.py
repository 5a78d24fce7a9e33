"""Weighted row-gather z-embedding reduce on the width layout (K3).

Counterpart of `escgnn_tpu/ops/zemb_pallas.py` (`zemb_pallas`): per row
e of the (E, P) encoding,

    z[e] = sum_p cnt[e, p] * table[idx[e, p]]          (E, H) f32

over the full (Z, H) table. `csrc/zemb_gather.cu` gathers the table rows
directly, a warp per edge row, skipping entries with a zero count, in f32
(see the source for the design and its bound). It is forward-only, like
the TPU kernel: the table gradient is the count-matrix product in
`ops/zemb.py`.

`zemb_gather` launches the kernel for CUDA tensors and takes the plain
PyTorch version only for CPU tensors.
"""

from __future__ import annotations

import torch

from escgnn_tpu_torch import _build

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0


def zemb_gather_plain(table, enc_idx, enc_cnt):
    """Gather (E, P, H) rows, weight by the counts and sum over P, in f32
    (ids outside [0, Z) contribute 0)."""
    Z = table.shape[0]
    idx = enc_idx.long()
    ok = (idx >= 0) & (idx < Z)
    cnt = torch.where(ok, enc_cnt.to(torch.float32), 0.0)
    rows = table.to(torch.float32)[torch.where(ok, idx, 0)]
    return torch.einsum("eph,ep->eh", rows, cnt)


def zemb_gather(table, enc_idx, enc_cnt):
    """(Z, H) f32 table, (E, P) int32 ids, (E, P) f32 counts -> (E, H)
    f32."""
    if table.device.type == "cpu":
        return zemb_gather_plain(table, enc_idx, enc_cnt)
    if table.device.type != "cuda":
        raise ValueError(f"zemb_gather: unsupported device {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"table must be (Z, H) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if enc_idx.dtype != torch.int32 or enc_idx.dim() != 2:
        raise ValueError(f"enc_idx must be (E, P) int32, got "
                         f"{tuple(enc_idx.shape)} {enc_idx.dtype}")
    if enc_cnt.dtype != torch.float32 or enc_cnt.shape != enc_idx.shape:
        raise ValueError(f"enc_cnt must be {tuple(enc_idx.shape)} float32, "
                         f"got {tuple(enc_cnt.shape)} {enc_cnt.dtype}")
    for t in (table, enc_idx, enc_cnt):
        if t.device != table.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one device")
    Z, H = table.shape
    E, P = enc_idx.shape
    lib = _build.load("zemb_gather")
    out = torch.empty(E, H, dtype=torch.float32, device=table.device)
    rc = lib.zemb_gather_f32(
        table.data_ptr(), enc_idx.data_ptr(), enc_cnt.data_ptr(),
        E, P, Z, H, out.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    _build.check(rc, "zemb_gather")
    global launches
    launches += 1
    return out
