"""Count-matrix z-embedding reduce over unique rows (K2).

Counterpart of the count-matrix part of `escgnn_tpu/ops/zemb_pallas.py`
(`zemb_countmat_pallas`). For the dedup + bucket-compacted layout,
`csrc/zemb_countmat.cu` builds C[r, z] = sum_p cnt[r, p] * [idx[r, p] == z]
in shared memory and multiplies it with the (Zc, H) active table in f32,
writing both z (R, H) and C (R, Zc) (see the source for the design and
its bound). C makes the table backward one matmul, dT = C^T @ dU.

`zemb_countmat` launches the kernel for CUDA tensors and takes the plain
PyTorch version only for CPU tensors.
"""

from __future__ import annotations

import torch

from escgnn_tpu_torch import _build

# kernel launches since the last reset (chip_smoke.py reads and resets it)
launches = 0

# shared memory one block may use on Hopper (227 KB)
_MAX_SMEM_BYTES = 232448


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
    return C.scatter_add_(1, torch.where(ok, idx, 0), cnt)


def zemb_countmat_plain(table, enc_idx, enc_cnt):
    C = count_matrix(enc_idx, enc_cnt, table.shape[0])
    return C @ table.to(torch.float32), C


def zemb_countmat(table, enc_idx, enc_cnt):
    """(Zc, H) f32 table, (R, P) int32 ids, (R, P) f32 counts ->
    (z (R, H) f32, C (R, Zc) f32)."""
    if table.device.type == "cpu":
        return zemb_countmat_plain(table, enc_idx, enc_cnt)
    if table.device.type != "cuda":
        raise ValueError(f"zemb_countmat: unsupported device {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"table must be (Zc, H) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if enc_idx.dtype != torch.int32 or enc_idx.dim() != 2:
        raise ValueError(f"enc_idx must be (R, P) int32, got "
                         f"{tuple(enc_idx.shape)} {enc_idx.dtype}")
    if enc_cnt.dtype != torch.float32 or enc_cnt.shape != enc_idx.shape:
        raise ValueError(f"enc_cnt must be {tuple(enc_idx.shape)} float32, "
                         f"got {tuple(enc_cnt.shape)} {enc_cnt.dtype}")
    for t in (table, enc_idx, enc_cnt):
        if t.device != table.device or not t.is_contiguous():
            raise ValueError("inputs must be contiguous and on one device")
    Z, H = table.shape
    R, P = enc_idx.shape
    lib = _build.load("zemb_countmat")
    smem = lib.zemb_countmat_smem_bytes(Z)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"zemb_countmat: a {Z}-bucket count tile needs {smem} bytes of "
            f"shared memory, above the {_MAX_SMEM_BYTES} a block may use"
        )
    z = torch.empty(R, H, dtype=torch.float32, device=table.device)
    C = torch.empty(R, Z, dtype=torch.float32, device=table.device)
    rc = lib.zemb_countmat_f32(
        table.data_ptr(), enc_idx.data_ptr(), enc_cnt.data_ptr(),
        R, P, Z, H, z.data_ptr(), C.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    _build.check(rc, "zemb_countmat")
    global launches
    launches += 1
    return z, C
