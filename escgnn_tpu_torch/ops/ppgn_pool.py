"""Diagonal / row / column pooling of the dense PPGN grid (K4).

Counterpart of `escgnn_tpu/ops/ppgn_pool.py`: the node-level body of
`diag_offdiag_meanpool` in one pass,

    (G, N, N, C) -> (G, N, 2C) f32 = [diag | row + col - 2 * diag]

reading x in its dtype (f32 or bf16) and summing in f32.
`csrc/ppgn_pool.cu` gives each (graph, node, channel) output a thread
that walks its row and column (see the source for the design and its
bound). As on the TPU the kernel is forward-only: the backward is the
plain broadcast dx[n, k] = g_off[n] + g_off[k] + (g_diag - 2 g_off)[n]
on the diagonal, in x's dtype.

`diag_row_col_pool` launches the kernel for CUDA tensors and takes the
plain PyTorch version only for CPU tensors. Either way its forward charges
one call to an active `utils/cost.py` `CostMode` (`pool_cost`); the
backward is counted op by op.
Each launch counts under `k4.launches` (`utils/trace.py`).
"""

from __future__ import annotations

import torch

from escgnn_tpu_torch import _build
from escgnn_tpu_torch.utils import cost, trace


def diag_row_col_pool_plain(x):
    """Counterpart of `diag_row_col_pool_xla`: the same math in PyTorch."""
    diag = torch.diagonal(x, dim1=1, dim2=2).permute(0, 2, 1).float()
    row = x.sum(dim=2, dtype=torch.float32)
    col = x.sum(dim=1, dtype=torch.float32)
    return torch.cat([diag, row + col - 2.0 * diag], dim=-1)


def pool_cost(x) -> tuple:
    """(FLOPs, transcendentals, bytes) of one forward: the plain version's
    FLOPs (the row and column sums, N - 1 adds per output each; row + col
    - 2 diag, 3 per output; from bf16, the converts of the sums' inputs
    and of the diagonal) and the kernel's boundary: x read, the (G, N,
    2C) f32 output written."""
    G, N, _, C = x.shape
    grid, out = G * N * N * C, G * N * C
    flops = 2 * (grid - out) + 3 * out
    if x.dtype != torch.float32:
        flops += 2 * grid + out
    return flops, 0, cost.nbytes(x) + 2 * out * 4


def _pool_forward(x):
    with cost.kernel_scope():
        out = _pool_kernel(x)
    cost.charge("diag_row_col_pool", *pool_cost(x))
    return out


def _pool_kernel(x):
    if x.device.type == "cpu":
        return diag_row_col_pool_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"diag_row_col_pool: unsupported device {x.device}")
    if x.dim() != 4 or x.shape[1] != x.shape[2]:
        raise ValueError(f"x must be (G, N, N, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    G, N, _, C = x.shape
    lib = _build.load("ppgn_pool")
    out = torch.empty(G, N, 2 * C, dtype=torch.float32, device=x.device)
    fn = lib.ppgn_pool_f32 if x.dtype == torch.float32 else lib.ppgn_pool_bf16
    rc = fn(x.data_ptr(), G, N, C, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "ppgn_pool")
    trace.count("k4.launches")
    return out


class _DiagRowColPool(torch.autograd.Function):
    """K4 forward; backward `_pool_bwd` of the JAX package, in x's dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.x_dtype = x.dtype
        return _pool_forward(x)

    @staticmethod
    def backward(ctx, g):
        N = g.shape[1]
        C = g.shape[-1] // 2
        g_diag, g_off = g[..., :C], g[..., C:]
        dx = g_off[:, :, None, :] + g_off[:, None, :, :]
        eye = torch.eye(N, dtype=g.dtype, device=g.device)[None, :, :, None]
        dx = dx + (g_diag - 2.0 * g_off)[:, :, None, :] * eye
        return dx.to(ctx.x_dtype)


def diag_row_col_pool(x):
    """(G, N, N, C) f32/bf16 -> (G, N, 2C) f32: [diag | row + col - 2
    diag], differentiable."""
    return _DiagRowColPool.apply(x)
