"""PPGN — Provably Powerful Graph Networks on the dense N x N grid
(counterpart of `escgnn_tpu/models/ppgn.py`).

  * RegularBlock: two 1x1-conv MLPs over the channel dim, a per-channel
    N x N matrix product, and a skip projection of [input | product].
  * diag/offdiag pooling at graph or node level; at node level the
    one-pass kernel K4 (`ops/ppgn_pool.py`) under `pool_impl="pallas"`.
  * PPGN_eff: the ESC per-edge structural embedding (through the
    z_embedding MLP) is scattered into the dense edge channels beside
    the adjacency, then the regular blocks and an FC head.

Channels-last (G, N, N, C) grids; every block re-masks padded rows and
columns so padding stays exactly zero. The dense grid is built from the
sparse batch with one scatter, so PPGN takes the same GraphBatch as the
other models.

JAX drops out-of-range scatter updates and clamps out-of-range gathers,
and the batcher relies on both: padding nodes carry `node_local =
max_nodes_per_graph`, one past the dense N of a `from_graphs` batch, and
padding edges park on such a node. PyTorch raises on such indices, so
the scatters here send them to one extra trash slot that is cut off
afterwards, and the final gather clamps `node_local` as JAX does.

Mixed precision under `compute_dtype="bfloat16"` follows JAX's
promotions, written out: a bf16 activation times an f32 weight computes
in f32 (`TorchDense`), and the block casts back to bf16 after each ReLU,
after the per-channel product and after the skip projection.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.models.layers import MaskedBatchNorm, TorchDense
from escgnn_tpu_torch.ops.ppgn_pool import diag_row_col_pool
from escgnn_tpu_torch.ops.zemb import zemb_from_batch


def _pair_mask(node_mask_dense):  # (G, N) -> (G, N, N, 1) f32
    m = node_mask_dense.to(torch.float32)
    return (m[:, :, None] * m[:, None, :])[..., None]


class MlpBlock(nn.Module):
    """depth x [1x1 conv + ReLU] over the channel dimension; `dtype`
    (None: keep the f32 of the convs) is the type between convs."""

    def __init__(self, in_features: int, features: int, depth: int = 2,
                 dtype: Optional[torch.dtype] = None, *,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        for i in range(depth):
            d = in_features if i == 0 else features
            self.add_module(f"conv{i}",
                            TorchDense(d, features, generator=generator))

    def forward(self, x):  # (G, N, N, C)
        for i in range(self.depth):
            x = F.relu(getattr(self, f"conv{i}")(x))
            if self.dtype is not None:
                x = x.to(self.dtype)
        return x


class RegularBlock(nn.Module):
    def __init__(self, in_features: int, features: int, depth: int = 2,
                 dtype: Optional[torch.dtype] = None, *,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.mlp1 = MlpBlock(in_features, features, depth, dtype,
                             generator=generator)
        self.mlp2 = MlpBlock(in_features, features, depth, dtype,
                             generator=generator)
        self.skip = TorchDense(in_features + features, features,
                               generator=generator)

    def forward(self, x, pmask):  # x (G, N, N, C), pmask (G, N, N, 1)
        cdt = self.dtype or x.dtype
        pm = pmask.to(cdt)
        m1 = self.mlp1(x) * pm
        m2 = self.mlp2(x) * pm
        # per-channel N x N product: mult[g,n,k,c] = sum_m m1[g,n,m,c]
        # m2[g,m,k,c], as a batched matmul over (g, c). In bf16 it sums in
        # f32 and rounds once, as JAX's einsum with an f32 accumulator
        # followed by a cast to bf16.
        mult = torch.matmul(m1.permute(0, 3, 1, 2), m2.permute(0, 3, 1, 2))
        mult = mult.permute(0, 2, 3, 1).to(cdt)
        out = self.skip(torch.cat([x.to(cdt), mult], dim=-1))
        return out.to(cdt) * pm


def diag_offdiag_meanpool(x, node_mask_dense, level="graph"):
    """(G, N, N, C) -> graph: (G, 2C); node: (G, N, 2C). Output f32,
    sums in f32 from x's dtype."""
    m = node_mask_dense.to(torch.float32)
    n_real = m.sum(1).clamp_min(1.0)  # (G,)
    diag = torch.diagonal(x, dim1=1, dim2=2).permute(0, 2, 1).float()
    if level == "graph":
        mean_diag = diag.sum(1) / n_real[:, None]
        total = x.sum(dim=(1, 2), dtype=torch.float32)
        denom = (n_real * n_real - n_real).clamp_min(1.0)
        mean_offdiag = (total - mean_diag * n_real[:, None]) / denom[:, None]
        return torch.cat([mean_diag, mean_offdiag], dim=-1)
    # node level: row-sum + col-sum - 2*diag (unnormalized, as the
    # reference)
    row = x.sum(dim=2, dtype=torch.float32)
    col = x.sum(dim=1, dtype=torch.float32)
    return torch.cat([diag, row + col - 2 * diag], dim=-1)


@dataclasses.dataclass(frozen=True)
class PPGNConfig:
    emb_dim: int = 64
    num_rb_layers: int = 4
    depth_of_mlp: int = 2
    out_dim: int = 1
    node_level: bool = False  # y_ndim == 2 in the reference
    use_esc: bool = True  # PPGN_eff: inject ESC edge encoding channels
    z_dim: int = 1800
    max_nodes: int = 32  # dense N (static)
    # float32 | bfloat16 regular-block stacks (f32 params, f32 product
    # accumulation, f32 head)
    compute_dtype: str = "float32"
    # node-level pooling: "xla" (plain PyTorch, the JAX package's name
    # for its XLA-fused version) or "pallas" (the K4 kernel)
    pool_impl: str = "xla"


class PPGN(nn.Module):
    """The parameters are drawn on the CPU from `generator` (seed 0 when
    None) and then moved to `device`. Submodule names follow the flax
    tree, so `weights.py` carries a flax state across."""

    def __init__(self, cfg: PPGNConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(cfg.compute_dtype)
        if cfg.pool_impl not in ("xla", "pallas"):
            raise ValueError(f"pool_impl {cfg.pool_impl!r}")
        device = resolve_device(device)
        g = torch.Generator().manual_seed(0) if generator is None else generator
        self.cfg = cfg
        E = cfg.emb_dim
        c_edge = 1
        if cfg.use_esc:
            self.z_initial = nn.Parameter(
                torch.empty(cfg.z_dim, E).normal_(0.0, 1.0, generator=g))
            for i in range(2):
                self.add_module(f"z_embedding_{i}",
                                TorchDense(E, E, generator=g))
                self.add_module(f"z_bn_{i}", MaskedBatchNorm(E))
            c_edge += E
        block_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                       else None)
        d = c_edge + 1  # edge channels + the zero diagonal channel
        for i in range(cfg.num_rb_layers):
            self.add_module(f"rb{i}", RegularBlock(
                d, E, cfg.depth_of_mlp, block_dtype, generator=g))
            d = E
        self.fc0 = TorchDense(2 * E, E, generator=g)
        self.fc1 = TorchDense(E, cfg.out_dim, generator=g)
        self.to(device)

    def _edge_features(self, batch: GraphBatch):
        """(E, 1 + emb) [edge mask | z_embedding(ESC enc)], or the edge
        mask alone without the encoding."""
        em = batch.edge_mask.to(torch.float32)[:, None]
        if not self.cfg.use_esc:
            return em
        if batch.enc_idx is None and batch.enc_flat_idx is None:
            raise ValueError("PPGN with use_esc needs a batch with the ESC "
                             "encoding")
        z = zemb_from_batch(self.z_initial, batch)
        # Linear -> BN -> ReLU, twice; plain BN over the real edges
        for i in range(2):
            z = getattr(self, f"z_embedding_{i}")(z)
            z = F.relu(getattr(self, f"z_bn_{i}")(z, batch.edge_mask))
        return torch.cat([em, z * em], dim=-1)

    def forward(self, batch: GraphBatch):
        cfg = self.cfg
        G, N = batch.num_graphs, cfg.max_nodes
        node_graph = batch.node_graph.long()
        node_local = batch.node_local.long()

        # dense node mask: slots outside the (G, N) grid go to the trash
        # slot G*N (JAX drops those updates)
        slot = torch.where(node_local < N, node_graph * N + node_local, G * N)
        nm = torch.zeros(G * N + 1, dtype=torch.bool, device=slot.device)
        nm = nm.index_put((slot,), batch.node_mask)[:-1].view(G, N)

        # edge channels scattered into the dense grid, with the same trash
        # slot. index_add accumulates with atomics on the card, in no fixed
        # order; the sums are exact all the same, since a (g, src, dst)
        # cell gets at most one real edge (the counting graphs have no
        # multi-edges) and padding edges add zeros
        src_l = node_local[batch.senders.long()]
        dst_l = node_local[batch.receivers.long()]
        e_g = node_graph[batch.receivers.long()]
        cell = torch.where((src_l < N) & (dst_l < N),
                           (e_g * N + src_l) * N + dst_l, G * N * N)
        edge_feat = self._edge_features(batch)
        C_e = edge_feat.shape[-1]
        dense = edge_feat.new_zeros(G * N * N + 1, C_e).index_add(
            0, cell, edge_feat)[:-1].view(G, N, N, C_e)

        # diagonal node channel (zeros for the counting tasks, as the
        # reference)
        x = torch.cat([dense, dense.new_zeros(G, N, N, 1)], dim=-1)
        cdt = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
               else torch.float32)
        pmask = _pair_mask(nm)
        x = (x * pmask).to(cdt)
        for i in range(cfg.num_rb_layers):
            x = getattr(self, f"rb{i}")(x, pmask)

        if cfg.node_level and cfg.pool_impl == "pallas":
            pooled = diag_row_col_pool(x.contiguous())
        else:
            pooled = diag_offdiag_meanpool(
                x, nm, level="node" if cfg.node_level else "graph")

        h = F.relu(self.fc0(pooled))
        h = self.fc1(h)
        if cfg.node_level:
            # back to the sparse node list (N_batch, out); an index past
            # the grid is clamped, as JAX's gather clamps it
            return h[node_graph.clamp(0, G - 1), node_local.clamp(0, N - 1)]
        return h
