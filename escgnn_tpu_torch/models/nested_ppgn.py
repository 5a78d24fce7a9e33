"""NestedPPGN: the two-level Provably Powerful Graph Network (counterpart
of `escgnn_tpu/models/nested_ppgn.py`).

A dense PPGN runs inside every node-rooted subgraph copy; each copy is
pooled with max + mean + min diagonal/off-diagonal pooling into an
embedding; a second dense PPGN runs at graph level with the copy
embeddings on the diagonal and the original graph's adjacency
(`extras['orig_adj']`) as the edge channel.

Both levels are channels-last dense tensors built from the copies'
`GraphBatch` with masked scatters: (S, M, M, C) per copy, M the static
largest copy, and (G, K, K, C) per graph, K the batch's largest
subgraph count (the `orig_adj` width). The regular blocks and the pair
mask are the flat PPGN's (`models/ppgn.py`).

JAX drops out-of-range scatter updates and clamps out-of-range gathers;
the masked padding slots rely on both. PyTorch raises on such indices,
so every scatter here sends them to one extra trash slot that is cut off
afterwards, and the node-level gather clamps, as the flat PPGN does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.models.layers import TorchDense, TorchEmbed
from escgnn_tpu_torch.models.ppgn import RegularBlock, _pair_mask
from escgnn_tpu_torch.ops.segment import masked_ids, segment_min

NEG = -1e9


def diag_offdiag_pool_masked(x, node_mask_dense, op: str):
    """(B, N, N, C) -> (B, 2C) f32: [diagonal pool | off-diagonal pool]
    over the real rows and pairs, `op` max, mean or min; empty sets give
    0. Sums and extremes are taken in f32 from x's dtype."""
    m = node_mask_dense  # (B, N) bool
    diag = torch.diagonal(x, dim1=1, dim2=2).permute(0, 2, 1)  # (B, N, C)
    pair = m[:, :, None] & m[:, None, :]
    eye = torch.eye(m.shape[1], dtype=torch.bool, device=m.device)
    off = pair & ~eye[None]
    if op == "mean":
        n_real = m.sum(1, dtype=torch.float32).clamp_min(1.0)
        d = torch.where(m[..., None], diag.float(), 0.0).sum(1) \
            / n_real[:, None]
        denom = (n_real * n_real - n_real).clamp_min(1.0)
        o = torch.where(off[..., None], x.float(), 0.0).sum((1, 2)) \
            / denom[:, None]
        return torch.cat([d, o], dim=-1)
    if op not in ("max", "min"):
        raise ValueError(op)
    sign = 1.0 if op == "max" else -1.0
    xs = (sign * x).float()
    ds = (sign * diag).float()
    d = torch.where(m[..., None], ds, NEG).amax(1)
    o = torch.where(off[..., None], xs, NEG).amax((1, 2))
    d = torch.where(d <= NEG, 0.0, d)
    o = torch.where(o <= NEG, 0.0, o)
    return sign * torch.cat([d, o], dim=-1)


def _local_index(global_idx, segment, num_segments: int, mask, budget: int):
    """Index of each element within its (contiguous) segment, clipped to
    [0, budget); masked entries get `budget`, one past the dense range,
    so the dense scatters send them to the trash slot."""
    ids = masked_ids(segment, mask)
    first = segment_min(global_idx.float(), ids, num_segments, mask=mask)
    loc = global_idx - first[ids.long()].to(global_idx.dtype)
    return torch.where(mask, loc.clamp_max(budget - 1),
                       torch.full_like(loc, budget))


def _dense_index(rows, cols, num_rows: int, budget: int):
    """Flat index rows * budget + cols into (num_rows * budget + 1) slots;
    a row or column out of range goes to the trash slot at the end."""
    ok = (rows < num_rows) & (cols < budget)
    return torch.where(ok, rows * budget + cols, num_rows * budget)


@dataclasses.dataclass(frozen=True)
class NestedPPGNConfig:
    emb_dim: int = 64
    num_rb_layers: int = 2
    depth_of_mlp: int = 2
    num_tasks: int = 2
    use_z: bool = True
    use_rd: bool = False
    graph_pred: bool = True  # False: per-subgraph (node-level) outputs
    max_nodes_per_subgraph: int = 16  # M (static dense budget)
    classify: bool = True  # log_softmax head
    # float32 | bfloat16 regular-block stacks (f32 params, f32 product
    # accumulation, f32 pooling and head)
    compute_dtype: str = "float32"


class NestedPPGN(nn.Module):
    """`in_dim`: the columns of `batch.x`; `edge_dim`: the columns of
    `batch.edge_attr` (0 without one); `extras['rd']` has one column (the
    node transform's distance to the root). Weights are drawn on the CPU
    from `generator` (seed 0 when None) and moved to `device`; submodule
    names follow the flax tree."""

    def __init__(self, cfg: NestedPPGNConfig, in_dim: int, edge_dim: int,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(cfg.compute_dtype)
        device = resolve_device(device)
        g = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        self.cfg = cfg
        E = cfg.emb_dim
        c_node = in_dim
        if cfg.use_z:
            self.z_embedding = TorchEmbed(1000, 8, generator=g)
        if cfg.use_rd:
            self.rd_projection = TorchDense(1, 8, generator=g)
        if cfg.use_z or cfg.use_rd:
            c_node += 8
        block_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                       else None)
        d = 1 + edge_dim + c_node  # edge mask | edge attrs | node diagonal
        for i in range(cfg.num_rb_layers):
            self.add_module(f"rb{i}", RegularBlock(
                d, E, cfg.depth_of_mlp, block_dtype, generator=g))
            d = E
        self.fc_g0 = TorchDense(2 * E, E, generator=g)
        self.fc_g1 = TorchDense(E, E, generator=g)
        d = 1 + E  # orig_adj | copy embeddings on the diagonal
        for i in range(cfg.num_rb_layers):
            self.add_module(f"rb_g{i}", RegularBlock(
                d, E, cfg.depth_of_mlp, block_dtype, generator=g))
            d = E
        self.fc0 = TorchDense(2 * E, E, generator=g)
        self.fc1 = TorchDense(E, cfg.num_tasks, generator=g)
        self.to(device)

    def forward(self, batch: GraphBatch):
        cfg = self.cfg
        M = cfg.max_nodes_per_subgraph
        S = batch.segment_mask.shape[0]
        G = batch.num_graphs
        node_mask = batch.node_mask
        dev = node_mask.device

        # node embedding: [z_emb (+ rd) | x]
        x = batch.x.float()
        if x.dim() == 1:
            x = x[:, None]
        if cfg.use_z or cfg.use_rd:
            z_emb = 0.0
            if cfg.use_z:
                z_emb = self.z_embedding(batch.extras["z"]).sum(1)
            if cfg.use_rd:
                z_emb = z_emb + self.rd_projection(batch.extras["rd"].float())
            x = torch.cat([z_emb, x], dim=-1)

        # dense per-copy grid (S, M, M, C)
        idx = torch.arange(batch.num_nodes, device=dev)
        seg = batch.node_segment.long()
        nloc = _local_index(idx, seg, S, node_mask, M)
        node_slot = _dense_index(seg, nloc, S, M)
        nm = torch.zeros(S * M + 1, dtype=torch.bool, device=dev).index_put(
            (node_slot,), node_mask)[:-1].view(S, M)
        snd, rcv = batch.senders.long(), batch.receivers.long()
        e_seg = seg[rcv]
        src_l, dst_l = nloc[snd], nloc[rcv]
        cell = _dense_index(_dense_index(e_seg, src_l, S, M), dst_l, S * M, M)
        em = batch.edge_mask.float()[:, None]
        ea = batch.edge_attr
        if ea is None:
            edge_feat = em
        else:
            edge_feat = torch.cat(
                [em, ea.float().reshape(ea.shape[0], -1)], dim=-1) * em
        C_e = edge_feat.shape[-1]
        # index_add accumulates with atomics on the card: a (copy, src,
        # dst) cell gets at most one real edge and padding goes to the
        # trash slot, so the sums are exact in any order
        dense_edges = edge_feat.new_zeros(S * M * M + 1, C_e).index_add(
            0, cell, edge_feat)[:-1].view(S, M, M, C_e)
        xm = torch.where(node_mask[:, None], x, 0.0)
        # one real node per diagonal cell, padding to the trash slot: exact
        diag = x.new_zeros(S * M + 1, x.shape[-1]).index_add(
            0, node_slot, xm)[:-1].view(S, M, -1)
        eye = torch.eye(M, device=dev)
        diag_dense = diag[:, :, None, :] * eye[None, :, :, None]
        z = torch.cat([dense_edges, diag_dense], dim=-1)

        cdt = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
               else torch.float32)
        pmask = _pair_mask(nm)
        z = (z * pmask).to(cdt)
        for i in range(cfg.num_rb_layers):
            z = getattr(self, f"rb{i}")(z, pmask)

        # copy pooling: max + mean + min
        pooled = (diag_offdiag_pool_masked(z, nm, "max")
                  + diag_offdiag_pool_masked(z, nm, "mean")
                  + diag_offdiag_pool_masked(z, nm, "min"))  # (S, 2 emb)
        h = F.relu(self.fc_g0(pooled))
        h = F.relu(self.fc_g1(h))
        h = h * batch.segment_mask[:, None]

        # graph-level dense grid (G, K, K, emb + 1)
        orig_adj = batch.extras["orig_adj"].float()  # (G, K, K)
        K = orig_adj.shape[1]
        sidx = torch.arange(S, device=dev)
        sg = batch.segment_graph.long()
        sloc = _local_index(sidx, sg, G, batch.segment_mask, K)
        seg_slot = _dense_index(sg, sloc, G, K)
        sm = torch.zeros(G * K + 1, dtype=torch.bool, device=dev).index_put(
            (seg_slot,), batch.segment_mask)[:-1].view(G, K)
        # one real copy per diagonal cell, padding to the trash slot: exact
        diag_g = h.new_zeros(G * K + 1, cfg.emb_dim).index_add(
            0, seg_slot, h)[:-1].view(G, K, -1)
        eye_g = torch.eye(K, device=dev)
        diag_g_dense = diag_g[:, :, None, :] * eye_g[None, :, :, None]
        zg = torch.cat([orig_adj[..., None], diag_g_dense], dim=-1)
        pmask_g = _pair_mask(sm)
        zg = (zg * pmask_g).to(cdt)
        for i in range(cfg.num_rb_layers):
            zg = getattr(self, f"rb_g{i}")(zg, pmask_g)

        if cfg.graph_pred:
            pooled_g = (diag_offdiag_pool_masked(zg, sm, "max")
                        + diag_offdiag_pool_masked(zg, sm, "mean")
                        + diag_offdiag_pool_masked(zg, sm, "min"))
            out = self.fc1(F.relu(self.fc0(pooled_g)))
            return F.log_softmax(out, dim=-1) if cfg.classify else out

        # node level: diagonal + row/column sums per subgraph slot, back to
        # the flat subgraph axis (subgraph s is rooted at original node s)
        zz = torch.where(pmask_g > 0, zg, torch.zeros((), dtype=zg.dtype,
                                                      device=dev))
        row = zz.sum(2, dtype=torch.float32)
        col = zz.sum(1, dtype=torch.float32)
        dg = torch.diagonal(zg, dim1=1, dim2=2).permute(0, 2, 1).float()
        feat = torch.cat([dg, row + col - 2 * dg], dim=-1)  # (G, K, 2 emb)
        flat = feat[sg.clamp_max(G - 1), sloc.clamp_max(K - 1)]
        out = self.fc1(F.relu(self.fc0(flat)))
        return out * batch.segment_mask[:, None]
