"""ID-GNN: identity-aware message passing (counterpart of
`escgnn_tpu/models/idgnn.py`).

Each conv keeps two weight sets, the ordinary one and an identity one
added on the identity (root) rows: x W, plus x W_id where the row is a
root, before propagation (GCN, SAGE, GAT), or a second MLP on the
aggregate (GIN). The identity of each node-rooted copy is its root, the
first node of its segment; without copies, each graph's first node.

Names follow the flax tree. The GIN convs' MLPs are top-level `MLP_<i>`
modules there, two per conv in creation order (`mlp`, `mlp_id`), which
`flax_mlps_per_conv` tells `weights.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.models.baselines import (
    _normal_param,
    gcn_norm,
    self_loop_attention,
)
from escgnn_tpu_torch.models.layers import MLP, Dropout, TorchDense
from escgnn_tpu_torch.models.ngnn import copy_roots
from escgnn_tpu_torch.ops.segment import gather_rows, segment_mean, segment_sum


class _IdConv(nn.Module):
    """A conv with the identity transform: x W, plus x W_id on the
    identity rows (`lin_w`, `lin_w_id`), and a bias."""

    def __init__(self, in_features: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.lin_w = TorchDense(in_features, features, bias=False,
                                generator=generator)
        self.lin_w_id = TorchDense(in_features, features, bias=False,
                                   generator=generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def id_transform(self, x, is_root):
        h = self.lin_w(x)
        return torch.where(is_root[:, None], h + self.lin_w_id(x), h)


class GINIDConv(nn.Module):
    """h = x + sum_{j != i} x_j (self loops removed); out = mlp(h), plus
    mlp_id(h) on the identity rows."""

    def __init__(self, mlp: nn.Module, mlp_id: nn.Module):
        super().__init__()
        self.mlp = mlp
        self.mlp_id = mlp_id

    def forward(self, x, senders, receivers, edge_mask, is_root, node_mask):
        agg = segment_sum(gather_rows(x, senders), receivers,
                          x.shape[0], edge_mask & (senders != receivers))
        h = x + agg
        out = self.mlp(h, node_mask)
        return torch.where(is_root[:, None], out + self.mlp_id(h, node_mask),
                           out)


class GCNIDConv(_IdConv):
    """gcn-normalized propagation (analytic self loops) of the
    identity-transformed features, plus a bias."""

    def forward(self, x, senders, receivers, edge_mask, is_root):
        n = x.shape[0]
        h = self.id_transform(x, is_root)
        w, self_w = gcn_norm(receivers, senders, n, edge_mask)
        agg = segment_sum(gather_rows(h, senders) * w[:, None],
                          receivers, n, edge_mask)
        return agg + h * self_w[:, None] + self.bias


class SAGEIDConv(_IdConv):
    """The mean of the identity-transformed neighbours, plus the node's
    own and a bias."""

    def forward(self, x, senders, receivers, edge_mask, is_root):
        h = self.id_transform(x, is_root)
        agg = segment_mean(gather_rows(h, senders), receivers,
                           x.shape[0], mask=edge_mask)
        return agg + h + self.bias


class GATIDConv(_IdConv):
    """The identity transform, then GAT attention with self loops in the
    softmax; `att` is (heads, 2F): [a_i | a_j]."""

    def __init__(self, in_features: int, features: int, heads: int = 1,
                 negative_slope: float = 0.2, *, generator: torch.Generator):
        super().__init__(in_features, heads * features, generator=generator)
        self.heads, self.features = heads, features
        self.negative_slope = negative_slope
        self.att = _normal_param((heads, 2 * features), 0.1, generator)

    def forward(self, x, senders, receivers, edge_mask, is_root):
        n, Fh = x.shape[0], self.features
        h = self.id_transform(x, is_root).reshape(n, self.heads, Fh)
        a_i, a_j = self.att[:, :Fh], self.att[:, Fh:]
        out = self_loop_attention(
            h, (h * a_j).sum(-1), (h * a_i).sum(-1), senders, receivers,
            edge_mask, self.negative_slope)
        return out.reshape(n, -1) + self.bias


IDGNN_CONVS = ("gin", "gcn", "sage", "gat")


@dataclasses.dataclass(frozen=True)
class IDGNNConfig:
    conv: str = "gin"  # gin | gcn | sage | gat
    hidden: int = 64
    num_layers: int = 3
    out_dim: int = 2
    dropout: float = 0.5
    pool: str = "mean"  # the JAX model pools by mean whatever this says
    classify: bool = True
    gat_heads: int = 4


class IDGNN(nn.Module):
    """ID-GNN over node-rooted subgraph copies, pooled node -> copy ->
    graph by means (node -> graph without copies), then Linear -> ReLU ->
    dropout -> Linear (log_softmax when `classify`). `in_dim`: the
    columns of `x`."""

    # the flax tree holds each GIN conv's (mlp, mlp_id) as top-level
    # MLP_<2i>, MLP_<2i+1>
    flax_mlps_per_conv = 2

    def __init__(self, cfg: IDGNNConfig, in_dim: int = 1, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 rng_seed: int = 0):
        super().__init__()
        if cfg.conv not in IDGNN_CONVS:
            raise ValueError(f"conv {cfg.conv!r}")
        if cfg.conv == "gat" and cfg.hidden % cfg.gat_heads:
            raise ValueError("gat_heads must divide hidden")
        device = resolve_device(device)
        g = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        self.cfg = cfg
        H = cfg.hidden
        self.rng = torch.Generator(device=device).manual_seed(rng_seed)
        self.drop = Dropout(cfg.dropout, self.rng)
        d = in_dim
        for i in range(cfg.num_layers):
            if cfg.conv == "gin":
                conv = GINIDConv(MLP(d, (H, H), F.relu, generator=g),
                                 MLP(d, (H, H), F.relu, generator=g))
            elif cfg.conv == "gcn":
                conv = GCNIDConv(d, H, generator=g)
            elif cfg.conv == "sage":
                conv = SAGEIDConv(d, H, generator=g)
            else:
                conv = GATIDConv(d, H // cfg.gat_heads, heads=cfg.gat_heads,
                                 generator=g)
            self.add_module(f"conv{i + 1}", conv)
            d = H
        self.lin1 = TorchDense(H, H, generator=g)
        self.lin2 = TorchDense(H, cfg.out_dim, generator=g)
        self.to(device)

    def generators(self) -> list:
        """The generators a train-mode forward draws from."""
        return [self.rng] if self.cfg.dropout > 0 else []

    def forward(self, batch: GraphBatch):
        cfg = self.cfg
        nm, em = batch.node_mask, batch.edge_mask
        s, r = batch.senders, batch.receivers
        x = batch.x.float()
        if x.dim() == 1:
            x = x[:, None]
        copies = batch.node_segment is not None
        if copies:
            S = batch.segment_mask.shape[0]
            is_root = copy_roots(nm, batch.node_segment, S)[1]
        else:
            is_root = (batch.node_local == 0) & nm

        h = x
        for i in range(cfg.num_layers):
            conv = getattr(self, f"conv{i + 1}")
            if cfg.conv == "gin":
                h = conv(h, s, r, em, is_root, nm)
            else:
                h = F.relu(conv(h, s, r, em, is_root))

        if copies:
            sm = batch.segment_mask
            h = segment_mean(h, batch.node_segment, S,
                             mask=nm)
            h = segment_mean(h, batch.segment_graph,
                             batch.num_graphs, mask=sm)
        else:
            h = segment_mean(h, batch.node_graph, batch.num_graphs, mask=nm)
        h = self.drop(F.relu(self.lin1(h)))
        h = self.lin2(h)
        return F.log_softmax(h, dim=-1) if cfg.classify else h
