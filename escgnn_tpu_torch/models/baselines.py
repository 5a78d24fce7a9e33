"""Baseline message-passing convolutions and the TU-benchmark model zoo
(counterpart of `escgnn_tpu/models/baselines.py`).

GCN, directional GCN, GraphSAGE, GIN/GIN0, GAT, RGCN and PNA convs over
the padded edge list of a `GraphBatch` (gather sender rows, masked
segment reduction into receivers), the configurable `BaselineGNN` (conv
stack, jumping knowledge, deep-supervision heads, node-level or nested
two-level pooling, or `graph_pool`, and a two-layer head) and the QM9 /
ZINC RGCN baseline `RGCNBaseline`.

RGCN computes x W_r once per node and relation, (N, R, F'), and gathers
row [sender, type] per edge: the same sum as JAX's per-edge (E, F, F')
weight gather in N·R·F' instead of E·F·F' memory. GAT's self loops enter
the softmax analytically, as in JAX. Submodule and parameter names
follow the flax tree (`w_rel`, `att_src`, `w_pre`, ... keep their flax
layout), so `weights.py` carries a flax state across; weights are drawn
on the CPU from `generator` (seed 0 when None) and moved to `device`;
dropout draws from the model's generator `rng` in `train()` only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.models.layers import (
    MLP,
    Dropout,
    EmbedMM,
    MaskedBatchNorm,
    TorchDense,
)
from escgnn_tpu_torch.models.pooling import (
    GlobalAttentionPool,
    Set2Set,
    graph_pool,
    graph_pool_width,
)
from escgnn_tpu_torch.ops.segment import (
    gather_rows,
    masked_ids,
    segment_max,
    segment_mean,
    segment_min,
    segment_sum,
)


def _normal_param(shape, std: float, generator: torch.Generator):
    return nn.Parameter(torch.empty(shape).normal_(0.0, std,
                                                   generator=generator))


def _lecun_param(shape, fan_in: int, generator: torch.Generator):
    """N(0, 1 / fan_in) weights, the scale of flax's `lecun_normal`."""
    return _normal_param(shape, 1.0 / math.sqrt(fan_in), generator)


def _degree(receivers, num_nodes: int, edge_mask):
    return segment_sum(edge_mask.float(), receivers, num_nodes)


def gcn_norm(receivers, senders, num_nodes: int, edge_mask):
    """(per-edge 1/sqrt(d_s d_r), per-node 1/d) with d counting the self
    loop: the normalization of a GCN conv with analytic self loops."""
    deg = _degree(receivers, num_nodes, edge_mask) + 1.0
    inv_sqrt = torch.rsqrt(deg.clamp_min(1e-12))
    w = gather_rows(inv_sqrt, senders) * gather_rows(inv_sqrt, receivers)
    return w, inv_sqrt * inv_sqrt


def self_loop_attention(h, alpha_src, alpha_dst, senders, receivers,
                        edge_mask, negative_slope: float):
    """GAT's aggregation with analytic self loops: the softmax over
    {neighbours} u {self} of LeakyReLU(alpha_src[j] + alpha_dst[i]) weights
    h[j] and h[i]; h (N, H, F), alphas (N, H). Returns (N, H, F)."""
    n = h.shape[0]
    s, r = senders, receivers
    logits = F.leaky_relu(gather_rows(alpha_src, s)
                          + gather_rows(alpha_dst, r), negative_slope)
    self_logit = F.leaky_relu(alpha_src + alpha_dst, negative_slope)
    mx = segment_max(logits, r, n, mask=edge_mask, empty_value=-math.inf)
    mx = torch.maximum(mx, self_logit)
    ex_e = torch.where(edge_mask[:, None],
                       torch.exp(logits - gather_rows(mx, r)),
                       torch.zeros((), dtype=logits.dtype,
                                   device=logits.device))
    ex_s = torch.exp(self_logit - mx)
    denom = (segment_sum(ex_e, r, n) + ex_s).clamp_min(1e-16)
    num = (segment_sum(gather_rows(h, s) * ex_e[..., None], r, n)
           + h * ex_s[..., None])
    return num / denom[..., None]


class GCNConv(nn.Module):
    """PyG-semantics GCNConv with analytic self loops: out_i = sum_j
    1/sqrt(d_i d_j) (x_j W) + x_i W / d_i + b, degrees counting the loop."""

    def __init__(self, in_features: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.lin = TorchDense(in_features, features, bias=False,
                              generator=generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, senders, receivers, edge_mask):
        n = x.shape[0]
        h = self.lin(x)
        w, self_w = gcn_norm(receivers, senders, n, edge_mask)
        agg = segment_sum(gather_rows(h, senders) * w[:, None],
                          receivers, n, edge_mask)
        return agg + h * self_w[:, None] + self.bias


class DirectionalGCNConv(nn.Module):
    """The reference's experimental hop-directional GCNConv: the
    gcn-normalized messages of "up" edges are summed and those of "down"
    edges min-aggregated, the two added. up = ((s < r) & (z_s == z_r))
    + z_s < z_r, the reference's precedence kept. No self-loop term."""

    def __init__(self, in_features: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.lin = TorchDense(in_features, features, bias=False,
                              generator=generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, senders, receivers, edge_mask, z):
        n = x.shape[0]
        s, r = senders, receivers
        h = self.lin(x)
        w, _ = gcn_norm(receivers, senders, n, edge_mask)
        zs, zr = z.index_select(0, s).long(), z.index_select(0, r).long()
        tie = ((s < r) & (zs == zr)).long()
        up = (tie + zs) < zr
        msg = gather_rows(h, s) * w[:, None]
        agg_up = segment_sum(msg, r, n, mask=edge_mask & up)
        agg_dn = segment_min(msg, r, n, mask=edge_mask & ~up)
        return agg_up + agg_dn + self.bias


class SAGEConv(nn.Module):
    """GraphSAGE mean-aggregator conv: lin_l(mean_j x_j) + lin_r(x)."""

    def __init__(self, in_features: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.lin_l = TorchDense(in_features, features, generator=generator)
        self.lin_r = TorchDense(in_features, features, bias=False,
                                generator=generator)

    def forward(self, x, senders, receivers, edge_mask):
        agg = segment_mean(gather_rows(x, senders), receivers,
                           x.shape[0], mask=edge_mask)
        return self.lin_l(agg) + self.lin_r(x)


class GINConv(nn.Module):
    """PyG GINConv: mlp((1 + eps) x + sum_j x_j); eps trained when
    `train_eps` (GIN), fixed at 0 otherwise (GIN0)."""

    def __init__(self, mlp: nn.Module, train_eps: bool = True):
        super().__init__()
        self.mlp = mlp
        if train_eps:
            self.eps = nn.Parameter(torch.zeros(()))

    def forward(self, x, senders, receivers, edge_mask, node_mask=None):
        agg = segment_sum(gather_rows(x, senders), receivers,
                          x.shape[0], edge_mask)
        eps = self.eps if hasattr(self, "eps") else 0.0
        return self.mlp((1.0 + eps) * x + agg, node_mask)


class GATConv(nn.Module):
    """PyG-semantics GATConv with `heads` heads and self loops: alpha =
    softmax_i(LeakyReLU(a_src . W x_j + a_dst . W x_i)), out = concat_h
    sum_j alpha W x_j."""

    def __init__(self, in_features: int, features: int, heads: int = 1,
                 negative_slope: float = 0.2, *, generator: torch.Generator):
        super().__init__()
        self.heads, self.features = heads, features
        self.negative_slope = negative_slope
        self.lin = TorchDense(in_features, heads * features, bias=False,
                              generator=generator)
        self.att_src = _normal_param((heads, features), 0.1, generator)
        self.att_dst = _normal_param((heads, features), 0.1, generator)

    def forward(self, x, senders, receivers, edge_mask):
        n = x.shape[0]
        h = self.lin(x).reshape(n, self.heads, self.features)
        out = self_loop_attention(
            h, (h * self.att_src).sum(-1), (h * self.att_dst).sum(-1),
            senders, receivers, edge_mask, self.negative_slope)
        return out.reshape(n, -1)


def edge_type_ids(edge_type):
    """Relation ids per edge: the argmax of one-hot rows, or the ids."""
    if edge_type.dim() == 2:
        edge_type = edge_type.argmax(-1)
    return edge_type.long().reshape(-1)


class RGCNConv(nn.Module):
    """Relational GCN conv, aggr='add': out = x W_root + b + sum_r
    sum_{j in N_r(i)} x_j W_r, with x W_r computed once per node and
    relation (see module docstring)."""

    def __init__(self, in_features: int, features: int, num_relations: int,
                 *, generator: torch.Generator):
        super().__init__()
        self.w_rel = _lecun_param((num_relations, in_features, features),
                                  in_features, generator)
        self.lin_root = TorchDense(in_features, features, generator=generator)

    def forward(self, x, senders, receivers, edge_mask, edge_type):
        n = x.shape[0]
        R, _, Fo = self.w_rel.shape
        xw = torch.einsum("nf,rfg->nrg", x.float(), self.w_rel)
        rows = senders.long() * R + edge_type_ids(edge_type)
        msg = gather_rows(xw.reshape(n * R, Fo), rows)
        return segment_sum(msg, receivers, n, edge_mask) + self.lin_root(x)


class PNAConv(nn.Module):
    """Principal Neighbourhood Aggregation conv: per tower, a pre-MLP on
    [x_i ‖ x_j], the mean / min / max / std aggregators times the
    identity, amplification and attenuation degree scalers, a post-MLP
    on [x ‖ scaled aggregates], and a Linear over the towers.
    `avg_deg_log` is E[log(d + 1)] over the training graphs. With
    `edge_dim`, a Linear `lin_edge` maps the edge features to one tower's
    width and the pre-MLP reads [x_i ‖ x_j ‖ e_ji] (GPS's local PNA)."""

    def __init__(self, in_features: int, features: int, towers: int = 1,
                 avg_deg_log: float = 1.0, edge_dim: Optional[int] = None,
                 *, generator: torch.Generator):
        super().__init__()
        if in_features % towers or features % towers:
            raise ValueError("towers must divide the widths")
        g = generator
        self.towers, self.avg_deg_log = towers, avg_deg_log
        f_in, f_out = in_features // towers, features // towers
        self.lin_edge = (TorchDense(edge_dim, f_in, generator=g)
                         if edge_dim is not None else None)
        parts = 2 if edge_dim is None else 3
        self.w_pre = _lecun_param((towers, parts * f_in, f_in), parts * f_in,
                                  g)
        self.b_pre = nn.Parameter(torch.zeros(towers, f_in))
        self.w_post = _lecun_param((towers, 13 * f_in, f_out), 13 * f_in, g)
        self.b_post = nn.Parameter(torch.zeros(towers, f_out))
        self.lin_out = TorchDense(features, features, generator=g)

    def forward(self, x, senders, receivers, edge_mask, edge_attr=None):
        n = x.shape[0]
        T = self.towers
        xt = x.reshape(n, T, -1)
        r = receivers
        src = gather_rows(xt, senders)
        parts = [gather_rows(xt, r), src]
        if edge_attr is not None and self.lin_edge is not None:
            e = self.lin_edge(edge_attr.to(torch.float32).reshape(
                edge_attr.shape[0], -1))
            parts.append(e[:, None, :].expand_as(src))
        m = torch.cat(parts, dim=-1)
        m = F.relu(torch.einsum("eti,tio->eto", m, self.w_pre) + self.b_pre)
        mean = segment_mean(m, r, n, mask=edge_mask)
        mx = segment_max(m, r, n, mask=edge_mask)
        mn = segment_min(m, r, n, mask=edge_mask)
        sq = segment_mean(m * m, r, n, mask=edge_mask)
        std = torch.sqrt(F.relu(sq - mean * mean) + 1e-5)
        agg = torch.cat([mean, mn, mx, std], dim=-1)
        ld = torch.log(_degree(r, n, edge_mask) + 1.0)
        amp = (ld / self.avg_deg_log)[:, None, None]
        att = (self.avg_deg_log / ld.clamp_min(1e-5))[:, None, None]
        scaled = torch.cat([xt, agg, agg * amp, agg * att], dim=-1)
        out = torch.einsum("nti,tio->nto", scaled, self.w_post) + self.b_post
        return self.lin_out(out.reshape(n, -1))


BASELINE_CONVS = ("gcn", "gcn_dir", "sage", "gin0", "gin", "gat", "rgcn",
                  "pna")


@dataclasses.dataclass(frozen=True)
class BaselineGNNConfig:
    conv: str = "gcn"  # gcn | gcn_dir | sage | gin0 | gin | gat | rgcn | pna
    hidden: int = 64
    num_layers: int = 3
    out_dim: int = 2
    dropout: float = 0.5
    pool: str = "mean"  # mean | add | max | attention | set2set | sort
    nested: bool = False  # two-level pooling over subgraph copies
    gat_heads: int = 4
    num_relations: int = 4
    classify: bool = True  # log_softmax head (TU classification)
    sort_k: int = 10
    node_embed_vocab: int = 0  # int node types -> embedding
    jk: bool = False  # jumping-knowledge concat of all layers
    # node-level head: skip graph pooling, one prediction per original
    # node (per copy row when nested)
    node_level: bool = False
    # deep supervision: per-layer auxiliary predictions ys[i] from the
    # concat of layers <= i; forward returns (out, ys)
    multi_layer: bool = False


class BaselineGNN(nn.Module):
    """Configurable TU-benchmark model: conv stack + pooling + a 2-layer
    head (GCN / NestedGCN / GraphSAGE / GIN0 / GIN / GAT / RGCN / PNA).
    `in_dim`: the columns of `x` (ignored with `node_embed_vocab`, which
    embeds one type id per node). Reads `extras['z']` under `gcn_dir` and
    `edge_attr` (relation ids or one-hot rows) under `rgcn`; `nested`
    pools node -> copy -> graph means over a copy batch."""

    def __init__(self, cfg: BaselineGNNConfig, in_dim: int = 1,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 rng_seed: int = 0):
        super().__init__()
        if cfg.conv not in BASELINE_CONVS:
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
        if cfg.node_embed_vocab:
            self.node_type_embedding = EmbedMM(cfg.node_embed_vocab, H,
                                               generator=g)
            in_dim = H
        d = in_dim
        for i in range(cfg.num_layers):
            self.add_module(f"conv{i + 1}", self._conv(d, g))
            d = H
        F_out = H * cfg.num_layers if cfg.jk else H
        if cfg.multi_layer:
            for i in range(1, cfg.num_layers):
                self.add_module(f"multi_lin{i}",
                                TorchDense(H * i, H, generator=g))
                self.add_module(f"multi_bn{i}", MaskedBatchNorm(H))
                self.add_module(f"multi_lin2{i}", TorchDense(
                    H, min(2 * i - 1, cfg.out_dim), generator=g))
        pool = cfg.pool
        if cfg.node_level or cfg.nested:
            pool = "mean"
        elif pool == "attention":
            self.attn_pool = GlobalAttentionPool(F_out, generator=g)
        elif pool == "set2set":
            self.set2set = Set2Set(F_out, generator=g)
        self.lin1 = TorchDense(graph_pool_width(pool, F_out, cfg.sort_k), H,
                               generator=g)
        self.lin2 = TorchDense(H, cfg.out_dim, generator=g)
        self.to(device)

    def _conv(self, d: int, g: torch.Generator) -> nn.Module:
        cfg = self.cfg
        H = cfg.hidden
        if cfg.conv == "gcn":
            return GCNConv(d, H, generator=g)
        if cfg.conv == "gcn_dir":
            return DirectionalGCNConv(d, H, generator=g)
        if cfg.conv == "sage":
            return SAGEConv(d, H, generator=g)
        if cfg.conv in ("gin0", "gin"):
            return GINConv(MLP(d, (H, H), F.relu, generator=g),
                           train_eps=cfg.conv == "gin")
        if cfg.conv == "gat":
            return GATConv(d, H // cfg.gat_heads, heads=cfg.gat_heads,
                           generator=g)
        if cfg.conv == "rgcn":
            return RGCNConv(d, H, cfg.num_relations, generator=g)
        return PNAConv(d, H, towers=1, generator=g)

    def generators(self) -> list:
        """The generators a train-mode forward draws from."""
        return [self.rng] if self.cfg.dropout > 0 else []

    def forward(self, batch: GraphBatch):
        cfg = self.cfg
        nm, em = batch.node_mask, batch.edge_mask
        s, r = batch.senders, batch.receivers
        x = batch.x
        if cfg.node_embed_vocab:
            x = self.node_type_embedding(x.reshape(x.shape[0]))
        x = x.float()
        if x.dim() == 1:
            x = x[:, None]
        z = (batch.extras or {}).get("z")
        if z is not None and z.dim() == 2:
            z = z[:, 0]

        xs = []
        h = x
        for i in range(cfg.num_layers):
            conv = getattr(self, f"conv{i + 1}")
            if cfg.conv == "gcn_dir":
                h = conv(h, s, r, em, z)
            elif cfg.conv in ("gin0", "gin"):
                h = conv(h, s, r, em, nm)
            elif cfg.conv == "rgcn":
                h = conv(h, s, r, em, batch.edge_attr)
            else:
                h = conv(h, s, r, em)
            if cfg.conv not in ("gin0", "gin"):
                h = F.relu(h)
            xs.append(h)
        if cfg.jk:
            h = torch.cat(xs, dim=-1)

        if cfg.nested:
            sm = batch.segment_mask
            S = sm.shape[0]
            seg = masked_ids(batch.node_segment, nm)
            seg_graph = masked_ids(batch.segment_graph, sm)

        def to_rows(feats):
            """Per-original-node rows: with node copies, each copy's mean
            (one copy per original node)."""
            return segment_mean(feats, seg, S, mask=nm) if cfg.nested else (
                feats)

        ys = []
        if cfg.multi_layer:
            row_mask = sm if cfg.nested else nm
            for i in range(1, cfg.num_layers):
                a = to_rows(torch.cat(xs[:i], dim=-1))
                a_mask = row_mask
                if not cfg.node_level:
                    a = (segment_mean(a, seg_graph, batch.num_graphs,
                                      mask=sm) if cfg.nested else
                         segment_mean(a, batch.node_graph, batch.num_graphs,
                                      mask=nm))
                    a_mask = batch.graph_mask
                a = getattr(self, f"multi_lin{i}")(a)
                a = getattr(self, f"multi_bn{i}")(a, a_mask)
                a = F.relu(self.drop(a))
                ys.append(getattr(self, f"multi_lin2{i}")(a))

        if cfg.node_level:
            h = to_rows(h)
        elif cfg.nested:
            h = segment_mean(to_rows(h), seg_graph, batch.num_graphs, mask=sm)
        else:
            h = graph_pool(self, cfg.pool, h, batch, sort_k=cfg.sort_k)

        h = self.drop(F.relu(self.lin1(h)))
        h = self.lin2(h)
        if cfg.classify:
            h = F.log_softmax(h, dim=-1)
        return (h, ys) if cfg.multi_layer else h


@dataclasses.dataclass(frozen=True)
class RGCNBaselineConfig:
    """The reference's QM9 / ZINC 'GNN' RGCN baseline."""

    num_layers: int = 5
    edge_attr_dim: int = 5
    use_pos: bool = False
    concat: bool = False
    # node-level head (the cycle-counting variant): no graph pooling, the
    # fc head per node
    node_level: bool = False


class RGCNBaseline(nn.Module):
    """Reads `x` (one type id per node, embedded and appended as a float),
    `edge_attr` (relation ids or one-hot rows) and, with `use_pos`,
    `pos`; RGCN widths 32 then 64, ELU, mean pooling, fc 32 / 16 / 1."""

    def __init__(self, cfg: RGCNBaselineConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        self.cfg = cfg
        self.node_type_embedding = EmbedMM(100, 8, generator=g)
        d = 9 + (3 if cfg.use_pos else 0)
        widths = [32] + [64] * (cfg.num_layers - 1)
        for i, w in enumerate(widths):
            self.add_module(f"conv{i + 1}", RGCNConv(d, w, cfg.edge_attr_dim,
                                                     generator=g))
            d = w
        self.fc1 = TorchDense(sum(widths) if cfg.concat else d, 32,
                              generator=g)
        self.fc2 = TorchDense(32, 16, generator=g)
        self.fc3 = TorchDense(16, 1, generator=g)
        self.to(device)

    def forward(self, batch: GraphBatch):
        cfg = self.cfg
        xi = batch.x.reshape(batch.x.shape[0])
        x = torch.cat([self.node_type_embedding(xi), xi[:, None].float()],
                      dim=-1)
        if cfg.use_pos:
            x = torch.cat([x, batch.pos.float()], dim=-1)
        xs = []
        for i in range(cfg.num_layers):
            x = F.elu(getattr(self, f"conv{i + 1}")(
                x, batch.senders, batch.receivers, batch.edge_mask,
                batch.edge_attr))
            xs.append(x)
        if cfg.concat:
            x = torch.cat(xs, dim=-1)
        if not cfg.node_level:
            x = segment_mean(x, batch.node_graph, batch.num_graphs,
                             mask=batch.node_mask)
        x = F.elu(self.fc1(x))
        x = F.elu(self.fc2(x))
        return self.fc3(x)
