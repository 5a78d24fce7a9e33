"""GPS — general, powerful, scalable graph transformer with ESC injection
(counterpart of `escgnn_tpu/models/gps.py`).

Each layer runs a local MPNN (GINE, GatedGCN or PNA) and a global
attention (dense multi-head with an optional SPD bias, BigBird's masked
pattern, elu+1 linear attention, FAVOR+, SAN or SAN2) in parallel over
the same hidden state, sums them and applies a feed-forward block, with
the ESC per-edge structural embedding added to the edge features at every
layer; `global_model="graphormer"` makes the layer one pre-LN Graphormer
block instead. The node encoders (embed, linear, ogb_atom, ppa_uniform,
ast, LapPE, SignNet, RWSE, degree, EquivStable) and the edge encoders
(embed, linear, ogb_bond, none) are the JAX package's, and so are the
submodule and parameter names (`weights.py` carries a flax state across).

The dense attention scatters the node states into a (G, M, D) grid, M the
per-graph node budget (`attn_bias.shape[1]`). A padding node's
`node_local` is M, out of range: JAX's scatter drops such rows and its
gather clamps them. Here the scatter writes into a trash column M of a
(G, M + 1) grid that is cut off, and the gather back clamps to M - 1, so
every output row, padding rows included, is JAX's. Masked logits take
float32's finite minimum (not -inf), so a padding graph's rows give a
finite uniform softmax, as in JAX; the attention is plain products and a
softmax, and `forward(..., return_attention=True)` returns each dense
attention's weights (JAX's `sow("intermediates", "attn_weights")`).

SAN's real-edge grid counts each real edge into its (graph, src, dst)
cell (JAX sets the cell from the edge mask through duplicate and padding
indices); only real edges set a cell, so no write order decides a value.

FAVOR+'s projection is a non-trainable buffer drawn from the model's own
generator with JAX's construction (QR'd Gaussian blocks, chi-distributed
row norms); JAX draws it from `jax.random.key(0x5EED)`, which torch
cannot reproduce, so a test that compares the two loads JAX's matrix
through `weights.load_flax_variables(..., constants=...)`.

The SPD-bias lookup's backward is the one-hot product (JAX's `EmbedMM`):
a sorted backward would sort the G * M * M ids of every layer.

Dropout draws from the model's generator `rng` in `train()` only; with
dropout > 0 the ESC embedding takes the per-edge path (rows expanded
first), as JAX does.
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
from escgnn_tpu_torch.models.baselines import PNAConv
from escgnn_tpu_torch.models.layers import (
    MLP,
    Dropout,
    GINEConv,
    MaskedBatchNorm,
    TorchDense,
    TorchEmbed,
)
from escgnn_tpu_torch.models.ogb_gnn import (
    ATOM_FEATURE_DIMS,
    BOND_FEATURE_DIMS,
    FeatureSumEncoder,
)
from escgnn_tpu_torch.ops.segment import (
    gather_rows,
    pool_nodes_to_graphs,
    segment_softmax,
    segment_sum,
)
from escgnn_tpu_torch.ops.zemb import (
    expand_rows,
    zemb_from_batch,
    zemb_unique_rows,
)

GLOBAL_MODELS = ("transformer", "bigbird", "linear", "performer", "san",
                 "san2", "graphormer")
LOCAL_MODELS = ("gine", "gatedgcn", "pna")
NODE_ENCODERS = ("embed", "linear", "ogb_atom", "ppa_uniform", "ast")
EDGE_ENCODERS = ("embed", "linear", "none", "ogb_bond")


@dataclasses.dataclass(frozen=True)
class GPSConfig:
    dim_h: int = 64
    num_layers: int = 4
    num_heads: int = 4
    dropout: float = 0.0
    attn_dropout: float = 0.0
    local_model: str = "gine"  # gine | gatedgcn | pna
    # transformer | linear | performer | bigbird | san | san2 | graphormer
    global_model: str = "transformer"
    # BigBird's dense masked pattern: sliding window in node-index order,
    # the first g tokens global, deterministic pseudo-random extra keys
    bigbird_window: int = 3
    bigbird_global: int = 2
    bigbird_random: int = 2
    pna_towers: int = 4
    avg_deg_log: float = 1.0  # E[log(1+deg)] for pna scalers
    use_esc: bool = True  # inject ESC edge encoding every layer
    use_attn_bias: bool = False  # Graphormer-style SPD bias
    spd_vocab: int = 102  # cap 100 + unreachable + 0
    use_lap_pe: bool = False  # extras["lap_pe"] -> linear
    use_signnet: bool = False  # per-eigenvector DeepSets phi(v) + phi(-v)
    signnet_phi_dim: int = 16
    use_rwse: bool = False  # extras["rwse"] -> linear
    use_degree: bool = False  # extras["degree"] -> embedding
    # embed | linear | ogb_atom | ppa_uniform | ast
    node_encoder_kind: str = "embed"
    edge_encoder_kind: str = "embed"  # embed | linear | none | ogb_bond
    ast_type_vocab: int = 100
    ast_depth_vocab: int = 21
    san_gamma: float = 1e-5
    san_full_graph: bool = True
    performer_features: int = 64
    # EquivStableLapPE: linear-encoded eigvecs gate every GatedGCN message
    use_equivstable_pe: bool = False
    degree_vocab: int = 64
    node_vocab: int = 100
    edge_vocab: int = 100
    z_dim: int = 1800
    graph_pred: bool = True
    pool: str = "add"
    out_dim: int = 1
    # "default" = pooled / node MLP head; "inductive_edge" = the link head
    # (node embeddings of width dim_h, scored by dot products)
    head: str = "default"


def _check_config(cfg: GPSConfig) -> None:
    for value, allowed, what in (
            (cfg.global_model, GLOBAL_MODELS, "global_model"),
            (cfg.local_model, LOCAL_MODELS, "local_model"),
            (cfg.node_encoder_kind, NODE_ENCODERS, "node_encoder_kind"),
            (cfg.edge_encoder_kind, EDGE_ENCODERS, "edge_encoder_kind"),
            (cfg.head, ("default", "inductive_edge"), "head"),
            (cfg.pool, ("add", "mean"), "pool")):
        if value not in allowed:
            raise ValueError(f"{what} {value!r}: one of {allowed}")
    if cfg.dim_h % cfg.num_heads:
        raise ValueError("num_heads must divide dim_h")
    if cfg.use_equivstable_pe and cfg.local_model != "gatedgcn":
        raise ValueError("use_equivstable_pe needs local_model='gatedgcn'")


_NEG = torch.finfo(torch.float32).min


def bigbird_mask(m: int, window: int, num_global: int, num_random: int,
                 device=None) -> torch.Tensor:
    """(M, M) BigBird attendability: |i - j| <= window, the first
    `num_global` rows and columns, and for each r < num_random the key
    (i * (2r + 3) + r) mod M of query i."""
    i = torch.arange(m, device=device)[:, None]
    j = torch.arange(m, device=device)[None, :]
    mask = (i - j).abs() <= window
    mask = mask | (i < num_global) | (j < num_global)
    for r in range(num_random):
        mask = mask | (j == (i * (2 * r + 3) + r) % m)
    return mask


def dense_budget(batch: GraphBatch, fallback: bool = False) -> int:
    """The per-graph dense budget M: `attn_bias.shape[1]`; with
    `fallback`, else the uniform block size or ceil(N / G) (SAN's
    fake-edge grid)."""
    ex = batch.extras or {}
    if "attn_bias" in ex:
        return int(ex["attn_bias"].shape[1])
    if not fallback:
        raise ValueError("GPS attention needs the dense budget (attn_bias)")
    if batch.nodes_per_graph:
        return int(batch.nodes_per_graph)
    return max(-(-batch.num_nodes // max(batch.num_graphs, 1)), 1)


class DenseGrid:
    """Scatter node rows into the (G, M) grid and gather them back, with
    JAX's out-of-range rules (dropped on scatter, clamped on gather)."""

    def __init__(self, batch: GraphBatch, M: int):
        self.G, self.M = batch.num_graphs, M
        g = batch.node_graph.long()
        loc = batch.node_local.long()
        # scatter target in a (G, M + 1) grid: column M is the trash
        self.put = g * (M + 1) + loc.clamp(max=M)
        self.take = g * M + loc.clamp(max=M - 1)
        self.node_mask = batch.node_mask

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """(N, ...) -> (G, M, ...), padding rows zero and dropped."""
        rest = tuple(x.shape[1:])
        m = self.node_mask.reshape((-1,) + (1,) * len(rest))
        vals = torch.where(m, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))
        out = x.new_zeros((self.G * (self.M + 1),) + rest)
        out = out.index_put((self.put,), vals)
        return out.reshape((self.G, self.M + 1) + rest)[:, :self.M]

    def mask(self) -> torch.Tensor:
        """(G, M) bool: the grid cells a real node fills."""
        out = torch.zeros(self.G * (self.M + 1), dtype=torch.bool,
                          device=self.node_mask.device)
        out = out.index_put((self.put,), self.node_mask)
        return out.reshape(self.G, self.M + 1)[:, :self.M]

    def gather(self, grid: torch.Tensor) -> torch.Tensor:
        """(G, M, ...) -> (N, ...), padding rows read cell (g, M - 1)."""
        rest = tuple(grid.shape[2:])
        return gather_rows(grid.reshape((self.G * self.M,) + rest),
                           self.take)


class _OneHotEmbed(torch.autograd.Function):
    """table[ids] whose backward is the one-hot product onehot(ids)^T @ dY
    (JAX's `EmbedMM`), not a sort of the ids."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        vocab = torch.arange(ctx.vocab, device=ids.device)
        onehot = (ids[:, None] == vocab).to(dy.dtype)
        return onehot.t() @ dy, None


class SpdBias(nn.Module):
    """The per-head SPD-bias table (flax `spd_bias/embedding`, N(0, 0.02)
    init): ids (G, M, M) -> (G, M, M, heads)."""

    def __init__(self, vocab: int, heads: int, *, generator):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(vocab, heads).normal_(0.0, 0.02, generator=generator))

    def forward(self, ids):
        flat = ids.long().clamp(0, self.weight.shape[0] - 1).reshape(-1)
        return _OneHotEmbed.apply(self.weight, flat).reshape(
            ids.shape + (self.weight.shape[1],))


class DenseAttention(nn.Module):
    """Per-graph multi-head attention over the scattered (G, M, D) node
    states with key-padding masks, an optional SPD bias and the BigBird
    pattern (`pattern="bigbird"`). Keeps the last weights in
    `self.last_attn` when `self.capture` is set."""

    def __init__(self, dim_h: int, num_heads: int, use_bias: bool,
                 spd_vocab: int, pattern: str = "full", window: int = 3,
                 num_global: int = 2, num_random: int = 2, *, generator):
        super().__init__()
        g = generator
        self.D, self.Hh = dim_h, num_heads
        self.pattern = pattern
        self.bb = (window, num_global, num_random)
        for name in ("q", "k", "v"):
            self.add_module(name, TorchDense(dim_h, dim_h, generator=g))
        if use_bias:
            self.spd_bias = SpdBias(spd_vocab, num_heads, generator=g)
        self.out = TorchDense(dim_h, dim_h, generator=g)
        self.capture = False
        self.last_attn = None

    def forward(self, h, batch: GraphBatch):
        M = dense_budget(batch)
        grid = DenseGrid(batch, M)
        G, D, Hh = batch.num_graphs, self.D, self.Hh
        hd = D // Hh
        dense = grid.scatter(h)
        key_mask = grid.mask()
        q = self.q(dense).reshape(G, M, Hh, hd)
        k = self.k(dense).reshape(G, M, Hh, hd)
        v = self.v(dense).reshape(G, M, Hh, hd)
        logits = torch.einsum("gmhd,gnhd->ghmn", q, k) / math.sqrt(hd)
        if hasattr(self, "spd_bias"):
            bias = self.spd_bias(batch.extras["attn_bias"])
            logits = logits + bias.permute(0, 3, 1, 2)
        logits = torch.where(key_mask[:, None, None, :], logits, _NEG)
        if self.pattern == "bigbird":
            bb = bigbird_mask(M, *self.bb, device=logits.device)
            logits = torch.where(bb, logits, _NEG)
        attn = torch.softmax(logits, dim=-1)
        if self.capture:
            self.last_attn = attn
        out = torch.einsum("ghmn,gnhd->gmhd", attn, v).reshape(G, M, D)
        return grid.gather(self.out(out))


def _fake_grid(self_attn, h, batch: GraphBatch, M: int):
    """SAN / SAN2's fake-edge terms on the dense grid: (G, Hh, M src,
    M dst) scores K2[src] Q2[dst] E2 / sqrt(hd), the fake-pair mask (both
    ends real, not self, not a real edge) and the grid helper."""
    G, N = batch.num_graphs, h.shape[0]
    Hh, hd = self_attn.Hh, self_attn.D // self_attn.Hh
    grid = DenseGrid(batch, M)
    q2 = self_attn.q2(h).reshape(N, Hh, hd)
    k2 = self_attn.k2(h).reshape(N, Hh, hd)
    e2 = self_attn.e2(self_attn.fake_edge_emb).reshape(Hh, hd)
    dq2, dk2 = grid.scatter(q2), grid.scatter(k2)
    s2 = torch.einsum("gmhd,gnhd,hd->ghmn", dk2, dq2, e2) / math.sqrt(hd)
    nmask = grid.mask()
    pair = nmask[:, :, None] & nmask[:, None, :]
    pair = pair & ~torch.eye(M, dtype=torch.bool, device=h.device)
    # real-edge cells: each real edge counted into its (graph, src, dst)
    # cell of a (G, M + 1, M + 1) grid (padding edges' locals hit the
    # trash row and column)
    recv, send = batch.receivers.long(), batch.senders.long()
    e_g = batch.node_graph.long().index_select(0, recv)
    loc = batch.node_local.long().clamp(max=M)
    src_l, dst_l = loc.index_select(0, send), loc.index_select(0, recv)
    cell = (e_g * (M + 1) + src_l) * (M + 1) + dst_l
    # an atomic sum may stay: its terms are 0/1 edge flags, small integers
    # exact in f32 in any order
    cnt = torch.zeros(G * (M + 1) * (M + 1), device=h.device).index_add_(
        0, cell, batch.edge_mask.to(torch.float32))
    real = (cnt > 0).reshape(G, M + 1, M + 1)[:, :M, :M]
    return s2, pair & ~real, grid


class _SANBase(nn.Module):
    def __init__(self, dim_h: int, num_heads: int, full_graph: bool, *,
                 generator):
        super().__init__()
        g = generator
        self.D, self.Hh, self.full_graph = dim_h, num_heads, full_graph
        for name in ("q", "k", "v", "e"):
            self.add_module(name, TorchDense(dim_h, dim_h, generator=g))
        if full_graph:
            self.q2 = TorchDense(dim_h, dim_h, generator=g)
            self.k2 = TorchDense(dim_h, dim_h, generator=g)
            self.fake_edge_emb = nn.Parameter(
                torch.empty(dim_h).normal_(0.0, 1.0, generator=g))
            self.e2 = TorchDense(dim_h, dim_h, generator=g)

    def _real_scores(self, h, edge_attr, batch):
        N, Hh = h.shape[0], self.Hh
        hd = self.D // Hh
        q = self.q(h).reshape(N, Hh, hd)
        k = self.k(h).reshape(N, Hh, hd)
        v = self.v(h).reshape(N, Hh, hd)
        e = self.e(edge_attr).reshape(-1, Hh, hd)
        send, recv = batch.senders, batch.receivers
        s = (gather_rows(k, send) * gather_rows(q, recv) * e).sum(-1)
        return s / math.sqrt(hd), v


class SANAttention(_SANBase):
    """SAN attention: real edges score exp(clamp(K[src] Q[dst] E / sqrt(d),
    -5, 5)); with `full_graph`, fake (complement) pairs score Q2 K2 E2 on
    the dense grid with one shared fake-edge embedding, mixed as
    1/(gamma+1) real + gamma/(gamma+1) fake, normalized per destination."""

    def __init__(self, dim_h: int, num_heads: int, gamma: float = 1e-5,
                 full_graph: bool = True, *, generator):
        super().__init__(dim_h, num_heads, full_graph, generator=generator)
        self.gamma = gamma

    def forward(self, h, edge_attr, batch: GraphBatch):
        N, Hh = h.shape[0], self.Hh
        hd = self.D // Hh
        s, v = self._real_scores(h, edge_attr, batch)
        s = torch.exp(s.clamp(-5.0, 5.0)) * batch.edge_mask[:, None]
        if self.full_graph:
            s = s / (self.gamma + 1.0)
        recv = batch.receivers
        msg = gather_rows(v, batch.senders) * s[..., None]
        wV = segment_sum(msg.reshape(-1, Hh * hd), recv, N,
                         mask=batch.edge_mask).reshape(N, Hh, hd)
        Z = segment_sum(s, recv, N, mask=batch.edge_mask)
        if self.full_graph:
            M = dense_budget(batch, fallback=True)
            s2, fmask, grid = _fake_grid(self, h, batch, M)
            s2 = torch.exp(s2.clamp(-5.0, 5.0)) * (
                self.gamma / (self.gamma + 1.0))
            s2 = torch.where(fmask[:, None], s2, 0.0)
            dv = grid.scatter(v)
            wV2 = torch.einsum("ghmn,gmhd->gnhd", s2, dv)
            Z2 = s2.sum(2).permute(0, 2, 1)  # (G, n, Hh)
            wV = wV + grid.gather(wV2)
            Z = Z + grid.gather(Z2)
        return (wV / (Z[..., None] + 1e-6)).reshape(N, self.D)


class SAN2Attention(_SANBase):
    """SAN2 attention: real- and fake-edge scores softmax-normalized per
    destination separately, mixed with a learnable scalar gamma (init
    0.5) as 1/(gamma+1) real + gamma/(gamma+1) fake."""

    def __init__(self, dim_h: int, num_heads: int, full_graph: bool = True,
                 *, generator):
        super().__init__(dim_h, num_heads, full_graph, generator=generator)
        self.gamma = nn.Parameter(torch.tensor(0.5))

    def forward(self, h, edge_attr, batch: GraphBatch):
        N, Hh = h.shape[0], self.Hh
        hd = self.D // Hh
        s, v = self._real_scores(h, edge_attr, batch)
        attn = segment_softmax(s, batch.receivers, N, mask=batch.edge_mask)
        msg = gather_rows(v, batch.senders) * attn[..., None]
        wV = segment_sum(msg.reshape(-1, Hh * hd), batch.receivers, N,
                         mask=batch.edge_mask).reshape(N, Hh, hd)
        if self.full_graph:
            M = dense_budget(batch, fallback=True)
            s2, fmask, grid = _fake_grid(self, h, batch, M)
            fmask = fmask[:, None]
            # per-destination softmax over fake sources (axis 2); a finite
            # fill, so an empty fake set gives 0 and not NaN
            s2m = torch.where(fmask, s2, _NEG)
            mx = s2m.amax(dim=2, keepdim=True)
            mx = torch.where(mx <= _NEG, 0.0, mx)
            s2 = torch.where(fmask, torch.exp(s2m - mx), 0.0)
            s2 = s2 / (s2.sum(2, keepdim=True) + 1e-16)
            wV2 = grid.gather(torch.einsum("ghmn,gmhd->gnhd", s2,
                                           grid.scatter(v)))
            g = self.gamma
            wV = wV / (g + 1.0) + wV2 * (g / (g + 1.0))
        return wV.reshape(N, self.D)


class GatedGCNConv(nn.Module):
    """Edge-gated graph conv: e' = A x_i + B x_j + C e_ij, gate =
    sigmoid(e'), h' = U x_i + sum_j gate * V x_j / (sum_j gate + 1e-6);
    returns (h', e'). With `pe` (EquivStable), gate *= sigmoid(MLP(
    ||pe_i - pe_j||^2))."""

    def __init__(self, features: int, equivstable: bool = False, *,
                 generator):
        super().__init__()
        g, D = generator, features
        for name in ("A", "B", "C", "V", "U"):
            self.add_module(name, TorchDense(D, D, generator=g))
        if equivstable:
            self.r_mlp1 = TorchDense(1, D, generator=g)
            self.r_mlp2 = TorchDense(D, 1, generator=g)

    def forward(self, x, senders, receivers, edge_attr, edge_mask, pe=None):
        n = x.shape[0]
        send, recv = senders, receivers
        e = (self.A(gather_rows(x, recv)) + self.B(gather_rows(x, send))
             + self.C(edge_attr))
        gate = torch.sigmoid(e) * edge_mask[:, None]
        if pe is not None:
            r = ((gather_rows(pe, recv) - gather_rows(pe, send)) ** 2
                 ).sum(-1, keepdim=True)
            r = torch.sigmoid(self.r_mlp2(F.relu(self.r_mlp1(r))))
            gate = gate * r
        v = self.V(x)
        num = segment_sum(gate * gather_rows(v, send), receivers, n)
        den = segment_sum(gate, receivers, n)
        return self.U(x) + num / (den + 1e-6), e


class LinearAttention(nn.Module):
    """Masked elu+1 linear attention per graph (O(N d^2) with segment
    sums over `node_graph`)."""

    def __init__(self, dim_h: int, num_heads: int, *, generator):
        super().__init__()
        g = generator
        self.D, self.Hh = dim_h, num_heads
        for name in ("q", "k", "v", "out"):
            self.add_module(name, TorchDense(dim_h, dim_h, generator=g))

    def _feature_maps(self, h):
        n, Hh = h.shape[0], self.Hh
        hd = self.D // Hh
        q = self.q(h).reshape(n, Hh, hd)
        k = self.k(h).reshape(n, Hh, hd)
        v = self.v(h).reshape(n, Hh, hd)
        return q, k, v

    def _attend(self, qf, kf, v, batch, den_floor):
        n, Hh, m = qf.shape
        hd = v.shape[-1]
        G, ng, mask = batch.num_graphs, batch.node_graph, batch.node_mask
        kv = segment_sum((kf[:, :, :, None] * v[:, :, None, :]).reshape(n, -1),
                         ng, G, mask=mask).reshape(G, Hh, m, hd)
        ksum = segment_sum(kf.reshape(n, -1), ng, G, mask=mask).reshape(
            G, Hh, m)
        kv_n = gather_rows(kv, ng)
        ks_n = gather_rows(ksum, ng)
        num = torch.einsum("nhm,nhmd->nhd", qf, kv_n)
        den = torch.einsum("nhm,nhm->nh", qf, ks_n).clamp_min(den_floor)
        return self.out((num / den[..., None]).reshape(n, self.D))

    def forward(self, h, batch: GraphBatch):
        q, k, v = self._feature_maps(h)
        qf = F.elu(q) + 1.0
        kf = (F.elu(k) + 1.0) * batch.node_mask[:, None, None]
        return self._attend(qf, kf, v, batch, 1e-6)


def favor_projection(num_features: int, head_dim: int,
                     generator: torch.Generator) -> torch.Tensor:
    """FAVOR+'s orthogonal random features (m, hd): blocks of QR'd
    Gaussians, transposed and cut to m rows, times chi(hd)-distributed
    row norms, drawn from `generator`."""
    blocks, remaining = [], num_features
    while remaining > 0:
        g = torch.randn(head_dim, head_dim, generator=generator,
                        dtype=torch.float64)
        q, _ = torch.linalg.qr(g)
        blocks.append(q.t()[:min(remaining, head_dim)])
        remaining -= head_dim
    W = torch.cat(blocks, dim=0)
    chi = torch.randn(W.shape[0], head_dim, generator=generator,
                      dtype=torch.float64)
    return (W * chi.pow(2).sum(1).sqrt()[:, None]).to(torch.float32)


class FavorAttention(LinearAttention):
    """FAVOR+ Performer attention: phi(x) = exp(W x' - ||x'||^2 / 2 - c)
    / sqrt(m) with x' = x / d^(1/4), a per-row stabilizer c for the
    queries and one global c (a max over every node row, padding
    included) for the keys; the same per-graph sums as linear attention.
    `favor_proj` is the (m, hd) projection, a buffer."""

    def __init__(self, dim_h: int, num_heads: int, num_features: int = 64,
                 *, generator):
        super().__init__(dim_h, num_heads, generator=generator)
        self.register_buffer("favor_proj", favor_projection(
            num_features, dim_h // num_heads, generator))

    def forward(self, h, batch: GraphBatch):
        q, k, v = self._feature_maps(h)
        W = self.favor_proj
        hd = self.D // self.Hh
        scale = 1.0 / math.sqrt(math.sqrt(float(hd)))
        qs, ks = q * scale, k * scale
        wq = torch.einsum("nhd,md->nhm", qs, W)
        wk = torch.einsum("nhd,md->nhm", ks, W)

        def phi(x, wx, stab):
            sq = 0.5 * (x * x).sum(-1, keepdim=True)
            return torch.exp(wx - sq - stab) / math.sqrt(float(W.shape[0]))

        qf = phi(qs, wq, wq.amax(-1, keepdim=True))
        kf = phi(ks, wk, wk.amax()) * batch.node_mask[:, None, None]
        return self._attend(qf, kf, v, batch, 1e-9)


class FlaxLayerNorm(nn.Module):
    """flax `nn.LayerNorm`: epsilon 1e-6, the variance as E[x^2] - E[x]^2
    clamped at 0 (flax's fast variance), params `weight` (flax `scale`)
    and `bias`."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


class _Passthrough(nn.Module):
    """GINEConv's MLP slot when the MLP lives in the layer (flax keeps it
    there, as `MLP_0`)."""

    def forward(self, x, mask=None, axis=None):
        return x


class GPSLayer(nn.Module):
    def __init__(self, cfg: GPSConfig, rng: Optional[torch.Generator], *,
                 generator: torch.Generator):
        super().__init__()
        g, D = generator, cfg.dim_h
        self.cfg = cfg
        self.drop = Dropout(cfg.dropout, rng)
        if cfg.global_model == "graphormer":
            self.input_norm = FlaxLayerNorm(D)
            self.self_attn = DenseAttention(D, cfg.num_heads, True,
                                            cfg.spd_vocab, generator=g)
            self.mlp_norm = FlaxLayerNorm(D)
            self.mlp_1 = TorchDense(D, D, generator=g)
            self.mlp_2 = TorchDense(D, D, generator=g)
            return
        if cfg.use_esc:
            self.z_initial = nn.Parameter(
                torch.empty(cfg.z_dim, D).normal_(0.0, 1.0, generator=g))
            self.z_embedding = MLP(D, (D,), F.elu, pre_act=True,
                                   dropout=cfg.dropout, rng=rng, generator=g)
        if cfg.local_model == "gatedgcn":
            self.local_gatedgcn = GatedGCNConv(
                D, equivstable=cfg.use_equivstable_pe, generator=g)
        elif cfg.local_model == "pna":
            self.local_pna = PNAConv(D, D, towers=cfg.pna_towers,
                                     avg_deg_log=cfg.avg_deg_log, edge_dim=D,
                                     generator=g)
        else:
            self.MLP_0 = MLP(D, (D, D), F.relu, dropout=cfg.dropout, rng=rng,
                             generator=g)
            self.local_gine = GINEConv(D, _Passthrough(), edge_dim=D,
                                       generator=g)
        self.norm1_local = MaskedBatchNorm(D)
        gm, Hh = cfg.global_model, cfg.num_heads
        if gm == "linear":
            self.self_attn = LinearAttention(D, Hh, generator=g)
        elif gm == "performer":
            self.self_attn = FavorAttention(D, Hh, cfg.performer_features,
                                            generator=g)
        elif gm == "san2":
            self.self_attn = SAN2Attention(D, Hh, cfg.san_full_graph,
                                           generator=g)
        elif gm == "san":
            self.self_attn = SANAttention(D, Hh, cfg.san_gamma,
                                          cfg.san_full_graph, generator=g)
        else:
            self.self_attn = DenseAttention(
                D, Hh, cfg.use_attn_bias, cfg.spd_vocab,
                pattern="bigbird" if gm == "bigbird" else "full",
                window=cfg.bigbird_window, num_global=cfg.bigbird_global,
                num_random=cfg.bigbird_random, generator=g)
        self.norm1_attn = MaskedBatchNorm(D)
        self.ff_linear1 = TorchDense(D, 2 * D, generator=g)
        self.ff_linear2 = TorchDense(2 * D, D, generator=g)
        self.norm2 = MaskedBatchNorm(D)

    def _graphormer(self, h, edge_attr, batch):
        x = self.self_attn(self.input_norm(h), batch)
        x = self.drop(x) + h
        ff = F.gelu(self.mlp_1(self.mlp_norm(x)), approximate="tanh")
        ff = self.drop(self.mlp_2(self.drop(ff)))
        return x + ff, edge_attr

    def _z(self, batch):
        """The layer's ESC edge embedding (E, D): on the dedup layout at
        dropout 0 the z MLP runs on the unique rows (multiplicity-weighted
        BN) and one expansion takes them to the edges (K1 in its
        backward); else per edge."""
        u = (zemb_unique_rows(self.z_initial, batch)
             if self.cfg.dropout == 0.0 else None)
        if u is not None and batch.enc_row_weight is not None:
            return expand_rows(self.z_embedding(u, batch.enc_row_weight),
                               batch)
        return self.z_embedding(zemb_from_batch(self.z_initial, batch),
                                batch.edge_mask)

    def forward(self, h, edge_attr, batch: GraphBatch):
        cfg = self.cfg
        if cfg.global_model == "graphormer":
            return self._graphormer(h, edge_attr, batch)
        if cfg.use_esc and (batch.enc_idx is not None
                            or batch.enc_flat_idx is not None):
            edge_attr = edge_attr + self._z(batch)
        if cfg.local_model == "gatedgcn":
            pe = ((batch.extras or {}).get("equivstable_pe")
                  if cfg.use_equivstable_pe else None)
            if cfg.use_equivstable_pe and pe is None:
                raise ValueError("use_equivstable_pe needs the encoded "
                                 "lap_pe (GPSModel attaches it)")
            h_local, edge_attr = self.local_gatedgcn(
                h, batch.senders, batch.receivers, edge_attr,
                batch.edge_mask, pe=pe)
        elif cfg.local_model == "pna":
            h_local = self.local_pna(h, batch.senders, batch.receivers,
                                     batch.edge_mask, edge_attr)
        else:
            agg = self.local_gine(h, batch.senders, batch.receivers,
                                  edge_attr, batch.edge_mask,
                                  uniform_nodes=batch.nodes_per_graph)
            h_local = self.MLP_0(agg, batch.node_mask)
        h_local = self.norm1_local(h + self.drop(h_local), batch.node_mask)
        if cfg.global_model in ("san", "san2"):
            h_attn = self.self_attn(h, edge_attr, batch)
        else:
            h_attn = self.self_attn(h, batch)
        h_attn = self.norm1_attn(h + self.drop(h_attn), batch.node_mask)
        h = h_local + h_attn
        ff = self.drop(F.relu(self.ff_linear1(h)))
        h = h + self.drop(self.ff_linear2(ff))
        return self.norm2(h, batch.node_mask), edge_attr


class GPSModel(nn.Module):
    """Encoders -> GPS layers -> head. `node_dim` / `edge_dim`: the columns
    of the float node / edge features a linear encoder reads; `lap_k` and
    `rwse_k`: the widths of the LapPE and RWSE extras the encoders read.
    Parameters are drawn on the CPU from `generator` (seed 0 when None)
    and moved to `device`; dropout draws from `rng`, a generator on
    `device` seeded with `rng_seed`."""

    def __init__(self, cfg: GPSConfig, node_dim: int = 1, edge_dim: int = 1,
                 lap_k: int = 8, rwse_k: int = 16, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 rng_seed: int = 0):
        super().__init__()
        _check_config(cfg)
        device = resolve_device(device)
        g = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        D = cfg.dim_h
        self.cfg = cfg
        self.rng = torch.Generator(device=device).manual_seed(rng_seed)
        kind = cfg.node_encoder_kind
        if kind == "linear":
            self.node_encoder = TorchDense(node_dim, D, generator=g)
        elif kind == "ppa_uniform":
            self.node_const = nn.Parameter(
                torch.empty(D).normal_(0.0, 1.0, generator=g))
        elif kind == "ast":
            self.ast_type_encoder = TorchEmbed(cfg.ast_type_vocab, D,
                                               generator=g)
            self.ast_depth_encoder = TorchEmbed(cfg.ast_depth_vocab, D,
                                                generator=g)
        elif kind == "ogb_atom":
            self.node_encoder = FeatureSumEncoder(ATOM_FEATURE_DIMS, D,
                                                  generator=g)
        else:
            self.node_encoder = TorchEmbed(cfg.node_vocab, D, generator=g)
        if cfg.use_lap_pe:
            self.lap_pe_encoder = TorchDense(2 * lap_k, D, generator=g)
        if cfg.use_signnet:
            F_ = cfg.signnet_phi_dim
            self.signnet_phi1 = TorchDense(2, F_, generator=g)
            self.signnet_phi2 = TorchDense(F_, F_, generator=g)
            self.signnet_rho = TorchDense(lap_k * F_, D, generator=g)
        if cfg.use_rwse:
            self.rwse_encoder = TorchDense(rwse_k, D, generator=g)
        if cfg.use_degree:
            self.degree_encoder = TorchEmbed(cfg.degree_vocab, D, generator=g)
            with torch.no_grad():
                self.degree_encoder.weight.normal_(0.0, 0.02, generator=g)
        if cfg.use_equivstable_pe:
            self.equivstable_pe_encoder = TorchDense(lap_k, D, generator=g)
        ekind = cfg.edge_encoder_kind
        if ekind == "none":
            self.edge_const = nn.Parameter(
                torch.empty(D).normal_(0.0, 1.0, generator=g))
        elif ekind == "linear":
            self.edge_encoder = TorchDense(edge_dim, D, generator=g)
        elif ekind == "ogb_bond":
            self.edge_encoder = FeatureSumEncoder(BOND_FEATURE_DIMS, D,
                                                  generator=g)
        else:
            self.edge_encoder = TorchEmbed(cfg.edge_vocab, D, generator=g)
        rng = self.rng if cfg.dropout > 0 else None
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", GPSLayer(cfg, rng, generator=g))
        if cfg.head == "inductive_edge":
            self.head1 = TorchDense(D, D, generator=g)
            self.head2 = TorchDense(D, D, generator=g)
        else:
            self.head1 = TorchDense(D, D // 2, generator=g)
            self.head2 = TorchDense(D // 2, cfg.out_dim, generator=g)
        self.to(device)

    def generators(self) -> list:
        """The generators a train-mode forward draws from."""
        return [self.rng] if self.cfg.dropout > 0 else []

    def _encode(self, batch: GraphBatch):
        """(node states, edge features, the batch with the EquivStable PE
        attached) before layer 0."""
        cfg = self.cfg
        D, N = cfg.dim_h, batch.num_nodes
        kind = cfg.node_encoder_kind
        if kind == "linear":
            h = self.node_encoder(batch.x.to(torch.float32))
        elif kind == "ppa_uniform":
            h = self.node_const.expand(N, D)
        elif kind == "ast":
            xi = batch.x.long()
            h = self.ast_type_encoder(xi[:, 0]) + self.ast_depth_encoder(
                xi[:, 1].clamp(0, cfg.ast_depth_vocab - 1))
        elif kind == "ogb_atom":
            h = self.node_encoder(batch.x)
        else:
            h = self.node_encoder(batch.x.long().reshape(N))
        ex = batch.extras or {}
        if cfg.use_lap_pe:
            pe = ex["lap_pe"].to(torch.float32)
            h = h + self.lap_pe_encoder(torch.cat([pe, pe.abs()], dim=-1))
        if cfg.use_signnet:
            pe = ex["lap_pe"].to(torch.float32)
            ev = ex["lap_eigvals"].to(torch.float32)

            def phi(v):
                z = torch.stack([v, ev], dim=-1)  # (N, K, 2)
                return self.signnet_phi2(F.relu(self.signnet_phi1(z)))

            z = phi(pe) + phi(-pe)
            h = h + self.signnet_rho(z.reshape(N, -1))
        if cfg.use_rwse:
            h = h + self.rwse_encoder(ex["rwse"].to(torch.float32))
        if cfg.use_degree:
            h = h + self.degree_encoder(ex["degree"].long().reshape(-1))
        if cfg.use_equivstable_pe:
            es = self.equivstable_pe_encoder(ex["lap_pe"].to(torch.float32))
            batch = dataclasses.replace(batch,
                                        extras={**ex, "equivstable_pe": es})
        ekind, E = cfg.edge_encoder_kind, batch.num_edges
        if ekind == "none":
            edge_attr = self.edge_const.expand(E, D)
        elif ekind == "linear":
            edge_attr = self.edge_encoder(batch.edge_attr.to(torch.float32))
        elif ekind == "ogb_bond":
            edge_attr = self.edge_encoder(batch.edge_attr)
        else:
            edge_attr = self.edge_encoder(
                batch.edge_attr.long().reshape(E))
        return h, edge_attr, batch

    def dense_attentions(self) -> dict:
        """{dump name: module} of every dense attention, in layer order;
        the names are JAX's attention-dump keys."""
        return {f"layer{i}/self_attn": getattr(self, f"layer{i}").self_attn
                for i in range(self.cfg.num_layers)
                if isinstance(getattr(self, f"layer{i}").self_attn,
                              DenseAttention)}

    def forward(self, batch: GraphBatch, return_attention: bool = False):
        attns = self.dense_attentions() if return_attention else {}
        for m in attns.values():
            m.capture = True
        try:
            out = self._forward(batch)
        finally:
            for m in attns.values():
                m.capture = False
        if not return_attention:
            return out
        weights = {k: m.last_attn for k, m in attns.items()}
        for m in attns.values():
            m.last_attn = None
        return out, weights

    def _forward(self, batch: GraphBatch):
        cfg = self.cfg
        h, edge_attr, batch = self._encode(batch)
        for i in range(cfg.num_layers):
            h, edge_attr = getattr(self, f"layer{i}")(h, edge_attr, batch)
        if cfg.head == "inductive_edge":
            return self.head2(F.relu(self.head1(h)))
        g = (pool_nodes_to_graphs(h, batch, reduce="sum" if cfg.pool == "add"
                                  else "mean")
             if cfg.graph_pred else h)
        return self.head2(F.relu(self.head1(g)))
