"""OGB molecule models: the GNN / GNN_node_efficient family (counterpart
of `escgnn_tpu/models/ogb_gnn.py`).

  * `FeatureSumEncoder`: the sum of one embedding table per categorical
    feature column (OGB's Atom/Bond encoders) as ONE indicator matmul:
    column ids offset into the concatenated vocabulary, the (N, V)
    indicator built by a broadcast compare (no `F.one_hot`, which checks
    the ids' range with a device -> host copy), times the stacked tables.
  * `GINConvEff`: GIN conv whose edge embedding is the bond encoding (or a
    linear encoder on ogbg-ppa's 7 float edge features) plus a linear map
    of the shared structural embedding z_emb.
  * `GNNNodeEfficient`: z_emb shared across layers, a virtual node
    broadcast to every node and updated from the add-pooled nodes, BN,
    dropout (no ReLU on the last layer), residual, JK last/sum, random
    node initialisation, random-walk return probabilities.
  * `OgbGNN`: subgraph pooling over two-level copy batches (sum, mean,
    max, attention, center, combine; the virtual node then reaches only
    each copy's root under center pooling), graph pooling (sum, mean,
    max, attention, combine, set2set, sort) and the prediction head.

The structural embedding: with dropout 0 on the dedup layout the z MLP
runs on the R unique rows with multiplicity-weighted BN and is expanded
to edges; with dropout > 0 the rows are expanded first and the z MLP
runs on the E edges (dropout would correlate edges that share a row).
K1 is the backward of the expansion either way.

Dropout and random node initialisation draw from the model's generator
`rng` (seeded with `rng_seed`) in `train()` only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.models.layers import (
    MLP,
    Dropout,
    MaskedBatchNorm,
    TorchDense,
    _dense_local_aggregate,
)
from escgnn_tpu_torch.models.ngnn import copy_roots
from escgnn_tpu_torch.models.pooling import Set2Set, global_sort_pool
from escgnn_tpu_torch.ops.segment import (
    gather_rows,
    masked_ids,
    pool_nodes_to_graphs,
    segment_max,
    segment_mean,
    segment_min,
    segment_softmax,
    segment_sum,
)
from escgnn_tpu_torch.ops.zemb import (
    expand_rows,
    zemb_from_batch,
    zemb_unique_rows,
)

# OGB categorical vocab sizes (ogb.utils.features get_atom/bond_feature_dims)
ATOM_FEATURE_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
BOND_FEATURE_DIMS = (5, 6, 2)
PPA_EDGE_DIM = 7
POOLINGS = ("sum", "mean", "max", "attention", "combine", "set2set", "sort")
SUBGRAPH_POOLINGS = ("sum", "mean", "max", "attention", "center", "combine")


class FeatureSumEncoder(nn.Module):
    """Sum of per-column embedding tables `emb_<i>` (xavier-uniform, as
    OGB's encoders), computed as C @ concat(tables) with C the (N, V)
    count of each global id per row."""

    def __init__(self, vocab_sizes: Sequence[int], emb_dim: int, *,
                 generator: torch.Generator):
        super().__init__()
        for i, vocab in enumerate(vocab_sizes):
            bound = float(np.sqrt(6.0 / (vocab + emb_dim)))
            self.register_parameter(f"emb_{i}", nn.Parameter(
                torch.empty(vocab, emb_dim).uniform_(-bound, bound,
                                                     generator=generator)))
        self.num_tables = len(vocab_sizes)
        self.register_buffer("offsets", torch.tensor(
            np.concatenate([[0], np.cumsum(vocab_sizes[:-1])]),
            dtype=torch.long), persistent=False)
        self.register_buffer("vocab", torch.arange(int(np.sum(vocab_sizes))),
                             persistent=False)

    def forward(self, feats):
        stacked = torch.cat([getattr(self, f"emb_{i}")
                             for i in range(self.num_tables)], dim=0)
        ids = feats.long() + self.offsets
        C = (ids[:, :, None] == self.vocab).to(stacked.dtype).sum(1)
        return C @ stacked


class GINConvEff(nn.Module):
    """GIN conv with bond (or ppa float) + structural edge embeddings:
        h = mlp((1 + eps) x + sum_{j->i} relu(x_j + e_ji)),
    mlp = Linear(d, 2d) -> BN -> ReLU -> Linear(2d, d). On the uniform
    per-graph layout the aggregation is the per-graph one-hot einsum in
    x's dtype, else a masked segment sum."""

    def __init__(self, emb_dim: int, float_edge_attr: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.eps = nn.Parameter(torch.zeros(()))
        self.edge_encoder = (
            TorchDense(PPA_EDGE_DIM, emb_dim, generator=g) if float_edge_attr
            else FeatureSumEncoder(BOND_FEATURE_DIMS, emb_dim, generator=g))
        self.edge_encoder_pos = TorchDense(emb_dim, emb_dim, generator=g)
        self.mlp_0 = TorchDense(emb_dim, 2 * emb_dim, generator=g)
        self.mlp_bn = MaskedBatchNorm(2 * emb_dim)
        self.mlp_1 = TorchDense(2 * emb_dim, emb_dim, generator=g)

    def forward(self, x, batch: GraphBatch, z_emb,
                uniform_nodes: Optional[int]):
        ea = batch.edge_attr
        if isinstance(self.edge_encoder, TorchDense):
            ea = ea.to(torch.float32)
        e = self.edge_encoder(ea) + self.edge_encoder_pos(z_emb)
        if uniform_nodes is not None:
            agg = _dense_local_aggregate(
                x, batch.senders, batch.receivers, e.to(x.dtype),
                batch.edge_mask, uniform_nodes)
        else:
            msg = F.relu(gather_rows(x, batch.senders) + e)
            agg = segment_sum(msg, batch.receivers, x.shape[0],
                              batch.edge_mask)
        # JAX promotes a bf16 x times the f32 eps to f32 (a 0-d tensor does
        # not promote in torch, so the casts are written out)
        h = (1.0 + self.eps) * x.float() + agg.float()
        h = F.relu(self.mlp_bn(self.mlp_0(h), batch.node_mask))
        return self.mlp_1(h)


@dataclasses.dataclass(frozen=True)
class OgbGNNConfig:
    num_tasks: int = 1
    num_layers: int = 5
    emb_dim: int = 300
    dropout: float = 0.5
    virtual_node: bool = True
    residual: bool = False
    jk: str = "last"  # last | sum
    # sum | mean | max | attention | combine | set2set | sort
    graph_pooling: str = "mean"
    # applied between node and graph level when the batch carries
    # subgraph-copy segments (node_segment / segment_graph):
    # sum | mean | max | attention | center | combine
    subgraph_pooling: str = "mean"
    sort_k: int = 20
    z_dim: int = 1800
    # random node initialisation: h0 += U(-1, 1), in train() only
    rni: bool = False
    # feed the raw batch.x (float, emb_dim wide) as h0: no node encoder
    skip_node_encoder: bool = False
    # float32 | bfloat16 conv inputs (f32 params, BN statistics and head)
    compute_dtype: str = "float32"
    # ogbg-ppa: one learned node row and a linear encoder on the 7 float
    # edge features
    ppa_encoders: bool = False
    # random-walk return probabilities: the first `use_rp` columns of
    # extras['rp'], projected and added to h0 (0 = off)
    use_rp: int = 0


def _check_config(cfg: OgbGNNConfig) -> None:
    if cfg.graph_pooling not in POOLINGS:
        raise ValueError(f"graph_pooling {cfg.graph_pooling!r}: one of "
                         f"{POOLINGS}")
    if cfg.subgraph_pooling not in SUBGRAPH_POOLINGS:
        raise ValueError(f"subgraph_pooling {cfg.subgraph_pooling!r}: one "
                         f"of {SUBGRAPH_POOLINGS}")
    if cfg.jk not in ("last", "sum"):
        raise ValueError(f"jk {cfg.jk!r}: last or sum")
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(cfg.compute_dtype)


class GNNNodeEfficient(nn.Module):
    """Node embeddings (N, emb_dim) of the efficient OGB GNN."""

    def __init__(self, cfg: OgbGNNConfig, rng: torch.Generator, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        d = cfg.emb_dim
        self.cfg = cfg
        self.rng = rng
        if cfg.ppa_encoders:
            self.node_const = nn.Parameter(
                torch.empty(d).normal_(0.0, 1.0, generator=g))
        elif not cfg.skip_node_encoder:
            self.node_encoder = FeatureSumEncoder(ATOM_FEATURE_DIMS, d,
                                                  generator=g)
        if cfg.use_rp:
            self.rp_projection = TorchDense(cfg.use_rp, d, generator=g)
        self.z_initial = nn.Parameter(
            torch.empty(cfg.z_dim, d).normal_(0.0, 1.0, generator=g))
        self.z_embedding = MLP(d, (d,), F.relu, pre_act=True,
                               dropout=cfg.dropout, rng=rng, generator=g)
        if cfg.virtual_node:
            self.virtualnode_embedding = nn.Parameter(torch.zeros(d))
        self.drop = Dropout(cfg.dropout, rng)
        for layer in range(cfg.num_layers):
            self.add_module(f"conv{layer}", GINConvEff(
                d, float_edge_attr=cfg.ppa_encoders, generator=g))
            self.add_module(f"batch_norm{layer}", MaskedBatchNorm(d))
            if cfg.virtual_node and layer < cfg.num_layers - 1:
                self.add_module(f"mlp_virtualnode_{layer}", MLP(
                    d, (2 * d, d), F.relu, generator=g))

    def forward(self, batch: GraphBatch, perturb=None):
        cfg = self.cfg
        d, N, G = cfg.emb_dim, batch.num_nodes, batch.num_graphs
        node_mask, edge_mask = batch.node_mask, batch.edge_mask

        if cfg.ppa_encoders:
            h = self.node_const.expand(N, d)
        elif cfg.skip_node_encoder:
            h = batch.x.to(torch.float32)
        else:
            h = self.node_encoder(batch.x)
        if cfg.use_rp:
            rp = (batch.extras or {}).get("rp")
            if rp is None:
                raise ValueError("use_rp is set but the batch carries no "
                                 "extras['rp']")
            h = h + self.rp_projection(rp.to(torch.float32)[:, :cfg.use_rp])
        if cfg.rni and self.training:
            h = h + (torch.rand(h.shape, generator=self.rng,
                                device=h.device, dtype=h.dtype) * 2.0 - 1.0)
        if perturb is not None:
            # FLAG's adversarial input perturbation: added to h0, so its
            # gradient can drive an ascent step
            h = h + perturb

        u = (zemb_unique_rows(self.z_initial, batch) if cfg.dropout == 0.0
             else None)
        if u is not None and batch.enc_row_weight is not None:
            z_emb = expand_rows(self.z_embedding(u, batch.enc_row_weight),
                                batch)
        else:
            z_emb = self.z_embedding(zemb_from_batch(self.z_initial, batch),
                                     edge_mask)

        if cfg.virtual_node:
            vn = torch.zeros(G, d, dtype=h.dtype, device=h.device) \
                + self.virtualnode_embedding
        two_level = batch.node_segment is not None
        # with center subgraph pooling on a two-level batch the virtual
        # node reaches only each copy's root
        center_vn = (cfg.virtual_node and cfg.subgraph_pooling == "center"
                     and two_level)
        if center_vn:
            is_root = copy_roots(node_mask, batch.node_segment,
                                 batch.segment_mask.shape[0])[1]
        cdt = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
               else torch.float32)
        n_u = None if two_level else batch.nodes_per_graph
        z_c = z_emb.to(cdt)
        h_list = [h]
        for layer in range(cfg.num_layers):
            hcur = h_list[layer]
            if cfg.virtual_node:
                if n_u is not None and N == G * n_u:
                    # uniform blocks: the broadcast is a reshape
                    vn_nodes = vn[:, None, :].expand(G, n_u, d).reshape(N, d)
                else:
                    vn_nodes = gather_rows(vn, batch.node_graph)
                if center_vn:
                    vn_nodes = torch.where(is_root[:, None], vn_nodes, 0.0)
                hcur = hcur + vn_nodes
                h_list[layer] = hcur
            h = getattr(self, f"conv{layer}")(hcur.to(cdt), batch, z_c, n_u)
            h = getattr(self, f"batch_norm{layer}")(h, node_mask)
            h = self.drop(h if layer == cfg.num_layers - 1 else F.relu(h))
            if cfg.residual:
                h = h + h_list[layer]
            h_list.append(h)
            if cfg.virtual_node and layer < cfg.num_layers - 1:
                vn_tmp = pool_nodes_to_graphs(h_list[layer], batch,
                                              reduce="sum") + vn
                vn_new = self.drop(getattr(self, f"mlp_virtualnode_{layer}")(
                    vn_tmp, batch.graph_mask))
                vn = vn + vn_new if cfg.residual else vn_new

        if cfg.jk == "last":
            return h_list[-1]
        return sum(h_list[:cfg.num_layers])


def _std_pool(h, ids, G, mask):
    mean = segment_mean(h, ids, G, mask=mask)
    sq = segment_mean(h * h, ids, G, mask=mask)
    return torch.sqrt((sq - mean * mean).clamp_min(0.0) + 1e-5)


class OgbGNN(nn.Module):
    """Node embeddings -> graph pooling -> prediction head. Parameters are
    drawn on the CPU from `generator` (seed 0 when None) and moved to
    `device`; dropout and `rni` draw from `rng`, a generator on `device`
    seeded with `rng_seed`."""

    def __init__(self, cfg: OgbGNNConfig, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 rng_seed: int = 0):
        super().__init__()
        _check_config(cfg)
        device = resolve_device(device)
        g = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        d = cfg.emb_dim
        self.cfg = cfg
        self.rng = torch.Generator(device=device).manual_seed(rng_seed)
        self.gnn_node = GNNNodeEfficient(cfg, self.rng, generator=g)
        head_in = d
        if cfg.subgraph_pooling == "attention":
            self.sub_gate_0 = TorchDense(d, 2 * d, generator=g)
            self.sub_gate_bn = MaskedBatchNorm(2 * d)
            self.sub_gate_1 = TorchDense(2 * d, 1, generator=g)
        elif cfg.subgraph_pooling == "combine":
            self.sub_nn_0 = TorchDense(15 * d, d, generator=g)
            self.sub_nn_1 = TorchDense(d, d, generator=g)
        if cfg.graph_pooling == "attention":
            self.gate_0 = TorchDense(d, 2 * d, generator=g)
            self.gate_bn = MaskedBatchNorm(2 * d)
            self.gate_1 = TorchDense(2 * d, 1, generator=g)
        elif cfg.graph_pooling == "combine":
            self.graph_nn_0 = TorchDense(12 * d, d, generator=g)
            self.graph_nn_1 = TorchDense(d, d, generator=g)
        elif cfg.graph_pooling == "set2set":
            self.set2set = Set2Set(d, processing_steps=2, generator=g)
            head_in = 2 * d
        elif cfg.graph_pooling == "sort":
            k = cfg.sort_k
            self.conv1d_params1 = TorchDense(d, 16, generator=g)
            self.conv1d_params2 = nn.Conv1d(16, 32, 5)
            bound = 1.0 / float(np.sqrt(16 * 5))
            with torch.no_grad():
                self.conv1d_params2.weight.uniform_(-bound, bound,
                                                    generator=g)
                self.conv1d_params2.bias.uniform_(-bound, bound, generator=g)
            head_in = (k // 2 - 4) * 32
        self.graph_pred_linear = TorchDense(head_in, cfg.num_tasks,
                                            generator=g)
        self.to(device)

    def generators(self) -> list:
        """The generators a train-mode forward draws from."""
        return ([self.rng] if self.cfg.dropout > 0 or self.cfg.rni
                else [])

    def _subpool(self, h, batch: GraphBatch):
        """Node -> subgraph-copy pooling (sum, mean, max, the copy's root,
        attention, or combine: [mean, max, min, std, root] x [identity,
        amplification, attenuation] through sub_nn)."""
        cfg = self.cfg
        mask = batch.node_mask
        ids = masked_ids(batch.node_segment, mask)
        S = batch.segment_mask.shape[0]
        pool = cfg.subgraph_pooling

        def center(x):
            return x[copy_roots(mask, batch.node_segment, S)[0]]

        if pool == "sum":
            return segment_sum(h, ids, S, mask=mask)
        if pool == "mean":
            return segment_mean(h, ids, S, mask=mask)
        if pool == "max":
            return segment_max(h, ids, S, mask=mask)
        if pool == "center":
            return center(h)
        if pool == "attention":
            gate = self.sub_gate_bn(self.sub_gate_0(h), mask)
            gate = self.sub_gate_1(F.relu(gate))[:, 0]
            w = segment_softmax(gate, ids, S, mask=mask)
            return segment_sum(h * w[:, None], ids, S, mask=mask)
        agg = torch.cat([segment_mean(h, ids, S, mask=mask),
                         segment_max(h, ids, S, mask=mask),
                         segment_min(h, ids, S, mask=mask),
                         _std_pool(h, ids, S, mask), center(h)], dim=-1)
        deg = segment_sum(mask.to(h.dtype), ids, S)[:, None]
        logd = torch.log(deg + 1.0)
        avg_logd = (logd * deg).sum() / deg.sum().clamp_min(1.0)
        g = torch.cat([agg, agg * logd / avg_logd,
                       agg * avg_logd / (logd + 1e-6)], dim=-1)
        return F.relu(self.sub_nn_1(F.relu(self.sub_nn_0(g))))

    def forward(self, batch: GraphBatch, perturb=None):
        """Graph logits (G, num_tasks); `perturb` (N, emb_dim), FLAG's
        input hook, is added to the node state h0."""
        cfg = self.cfg
        h = self.gnn_node(batch, perturb)
        ids, G, mask = batch.node_graph, batch.num_graphs, batch.node_mask
        two_level = batch.node_segment is not None
        if two_level:
            # two-level (copy) batch: subgraph pooling first, then the
            # graph pooling below runs over the copy rows
            h = self._subpool(h, batch)
            mask = batch.segment_mask
            ids = masked_ids(batch.segment_graph, mask)
        pool = cfg.graph_pooling
        if pool in ("sum", "mean") and two_level:
            fn = segment_sum if pool == "sum" else segment_mean
            g = fn(h, ids, G, mask=mask)
        elif pool in ("sum", "mean"):
            g = pool_nodes_to_graphs(h, batch, reduce=pool)
        elif pool == "max":
            g = segment_max(h, ids, G, mask=mask)
        elif pool == "attention":
            gate = self.gate_bn(self.gate_0(h), mask)
            gate = self.gate_1(F.relu(gate))[:, 0]
            w = segment_softmax(gate, ids, G, mask=mask)
            g = segment_sum(h * w[:, None], ids, G, mask=mask)
        elif pool == "combine":
            # PNA-style [mean, max, min, std] x [identity, amplification,
            # attenuation]
            agg = torch.cat([segment_mean(h, ids, G, mask=mask),
                             segment_max(h, ids, G, mask=mask),
                             segment_min(h, ids, G, mask=mask),
                             _std_pool(h, ids, G, mask)], dim=-1)
            deg = segment_sum(mask.to(h.dtype), ids, G)[:, None]
            logd = torch.log(deg + 1.0)
            avg_logd = (logd * deg).sum() / deg.sum().clamp_min(1.0)
            g = torch.cat([agg, agg * logd / avg_logd,
                           agg * avg_logd / (logd + 1e-6)], dim=-1)
            g = F.relu(self.graph_nn_1(F.relu(self.graph_nn_0(g))))
        elif pool == "set2set":
            g = self.set2set(h, batch, ids=ids, mask=mask)
        elif two_level:
            raise ValueError("graph_pooling='sort' supports flat batches "
                             "only")
        else:  # sort: top-k rows -> per-slot dense -> MaxPool1d(2, 2) ->
            # Conv1d(16, 32, 5) -> flatten
            k = cfg.sort_k
            m = max(-(-h.shape[0] // max(G, 1)), k)
            z = global_sort_pool(h, batch, k, m).reshape(G, k, cfg.emb_dim)
            c = F.relu(self.conv1d_params1(z))
            c = c[:, :2 * (k // 2)].reshape(G, k // 2, 2, 16).amax(2)
            c = F.relu(self.conv1d_params2(c.transpose(1, 2)))
            g = c.transpose(1, 2).reshape(G, -1)
        return self.graph_pred_linear(g)
