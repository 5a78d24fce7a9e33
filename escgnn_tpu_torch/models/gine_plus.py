"""GINE+: multihop GIN with per-distance history mixing (counterpart of
`escgnn_tpu/models/gine_plus.py`).

  * `GINEPlusConv`: h = (1 + eps[0]) x_now + sum_{d=1..k} (1 + eps[d])
    sum_{(j -> i), dist = d} relu(x^{(d-1 ago)}_j [+ bond_emb if d = 1]),
    then MLP(dim -> 2 dim -> BN -> ReLU -> dim). The message at distance
    d reads the node state from d - 1 layers back: the per-edge source row
    is gathered from the stacked (k, N, F) history by (distance - 1,
    sender), and the (1 + eps[d]) scale rides on the message.
  * `GINEPlusNetwork`: AtomEncoder (or an `EmbedMM` of one type id) input,
    `num_layers` blocks with k_i = min(i + 1, k) (virtual-node broadcast
    into the newest state, conv, BN, ReLU but on the last layer, dropout,
    the virtual node's add-pool + two MLP/BN/ReLU stages and dropout),
    optional nested subgraph pooling (sum, or mean for every other value,
    as JAX pools it), mean graph pooling and a Linear head.

The multihop edge list (`featurize/multihop.py`) is one padded edge set
with an `edge_distance` extra, so every hop's messages flow in one gather
and one scatter: on the uniform per-graph layout (`batch.nodes_per_graph`)
the scatter is the per-graph one-hot product of `_dense_local_scatter`,
else a masked segment sum. Under `compute_dtype="bfloat16"` the history,
the bond embedding, the messages and the aggregation run in bf16, the
rest in f32, as JAX's promotions make it. Dropout draws from the model's
generator `rng` (seeded with `rng_seed`) in `train()` only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.models.layers import (
    Dropout,
    EmbedMM,
    MaskedBatchNorm,
    TorchDense,
    _dense_local_scatter,
)
from escgnn_tpu_torch.models.ngnn import _dtype
from escgnn_tpu_torch.models.ogb_gnn import (
    ATOM_FEATURE_DIMS,
    BOND_FEATURE_DIMS,
    FeatureSumEncoder,
)
from escgnn_tpu_torch.ops.segment import masked_ids, segment_mean, segment_sum


class GINEPlusConv(nn.Module):
    """One GINE+ propagation over the multihop edge list; `xx` is the
    history, newest first, and `k` distances are mixed (k <= len(xx))."""

    def __init__(self, features: int, k: int,
                 compute_dtype: str = "float32", *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.k = k
        self.cdt = _dtype(compute_dtype)
        self.eps = nn.Parameter(torch.zeros(k + 1, features))
        self.mlp_0 = TorchDense(features, 2 * features, generator=g)
        self.mlp_bn = MaskedBatchNorm(2 * features)
        self.mlp_1 = TorchDense(2 * features, features, generator=g)

    def forward(self, xx, batch: GraphBatch, distance, bond_emb):
        k = self.k
        n = xx[0].shape[0]
        hist = torch.stack(xx[:k], dim=0)
        d = distance.long().reshape(-1)
        valid = batch.edge_mask & (d >= 1) & (d <= k)
        dd = (d - 1).clamp(0, k - 1)
        if self.cdt != torch.float32:
            hist, bond_emb = hist.to(self.cdt), bond_emb.to(self.cdt)
        x_src = hist.reshape(k * n, -1).index_select(
            0, dd * n + batch.senders.long())
        msg = x_src + torch.where((d == 1)[:, None], bond_emb,
                                  torch.zeros((), dtype=bond_emb.dtype,
                                              device=bond_emb.device))
        # (1 + eps[d]) per edge as a one-hot product: indexing eps by
        # the edges' distance would make its backward an index_put_ of
        # E rows into k + 1, which CUDA sorts and serializes
        onehot = (d.clamp(0, k)[:, None] == torch.arange(
            k + 1, device=d.device)).to(self.eps.dtype)
        msg = F.relu(msg) * (onehot @ (1.0 + self.eps)).to(msg.dtype)
        if batch.nodes_per_graph is not None:
            agg = _dense_local_scatter(msg, batch.receivers, valid,
                                       batch.nodes_per_graph, n)
        else:
            agg = segment_sum(msg, batch.receivers, n, valid)
        h = (1.0 + self.eps[0]).to(agg.dtype) * xx[0].to(agg.dtype) + agg
        h = F.relu(self.mlp_bn(self.mlp_0(h), batch.node_mask))
        return self.mlp_1(h)


@dataclasses.dataclass(frozen=True)
class GINEPlusConfig:
    hidden: int = 100
    out_dim: int = 128
    num_layers: int = 3
    dropout: float = 0.5
    k: int = 4
    virtual_node: bool = False
    nested: bool = False  # pool node -> subgraph before graph pooling
    subgraph_pooling: str = "mean"  # sum; every other value pools a mean
    atom_encoder: bool = True  # OGB AtomEncoder; else EmbedMM(node_vocab)
    node_vocab: int = 32
    compute_dtype: str = "float32"  # bfloat16 conv stacks


class GINEPlusNetwork(nn.Module):
    """Reads `x` (9 OGB atom features, or one type id per node without
    the atom encoder), `edge_attr` (3 OGB bond features) and
    `extras['edge_distance']`."""

    def __init__(self, cfg: GINEPlusConfig, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 rng_seed: int = 0):
        super().__init__()
        _dtype(cfg.compute_dtype)
        device = resolve_device(device)
        g = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        self.cfg = cfg
        H = cfg.hidden
        self.rng = torch.Generator(device=device).manual_seed(rng_seed)
        self.drop = Dropout(cfg.dropout, self.rng)
        if cfg.atom_encoder:
            self.atom_encoder = FeatureSumEncoder(ATOM_FEATURE_DIMS, H,
                                                  generator=g)
        else:
            self.node_embed = EmbedMM(cfg.node_vocab, H, generator=g)
        if cfg.virtual_node:
            self.v0 = nn.Parameter(torch.zeros(H))
        for layer in range(cfg.num_layers):
            self.add_module(f"bond_encoder_{layer}", FeatureSumEncoder(
                BOND_FEATURE_DIMS, H, generator=g))
            self.add_module(f"conv{layer}", GINEPlusConv(
                H, min(layer + 1, cfg.k), cfg.compute_dtype, generator=g))
            self.add_module(f"norm{layer}", MaskedBatchNorm(H))
            if cfg.virtual_node and layer < cfg.num_layers - 1:
                self.add_module(f"vn_mlp0_{layer}",
                                TorchDense(H, 2 * H, generator=g))
                self.add_module(f"vn_bn0_{layer}", MaskedBatchNorm(2 * H))
                self.add_module(f"vn_mlp1_{layer}",
                                TorchDense(2 * H, H, generator=g))
                self.add_module(f"vn_bn1_{layer}", MaskedBatchNorm(H))
        self.head = TorchDense(H, cfg.out_dim, generator=g)
        self.to(device)

    def generators(self) -> list:
        """The generators a train-mode forward draws from."""
        return [self.rng] if self.cfg.dropout > 0 else []

    def forward(self, batch: GraphBatch):
        cfg = self.cfg
        nm = batch.node_mask
        G = batch.num_graphs
        distance = batch.extras["edge_distance"]
        x = batch.x
        if cfg.atom_encoder:
            h = self.atom_encoder(x)
        else:
            h = self.node_embed(x.reshape(x.shape[0]))
        if cfg.virtual_node:
            vn = h.new_zeros(G, cfg.hidden) + self.v0
        node_graph = batch.node_graph.long()

        xx = [h]
        for layer in range(cfg.num_layers):
            last = layer == cfg.num_layers - 1
            if cfg.virtual_node:
                xx[0] = xx[0] + vn.index_select(0, node_graph)
            bond_emb = getattr(self, f"bond_encoder_{layer}")(batch.edge_attr)
            h = getattr(self, f"conv{layer}")(xx, batch, distance, bond_emb)
            h = getattr(self, f"norm{layer}")(h, nm)
            if not last:
                h = F.relu(h)
            h = self.drop(h)
            if cfg.virtual_node and not last:
                v = vn + segment_sum(h, node_graph, G, nm)
                v = getattr(self, f"vn_mlp0_{layer}")(v)
                v = F.relu(getattr(self, f"vn_bn0_{layer}")(
                    v, batch.graph_mask))
                v = getattr(self, f"vn_mlp1_{layer}")(v)
                v = F.relu(getattr(self, f"vn_bn1_{layer}")(
                    v, batch.graph_mask))
                vn = self.drop(v)
            xx = [h] + xx

        h = xx[0]
        if cfg.nested:
            sm = batch.segment_mask
            S = sm.shape[0]
            seg = masked_ids(batch.node_segment, nm)
            pool = segment_sum if cfg.subgraph_pooling == "sum" else (
                segment_mean)
            h = pool(h, seg, S, mask=nm)
            g = segment_mean(h, masked_ids(batch.segment_graph, sm), G,
                             mask=sm)
        else:
            g = segment_mean(h, node_graph, G, mask=nm)
        return self.head(g)
