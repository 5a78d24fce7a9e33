"""k-GNN models: higher-order WL networks over k-set graphs (counterpart
of `escgnn_tpu/models/kgnn_models.py`).

  * `NNConv`: the edge-conditioned conv, out_i = x_i W_root + b +
    sum_{j -> i} x_j . h(e_ji), with h(e) = Linear(Fe, 128) -> ReLU ->
    Linear(128, F_in * F_out) reshaped to (F_in, F_out) per edge, the
    per-edge products one `torch.bmm` over (E, 1, F_in) x (E, F_in, F_out);
  * `KSetGraphConv`: the k_gnn GraphConv over a set graph, out_r =
    (1 / deg_r) sum_{c -> r} (x W)_c + x_r W_root + b;
  * `avg_pool_assignment`: the mean of the member-node rows into each set;
  * `KGNN`: k1_GNN (3 NNConvs, graph mean, fc head) and the nested
    Nested_k12 / k13 / k123 models (NNConvs over the subgraph copies, the
    per-copy mean x_1, then per level k: set features = avg_pool onto the
    k-sets ‖ one-hot iso type, two KSetGraphConvs, mean back to the copies
    x_k; [x_1 ‖ x_k ...] averaged per graph, fc1/fc2/fc3).

The set graphs arrive as the batcher's padded `kset{k}_*` extras. Their
padding receivers, assigned sets, owning copies and owning graphs are
out of range, which JAX drops: here those rows go to segment 0 with a
neutral value (`ops/segment.py` `masked_ids`). The iso one-hot is a
`scatter_` onto zeros (no `F.one_hot`, which reads the ids' range on the
host), the ids clipped to the one-hot width as JAX clips them.

Submodule names follow the flax tree, so `weights.py` carries a flax
state across; weights are drawn on the CPU from `generator` (seed 0 when
None) and moved to `device`.
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
from escgnn_tpu_torch.ops.segment import masked_ids, segment_mean, segment_sum


class NNConv(nn.Module):
    """PyG-semantics NNConv with aggr='add' (see module docstring)."""

    def __init__(self, in_features: int, features: int, edge_dim: int,
                 edge_hidden: int = 128, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.features = features
        self.edge_nn_0 = TorchDense(edge_dim, edge_hidden, generator=g)
        self.edge_nn_1 = TorchDense(edge_hidden, in_features * features,
                                    generator=g)
        self.root = TorchDense(in_features, features, generator=g)

    def forward(self, x, senders, receivers, edge_attr, edge_mask):
        n, f_in = x.shape
        e = edge_attr.float().reshape(edge_attr.shape[0], -1)
        w = self.edge_nn_1(F.relu(self.edge_nn_0(e)))
        w = w.reshape(-1, f_in, self.features)
        msg = torch.bmm(x.index_select(0, senders.long())[:, None, :],
                        w)[:, 0]
        agg = segment_sum(msg, receivers, n, edge_mask)
        return agg + self.root(x)


class KSetGraphConv(nn.Module):
    """k_gnn GraphConv over a padded set-graph edge list."""

    def __init__(self, in_features: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.weight = TorchDense(in_features, features, bias=False,
                                 generator=generator)
        self.root = TorchDense(in_features, features, generator=generator)

    def forward(self, x, senders, receivers, edge_mask):
        n = x.shape[0]
        recv = masked_ids(receivers, edge_mask)
        h = self.weight(x)
        agg = segment_sum(h.index_select(0, senders.long()), recv, n,
                          edge_mask)
        deg = segment_sum(edge_mask.to(agg.dtype), recv, n)
        return agg / deg.clamp_min(1.0)[:, None] + self.root(x)


def avg_pool_assignment(x, assign_node, assign_set, assign_mask,
                        num_sets: int):
    """k_gnn avg_pool: the mean of the member-node rows of each set."""
    return segment_mean(x.index_select(0, assign_node.long()),
                        masked_ids(assign_set, assign_mask), num_sets,
                        mask=assign_mask)


@dataclasses.dataclass(frozen=True)
class KGNNConfig:
    levels: tuple = (2,)  # () = k1_GNN; (2,) = k12; (3,) = k13; (2,3) = k123
    num_iso_2: int = 75  # one-hot width of 2-set iso types
    num_iso_3: int = 250
    node_type_dim: int = 8
    z_vocab: int = 1000
    use_rd: bool = False
    use_pos: bool = False
    nested: bool = True  # copies-graph with two-level pooling
    out_dim: int = 1


class KGNN(nn.Module):
    """k1 / Nested_k12 / k13 / k123 QM9 models (see module docstring).

    The flax model reads what the batch carries, which fixes its input
    widths at init; here the constructor is told: `x_dim` and `edge_dim`
    (the node and edge feature columns) and `has_pos` (the batches carry
    `pos`: concatenated under `use_pos`; the copy transform drops it).
    The nested models embed the copies' `extras['z']` hop labels. Reads
    `extras['node_type']` when present, else the argmax of x, and
    `extras['rd']` under `use_rd`."""

    def __init__(self, cfg: KGNNConfig, x_dim: int, edge_dim: int,
                 has_pos: bool = True, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not set(cfg.levels) <= {2, 3}:
            raise ValueError(f"levels {cfg.levels}: k-set levels are 2, 3")
        device = resolve_device(device)
        g = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        self.cfg = cfg
        self.use_pos = cfg.use_pos and has_pos
        if cfg.nested:
            self.z_embedding = TorchEmbed(cfg.z_vocab, 8, generator=g)
        if cfg.use_rd:
            self.rd_projection = TorchDense(1, 8, generator=g)
        self.node_type_embedding = TorchEmbed(5, cfg.node_type_dim,
                                              generator=g)
        d = cfg.node_type_dim + x_dim + (3 if self.use_pos else 0)
        for i, width in enumerate((32, 64, 64)):
            self.add_module(f"conv{i + 1}",
                            NNConv(d, width, edge_dim, generator=g))
            d = width
        conv_i = 4
        for lvl in cfg.levels:
            num_iso = cfg.num_iso_2 if lvl == 2 else cfg.num_iso_3
            d_set = 64 + num_iso
            for _ in range(2):
                self.add_module(f"conv{conv_i}",
                                KSetGraphConv(d_set, 64, generator=g))
                d_set = 64
                conv_i += 1
        self.fc1 = TorchDense(64 * (1 + len(cfg.levels)), 64, generator=g)
        self.fc2 = TorchDense(64, 32, generator=g)
        self.fc3 = TorchDense(32, cfg.out_dim, generator=g)
        self.to(device)

    def _input(self, batch: GraphBatch):
        cfg = self.cfg
        ex = batch.extras or {}
        n = batch.num_nodes
        x_flat = batch.x.reshape(n, -1)
        nt = ex["node_type"] if "node_type" in ex else x_flat.argmax(-1)
        x0 = self.node_type_embedding(nt.reshape(-1))
        if cfg.nested:
            x0 = x0 + self.z_embedding(ex["z"]).sum(1)
        if cfg.use_rd:
            x0 = x0 + self.rd_projection(ex["rd"].float())
        parts = [x0, x_flat.float()]
        if self.use_pos:
            parts.append(batch.pos.float())
        return torch.cat(parts, dim=-1)

    def forward(self, batch: GraphBatch):
        cfg = self.cfg
        ex = batch.extras or {}
        nm = batch.node_mask
        G = batch.num_graphs
        x = self._input(batch)
        for i in range(3):
            x = F.elu(getattr(self, f"conv{i + 1}")(
                x, batch.senders, batch.receivers, batch.edge_attr,
                batch.edge_mask))

        if cfg.nested:
            S = batch.segment_mask.shape[0]
            x_1 = segment_mean(x, masked_ids(batch.node_segment, nm), S,
                               mask=nm)
        else:
            x_1 = segment_mean(x, batch.node_graph, G, mask=nm)
        parts = [x_1]

        conv_i = 4
        for lvl in cfg.levels:
            set_mask = ex[f"kset{lvl}_mask"]
            num_sets = set_mask.shape[0]
            xs = avg_pool_assignment(
                x, ex[f"kset{lvl}_assign_node"], ex[f"kset{lvl}_assign_set"],
                ex[f"kset{lvl}_assign_mask"], num_sets)
            num_iso = cfg.num_iso_2 if lvl == 2 else cfg.num_iso_3
            iso = ex[f"kset{lvl}_iso"].long().clamp(0, num_iso - 1)
            onehot = xs.new_zeros(num_sets, num_iso).scatter_(
                1, iso[:, None], set_mask.to(xs.dtype)[:, None])
            xs = torch.cat([xs, onehot], dim=-1)
            for _ in range(2):
                xs = F.elu(getattr(self, f"conv{conv_i}")(
                    xs, ex[f"kset{lvl}_senders"], ex[f"kset{lvl}_receivers"],
                    ex[f"kset{lvl}_edge_mask"]))
                conv_i += 1
            if cfg.nested:
                owner, rows = ex[f"kset{lvl}_to_subgraph"], S
            else:
                owner, rows = ex[f"kset{lvl}_graph"], G
            parts.append(segment_mean(xs, masked_ids(owner, set_mask), rows,
                                      mask=set_mask))

        h = torch.cat(parts, dim=-1)
        if cfg.nested:
            sm = batch.segment_mask
            h = segment_mean(h, masked_ids(batch.segment_graph, sm), G,
                             mask=sm)
        h = F.elu(self.fc1(h))
        h = F.elu(self.fc2(h))
        return self.fc3(h)
