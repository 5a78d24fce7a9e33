"""NestedGIN_eff — the flagship ESC-GNN model (counterpart of
`escgnn_tpu/models/nested_gin_eff.py`).

Variants carried by this package:
  * counting (node-level, ReLU, x_embedding prepended to the JK concat);
  * ZINC / flagship (graph-level, ELU, node/edge type embeddings, z_emb
    concatenated with an edge-type embedding, add-pool), with the conv
    stacks in bf16 under `compute_dtype="bfloat16"`, and its node-level
    form (ZINC cycle counting, `graph_pred=False`);
  * QM9 (graph-level, mean-pool): x = [x ‖ pos] plus an additive
    node-type embedding of `extras["node_type"]`, z_emb concatenated
    with the continuous edge_attr;
  * the expressiveness checks (SR25, EXP, CSL): the width layout, add
    pool, classification heads.

The structural embedding path: on the dedup layout the z reduce and the
z MLP run on the batch's unique histogram rows with multiplicity-weighted
BatchNorm, then one gather expands them to edges (`ops/zemb.py`); the
result is the edge feature of every GINE layer. With dropout > 0 the z
MLP runs on the expanded edge rows instead (dropout would correlate
edges that share a row), as in JAX.

Dropout sits in every MLP (z, x_embedding, the conv MLPs) and in the
head, before or after its activation by `head_order`; it draws from the
model's generator `rng` (seeded with `rng_seed`) in `train()` only.

BatchNorm's statistics mode is its own flag (flax's
`use_running_average`, `models/layers.py`), which `train()` / `eval()`
set by default.

Sharded execution (`parallel/`): the config names the mesh axes the
batch's rows are split over, and the forward sums over them.
  * `edge_shard_axis` (ep): this rank holds a slice of the edges and all
    nodes. Each conv's local segment sum is summed over the axis; the z
    MLP's BatchNorm over edge rows sums its statistics over it (on the
    dedup layout the unique rows carry this shard's multiplicities, so
    that sum is over edge rows too); the node BatchNorms do not.
  * `data_axis` (with `edge_shard_axis`, dp_ep): the node and graph rows
    are split over this axis as well, so every node- and graph-row
    BatchNorm sums over it and the edge-row ones over both axes. It is a
    field of this package only: JAX partitions the 2-D mesh with GSPMD.
  * `halo_axis`: receiver-range node and edge shards (`parallel/halo.py`,
    the width layout): the convs exchange boundary rows, every
    BatchNorm sums over the axis, and a graph head pools its local rows
    into the batch's global graph slots and sums them over the axis, so
    the head (whose BatchNorm then sums nothing) runs replicated.
`sharded_view` gives a model that shares every parameter and buffer with
this one under other axes (the drivers train the sharded view and
evaluate the plain model).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.models.layers import (
    MLP,
    Dropout,
    GINEConv,
    MaskedBatchNorm,
    TorchDense,
    TorchEmbed,
)
from escgnn_tpu_torch.ops.segment import pool_nodes_to_graphs
from escgnn_tpu_torch.ops.zemb import expand_rows, zemb_from_batch, zemb_unique_rows


@dataclasses.dataclass(frozen=True)
class NestedGINEffConfig:
    hidden: int = 256
    num_layers: int = 5
    dropout: float = 0.0
    z_dim: int = 1800
    out_dim: int = 1
    act: str = "relu"  # relu (counting) | elu (zinc)
    graph_pred: bool = False  # False -> node-level head
    pool: str = "mean"  # mean | add (graph_pred only)
    use_x_embedding_jk: bool = True  # counting variant: extra JK entry
    head_order: str = "act_dropout"  # act_dropout (count) | dropout_act (zinc)
    node_embed_vocab: int = 0  # >0: x are int type ids -> Embedding(vocab, dim)
    node_embed_dim: int = 32
    edge_embed_vocab: int = 0  # >0: concat edge-type embedding onto z_emb
    edge_embed_dim: int = 32
    # QM9 variant (reference qm9_models.py:25-139):
    concat_pos: bool = False  # x = [x ‖ pos]
    node_add_embed_vocab: int = 0  # >0: x += Embedding(vocab)(node_type)
    edge_float_attr: bool = False  # concat continuous edge_attr onto z_emb
    compute_dtype: str = "float32"  # float32 | bfloat16 for conv stacks
    # sharded execution (see the module docstring): mesh axis names
    edge_shard_axis: Optional[str] = None
    halo_axis: Optional[str] = None
    data_axis: Optional[str] = None


def _check_config(cfg: NestedGINEffConfig):
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(cfg.compute_dtype)
    if cfg.halo_axis is not None and (cfg.edge_shard_axis or cfg.data_axis):
        raise ValueError("halo_axis shards nodes and edges on its own; it "
                         "takes no edge_shard_axis or data_axis")


def _join(*axes):
    """The axes that are set, as one name or a tuple (None for none)."""
    names = tuple(a for a in axes if a is not None)
    return None if not names else names[0] if len(names) == 1 else names


_ACTS = {"relu": F.relu, "elu": F.elu}


class NestedGINEff(nn.Module):
    """`in_dim` is the width of `batch.x` (the x_embedding input and, for
    models without a node-type vocabulary, the first conv's input);
    `edge_attr_dim` the width of `batch.edge_attr` under
    `edge_float_attr` (flax reads both from the first batch). The
    parameters are drawn on the CPU from `generator` (seed 0 when None)
    and then moved to `device`; dropout draws from `rng`, a generator on
    `device` seeded with `rng_seed`."""

    def __init__(self, cfg: NestedGINEffConfig, in_dim: int = 1,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 edge_attr_dim: int = 0, rng_seed: int = 0):
        super().__init__()
        _check_config(cfg)
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        g = generator
        self.cfg = cfg
        self.act = _ACTS[cfg.act]
        self.rng = torch.Generator(device=device).manual_seed(rng_seed)
        drop = dict(dropout=cfg.dropout, rng=self.rng)
        H = cfg.hidden
        x_dim = in_dim
        if cfg.node_embed_vocab:
            self.node_type_embedding = TorchEmbed(
                cfg.node_embed_vocab, cfg.node_embed_dim, generator=g)
            x_dim = cfg.node_embed_dim
        if cfg.concat_pos:
            x_dim += 3
        if cfg.node_add_embed_vocab:
            # flax's name, shared with the vocabulary embedding above (a
            # config sets one of the two)
            if cfg.node_embed_vocab:
                raise ValueError("node_embed_vocab and node_add_embed_vocab "
                                 "both name node_type_embedding")
            self.node_type_embedding = TorchEmbed(
                cfg.node_add_embed_vocab, x_dim, generator=g)
        self.z_initial = nn.Parameter(
            torch.empty(cfg.z_dim, H).normal_(0.0, 1.0, generator=g))
        self.z_embedding = MLP(H, (H,), self.act, pre_act=True, **drop,
                               generator=g)
        edge_dim = H
        if cfg.edge_embed_vocab:
            self.edge_type_embedding = TorchEmbed(
                cfg.edge_embed_vocab, cfg.edge_embed_dim, generator=g)
            edge_dim += cfg.edge_embed_dim
        if cfg.edge_float_attr:
            if edge_attr_dim <= 0:
                raise ValueError("edge_float_attr needs edge_attr_dim, the "
                                 "width of batch.edge_attr")
            edge_dim += edge_attr_dim
        jk_dim = H * cfg.num_layers
        if cfg.use_x_embedding_jk:
            self.x_embedding = MLP(in_dim, (H, H), self.act, **drop,
                                   generator=g)
            jk_dim += H
        self.convs = []
        for i in range(cfg.num_layers):
            in_ch = x_dim if i == 0 else H
            conv = GINEConv(
                in_ch, MLP(in_ch, (H, H), self.act, **drop, generator=g),
                edge_dim=edge_dim, generator=g,
            )
            self.add_module(f"conv{i + 1}", conv)
            self.convs.append(conv)
        self.lin1 = TorchDense(jk_dim, H, generator=g)
        self.bn_lin1 = MaskedBatchNorm(H)
        self.lin2 = TorchDense(H, cfg.out_dim, generator=g)
        self.head_drop = Dropout(cfg.dropout, self.rng)
        self.to(device)

    def generators(self) -> list:
        """The generators a train-mode forward draws from."""
        return [self.rng] if self.cfg.dropout > 0 else []

    def sharded_view(self, **axes) -> "NestedGINEff":
        """This model under other mesh axes (`edge_shard_axis`,
        `halo_axis`, `data_axis`): a shallow copy whose config differs,
        sharing every parameter, buffer and generator with this one."""
        view = copy.copy(self)
        view.cfg = dataclasses.replace(self.cfg, **axes)
        _check_config(view.cfg)
        return view

    def forward(self, batch: GraphBatch):
        cfg = self.cfg
        node_mask, edge_mask = batch.node_mask, batch.edge_mask
        # BatchNorm sum axes: node rows are split under halo and dp_ep,
        # edge rows under every sharded mode
        node_ax = cfg.halo_axis or cfg.data_axis
        edge_ax = cfg.halo_axis or _join(cfg.data_axis, cfg.edge_shard_axis)
        halo = None
        if cfg.halo_axis is not None:
            halo = (cfg.halo_axis, batch.extras["halo_boundary_send"],
                    batch.extras["halo_src"])

        # --- node input features ---
        x = batch.x
        if cfg.node_embed_vocab:
            x = self.node_type_embedding(x.reshape(x.shape[0]))
        x = x.to(torch.float32)
        if cfg.concat_pos:
            x = torch.cat([x, batch.pos.to(torch.float32)], dim=-1)
        if cfg.node_add_embed_vocab:
            node_type = batch.extras["node_type"]
            x = x + self.node_type_embedding(
                node_type.reshape(node_type.shape[0]))

        # --- per-edge structural embedding ---
        u = (zemb_unique_rows(self.z_initial, batch)
             if cfg.dropout == 0.0 and cfg.halo_axis is None else None)
        if u is not None and batch.enc_row_weight is not None:
            # dedup layout: the z MLP runs on the R unique rows with
            # multiplicity-weighted BN, then one gather to edges
            z_emb = expand_rows(
                self.z_embedding(u, batch.enc_row_weight, edge_ax), batch)
        else:
            z_emb = zemb_from_batch(self.z_initial, batch)
            z_emb = self.z_embedding(z_emb, edge_mask, edge_ax)
        if cfg.edge_embed_vocab:
            ea = batch.edge_attr
            z_emb = torch.cat(
                [z_emb, self.edge_type_embedding(ea.reshape(ea.shape[0]))],
                dim=-1)
        if cfg.edge_float_attr:
            ea = batch.edge_attr.to(torch.float32)
            z_emb = torch.cat([z_emb, ea.reshape(ea.shape[0], -1)], dim=-1)

        cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

        # --- GINE stack over the original graph ---
        xs = []
        if cfg.use_x_embedding_jk:
            xs.append(self.x_embedding(batch.x.to(torch.float32), node_mask,
                                       node_ax))
        h = x
        z_c = z_emb.to(cdt)
        uniform = None if halo is not None else batch.nodes_per_graph
        for conv in self.convs:
            h = conv(h.to(cdt), batch.senders, batch.receivers, z_c,
                     edge_mask, node_mask, uniform_nodes=uniform,
                     edge_shard_axis=cfg.edge_shard_axis, halo=halo,
                     axis=node_ax)
            xs.append(h)

        # JK concat + pooling in the conv compute dtype, head in f32
        h = torch.cat([a.to(cdt) for a in xs], dim=-1)
        head_ax = node_ax
        if cfg.graph_pred:
            if halo is not None:
                h = self._halo_pool(h, batch)
                head_ax = None  # the pooled rows are whole on every rank
            else:
                h = pool_nodes_to_graphs(
                    h, batch, reduce="sum" if cfg.pool == "add" else "mean")
            head_mask = batch.graph_mask
        else:
            head_mask = node_mask
        h = h.to(torch.float32)
        h = self.lin1(h)
        h = self.bn_lin1(h, head_mask, head_ax)
        if cfg.head_order == "act_dropout":
            h = self.head_drop(self.act(h))
        else:
            h = self.act(self.head_drop(h))
        return self.lin2(h)

    def _halo_pool(self, h, batch: GraphBatch):
        """The graph pool over range-sharded node rows: this rank's rows
        summed into the batch's G graph slots (`node_graph` holds global
        graph ids), then summed over the halo axis, so every rank holds
        the exact (G, F) rows."""
        from escgnn_tpu_torch.ops.segment import segment_sum
        from escgnn_tpu_torch.parallel.mesh import psum

        G = batch.graph_mask.shape[0]
        mask = batch.node_mask
        s = psum(segment_sum(h.to(torch.float32), batch.node_graph, G, mask),
                 self.cfg.halo_axis)
        if self.cfg.pool == "add":
            return s
        cnt = psum(segment_sum(mask.to(torch.float32), batch.node_graph, G),
                   self.cfg.halo_axis)
        return s / cnt.clamp_min(1.0)[:, None]
