"""NestedGIN_eff — the flagship ESC-GNN model (counterpart of
`escgnn_tpu/models/nested_gin_eff.py`).

Variants carried by this package:
  * counting (node-level, ReLU, x_embedding prepended to the JK concat);
  * ZINC / flagship (graph-level, ELU, node/edge type embeddings, z_emb
    concatenated with an edge-type embedding, add-pool), with the conv
    stacks in bf16 under `compute_dtype="bfloat16"`.

The structural embedding path: on the dedup layout the z reduce and the
z MLP run on the batch's unique histogram rows with multiplicity-weighted
BatchNorm, then one gather expands them to edges (`ops/zemb.py`); the
result is the edge feature of every GINE layer.

BatchNorm uses batch statistics in `train()` mode and the running
statistics in `eval()` mode (flax's `use_running_average`).
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
    MLP,
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
    # QM9 variant and sharded execution: kept for parity with the JAX
    # config, not ported yet (they raise)
    concat_pos: bool = False
    node_add_embed_vocab: int = 0
    edge_float_attr: bool = False
    compute_dtype: str = "float32"  # float32 | bfloat16 for conv stacks
    edge_shard_axis: Optional[str] = None
    halo_axis: Optional[str] = None


def _check_ported(cfg: NestedGINEffConfig):
    unported = {
        "dropout > 0 (needs the width layout)": cfg.dropout > 0,
        "halo_axis": cfg.halo_axis is not None,
        "edge_shard_axis": cfg.edge_shard_axis is not None,
        "concat_pos": cfg.concat_pos,
        "node_add_embed_vocab": bool(cfg.node_add_embed_vocab),
        "edge_float_attr": cfg.edge_float_attr,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            "NestedGINEffConfig options not ported yet: " + ", ".join(bad))
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(cfg.compute_dtype)


_ACTS = {"relu": F.relu, "elu": F.elu}


class NestedGINEff(nn.Module):
    """`in_dim` is the width of `batch.x` (the x_embedding input and, for
    models without a node-type vocabulary, the first conv's input). The
    parameters are drawn on the CPU from `generator` (seed 0 when None)
    and then moved to `device`."""

    def __init__(self, cfg: NestedGINEffConfig, in_dim: int = 1,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_ported(cfg)
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        g = generator
        self.cfg = cfg
        self.act = _ACTS[cfg.act]
        H = cfg.hidden
        x_dim = in_dim
        if cfg.node_embed_vocab:
            self.node_type_embedding = TorchEmbed(
                cfg.node_embed_vocab, cfg.node_embed_dim, generator=g)
            x_dim = cfg.node_embed_dim
        self.z_initial = nn.Parameter(
            torch.empty(cfg.z_dim, H).normal_(0.0, 1.0, generator=g))
        self.z_embedding = MLP(H, (H,), self.act, pre_act=True, generator=g)
        edge_dim = H
        if cfg.edge_embed_vocab:
            self.edge_type_embedding = TorchEmbed(
                cfg.edge_embed_vocab, cfg.edge_embed_dim, generator=g)
            edge_dim += cfg.edge_embed_dim
        jk_dim = H * cfg.num_layers
        if cfg.use_x_embedding_jk:
            self.x_embedding = MLP(in_dim, (H, H), self.act, generator=g)
            jk_dim += H
        self.convs = []
        for i in range(cfg.num_layers):
            in_ch = x_dim if i == 0 else H
            conv = GINEConv(
                in_ch, MLP(in_ch, (H, H), self.act, generator=g),
                edge_dim=edge_dim, generator=g,
            )
            self.add_module(f"conv{i + 1}", conv)
            self.convs.append(conv)
        self.lin1 = TorchDense(jk_dim, H, generator=g)
        self.bn_lin1 = MaskedBatchNorm(H)
        self.lin2 = TorchDense(H, cfg.out_dim, generator=g)
        self.to(device)

    def forward(self, batch: GraphBatch):
        cfg = self.cfg
        node_mask, edge_mask = batch.node_mask, batch.edge_mask

        # --- node input features ---
        x = batch.x
        if cfg.node_embed_vocab:
            x = self.node_type_embedding(x.reshape(x.shape[0]))
        x = x.to(torch.float32)

        # --- per-edge structural embedding ---
        u = zemb_unique_rows(self.z_initial, batch)
        if u is not None and batch.enc_row_weight is not None:
            # dedup layout: the z MLP runs on the R unique rows with
            # multiplicity-weighted BN, then one gather to edges
            z_emb = expand_rows(self.z_embedding(u, batch.enc_row_weight), batch)
        else:
            z_emb = zemb_from_batch(self.z_initial, batch)
            z_emb = self.z_embedding(z_emb, edge_mask)
        if cfg.edge_embed_vocab:
            ea = batch.edge_attr
            z_emb = torch.cat(
                [z_emb, self.edge_type_embedding(ea.reshape(ea.shape[0]))],
                dim=-1)

        cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

        # --- GINE stack over the original graph ---
        xs = []
        if cfg.use_x_embedding_jk:
            xs.append(self.x_embedding(batch.x.to(torch.float32), node_mask))
        h = x
        z_c = z_emb.to(cdt)
        for conv in self.convs:
            h = conv(h.to(cdt), batch.senders, batch.receivers, z_c,
                     edge_mask, node_mask, uniform_nodes=batch.nodes_per_graph)
            xs.append(h)

        # JK concat + pooling in the conv compute dtype, head in f32
        h = torch.cat([a.to(cdt) for a in xs], dim=-1)
        if cfg.graph_pred:
            h = pool_nodes_to_graphs(
                h, batch, reduce="sum" if cfg.pool == "add" else "mean")
            head_mask = batch.graph_mask
        else:
            head_mask = node_mask
        h = h.to(torch.float32)
        h = self.lin1(h)
        h = self.bn_lin1(h, head_mask)
        h = self.act(h)  # dropout (0 here) sits before or after: a no-op
        return self.lin2(h)
