"""I²GNN: the nested GNN over (root, neighbour)-pair subgraph copies
(counterpart of `escgnn_tpu/models/i2gnn.py`).

Per-layer z-label embedding (plus a 2-column resistance-distance
projection), the NGNN GIN conv with an edge-type message, BN + ELU +
residual, then the hierarchical pooling cascade:

  pair-copy level: mean | add | center | mean-center | mean-center-side
                   (mean and mean-center-side optionally gated by
                   sigmoid(z_emb))
  subgraph level:  mean | add | mean-context (concat the per-original-node
                   mean)
  graph level:     mean | add (or the subgraph rows, for a node-level head)

with the optional `double_pooling` (the pooled context broadcast back to
the copy nodes in every layer) and `use_pooling_nn` (width-preserving
MLPs after the pair-copy and subgraph pools). It runs on the copies made
by `featurize/pair_subgraphs.py`. On the uniform and bucketed per-copy
layouts the pair-copy pools are masked reshapes (`pool_copy_blocks`);
elsewhere masked segment reductions. Weights are drawn on the CPU from
`generator` (seed 0 when None) and moved to `device`; submodule names
follow the flax tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.models.layers import EmbedMM, MaskedBatchNorm, TorchDense
from escgnn_tpu_torch.models.ngnn import NGNNGINConv, _dtype, node_type_input
from escgnn_tpu_torch.ops.segment import (
    gather_rows,
    masked_ids,
    pool_copy_blocks,
    segment_mean,
    segment_sum,
)

SUBGRAPH2_POOLINGS = {"mean": 1, "add": 1, "center": 1, "mean-center": 2,
                      "mean-center-side": 3}


@dataclasses.dataclass(frozen=True)
class I2GNNConfig:
    num_layers: int = 5
    hidden: int = 64
    node_type_dim: int = 8
    z_vocab: int = 100
    edge_vocab: int = 5
    use_rd: bool = False
    compute_dtype: str = "float32"  # bfloat16: bf16 messages + aggregation
    subgraph_pooling: str = "mean"  # mean | add | mean-context
    # mean | add | center | mean-center | mean-center-side
    subgraph2_pooling: str = "mean"
    graph_aggr: str = "mean"  # mean | add
    gate: bool = False
    out_dim: int = 1
    residual: bool = True
    # node-level head: the root-subgraph rows are the original nodes
    node_level: bool = False
    # re-inject the pooled subgraph context into every layer:
    # x = double_nn([x | pool(x) broadcast back through node_original])
    double_pooling: bool = False
    # width-preserving Linear-ReLU-Linear after the pair-copy and
    # subgraph pools
    use_pooling_nn: bool = False


class I2GNN(nn.Module):
    """Reads `x` (one type id per node), `extras['z']` and, with `use_rd`,
    `extras['rd']` (two resistance distances per node: to the root and to
    the neighbour)."""

    def __init__(self, cfg: I2GNNConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.subgraph2_pooling not in SUBGRAPH2_POOLINGS:
            raise ValueError(f"subgraph2_pooling {cfg.subgraph2_pooling!r}")
        if cfg.subgraph_pooling not in ("mean", "add", "mean-context"):
            raise ValueError(f"subgraph_pooling {cfg.subgraph_pooling!r}")
        if cfg.graph_aggr not in ("mean", "add"):
            raise ValueError(f"graph_aggr {cfg.graph_aggr!r}")
        _dtype(cfg.compute_dtype)
        device = resolve_device(device)
        g = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        self.cfg = cfg
        H = cfg.hidden
        w2 = SUBGRAPH2_POOLINGS[cfg.subgraph2_pooling] * H
        w1 = w2 + (H if cfg.subgraph_pooling == "mean-context" else 0)
        self.node_type_embedding = EmbedMM(100, cfg.node_type_dim,
                                           generator=g)
        m_in = cfg.node_type_dim + 1
        for layer in range(cfg.num_layers + 1):
            # the last z embedding feeds the final pooling's gate
            self.add_module(f"z_embedding_{layer}",
                            EmbedMM(cfg.z_vocab, m_in, generator=g))
            if cfg.use_rd:
                self.add_module(f"rd_projection_{layer}",
                                TorchDense(2, m_in, generator=g))
            if layer == cfg.num_layers:
                break
            self.add_module(f"conv{layer}", NGNNGINConv(
                2 * m_in, H, cfg.edge_vocab, cfg.compute_dtype, generator=g))
            if cfg.double_pooling:
                self.add_module(f"double_nn_{layer}_0",
                                TorchDense(H + w1, 128, generator=g))
                self.add_module(f"double_nn_{layer}_1",
                                TorchDense(128, H, generator=g))
            self.add_module(f"norm{layer}", MaskedBatchNorm(H))
            m_in = H
        if cfg.use_pooling_nn:
            self.edge_pooling_nn_0 = TorchDense(w2, w2, generator=g)
            self.edge_pooling_nn_1 = TorchDense(w2, w2, generator=g)
            self.node_pooling_nn_0 = TorchDense(w1, w1, generator=g)
            self.node_pooling_nn_1 = TorchDense(w1, w1, generator=g)
        if cfg.gate:
            self.subgraph_gate = TorchDense(H, H, generator=g)
        head_in = w1
        self.fc1 = TorchDense(head_in, 32, generator=g)
        self.fc2 = TorchDense(32, 16, generator=g)
        self.fc3 = TorchDense(16, cfg.out_dim, generator=g)
        self.to(device)

    def _z_embed(self, layer: int, batch: GraphBatch):
        z_emb = getattr(self, f"z_embedding_{layer}")(batch.extras["z"]).sum(1)
        if self.cfg.use_rd:
            z_emb = z_emb + getattr(self, f"rd_projection_{layer}")(
                batch.extras["rd"].float())
        return z_emb

    def _pool(self, x, batch: GraphBatch, z_emb, gate: bool,
              node_emb_only: bool = False):
        cfg = self.cfg
        S = batch.segment_mask.shape[0]
        S2 = batch.segment2_mask.shape[0]
        nm = batch.node_mask
        if cfg.subgraph_pooling == "mean-context":
            x_node = segment_mean(x, masked_ids(batch.node_original, nm),
                                  batch.original_mask.shape[0], mask=nm)

        def s2_reduce(v, reduce):
            b = pool_copy_blocks(v, batch, S2, reduce=reduce)
            if b is not None:
                return b
            fn = segment_mean if reduce == "mean" else segment_sum
            return fn(v, batch.node_segment2, S2, mask=nm)

        def center(col):
            return gather_rows(x, batch.center_idx[:, col])

        sp2 = cfg.subgraph2_pooling
        if sp2 in ("mean", "mean-center-side") and gate:
            x = torch.sigmoid(self.subgraph_gate(z_emb)) * x
        if sp2 == "mean":
            h2 = s2_reduce(x, "mean")
        elif sp2 == "add":
            h2 = s2_reduce(x, "sum")
        elif sp2 == "center":
            h2 = center(0)
        elif sp2 == "mean-center":
            h2 = torch.cat([s2_reduce(x, "mean"), center(0)], dim=-1)
        else:  # mean-center-side
            h2 = torch.cat([s2_reduce(x, "mean"), center(0), center(1)],
                           dim=-1)
        if cfg.use_pooling_nn:
            h2 = self.edge_pooling_nn_1(F.relu(self.edge_pooling_nn_0(h2)))

        s2m = batch.segment2_mask
        parent = masked_ids(batch.segment2_parent, s2m)
        fn = segment_sum if cfg.subgraph_pooling == "add" else segment_mean
        h1 = fn(h2, parent, S, mask=s2m)
        if cfg.subgraph_pooling == "mean-context":
            # one subgraph per original node, so the rows align
            h1 = torch.cat([h1, x_node[:S]], dim=-1)
        # the double_pooling context returns before the node pooling MLP
        if cfg.use_pooling_nn and not node_emb_only:
            h1 = self.node_pooling_nn_1(F.relu(self.node_pooling_nn_0(h1)))
        return h1

    def forward(self, batch: GraphBatch):
        cfg = self.cfg
        nm = batch.node_mask
        h = node_type_input(self, batch)
        h_prev = None
        for layer in range(cfg.num_layers):
            z_emb = self._z_embed(layer, batch)
            h = torch.cat([h, z_emb], dim=-1)
            h = getattr(self, f"conv{layer}")(h, batch)
            if cfg.double_pooling:
                # the pooled per-subgraph context broadcast back to the
                # copy nodes: subgraph s is rooted at original node s, so
                # node_original indexes the subgraph axis (clamped as
                # JAX's gather clamps the padding id)
                ctx = self._pool(h, batch, z_emb, False, node_emb_only=True)
                idx = batch.node_original.long().clamp_max(ctx.shape[0] - 1)
                h = torch.cat([h, ctx[idx]], dim=-1)
                h = F.relu(getattr(self, f"double_nn_{layer}_0")(h))
                h = getattr(self, f"double_nn_{layer}_1")(h)
            h = getattr(self, f"norm{layer}")(h, nm)
            if layer < cfg.num_layers - 1:
                h = F.elu(h)
            if layer > 0 and cfg.residual:
                h = h + h_prev
            h_prev = h

        # final pooling with its own z embedding
        z_emb = self._z_embed(cfg.num_layers, batch)
        h1 = self._pool(h, batch, z_emb, cfg.gate)
        if cfg.node_level:
            g = h1  # one row per original node (root subgraph)
        else:
            fn = segment_sum if cfg.graph_aggr == "add" else segment_mean
            g = fn(h1, masked_ids(batch.segment_graph, batch.segment_mask),
                   batch.num_graphs, mask=batch.segment_mask)
        g = F.elu(self.fc1(g))
        g = F.elu(self.fc2(g))
        return self.fc3(g)
