"""NGNN: the nested GNN over node-rooted subgraph copies (counterpart of
`escgnn_tpu/models/ngnn.py`).

Per-layer z-label embeddings (plus a resistance-distance projection)
concatenated onto the node features, a GIN conv with an edge-type
embedding in the message, BN + ELU + residual per layer, two-level
pooling (mean or root over each copy, then mean over each graph, or the
copy rows themselves for a node-level head) and an fc1/fc2/fc3 head. It
runs on the copies made by `featurize/node_subgraphs.py`.

The conv's aggregation follows the batch layout: per-copy one-hot
products on the uniform per-copy blocks (`batch.nodes_per_seg`), once
per region on the bucketed layout (`batch.seg_regions`), else a masked
segment sum over the ragged union. Under `compute_dtype="bfloat16"` the
messages and the aggregation run in bf16 and the rest in f32, as JAX's
promotions make it. Submodule names follow the flax tree, so
`weights.py` carries a flax state across; weights are drawn on the CPU
from `generator` (seed 0 when None) and moved to `device`.
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
    EmbedMM,
    MaskedBatchNorm,
    TorchDense,
    _dense_local_aggregate,
    _dense_local_aggregate_regions,
)
from escgnn_tpu_torch.ops.segment import (
    gather_rows,
    masked_ids,
    pool_copy_blocks,
    segment_mean,
    segment_sum,
)


@dataclasses.dataclass(frozen=True)
class NGNNConfig:
    num_layers: int = 5
    hidden: int = 64
    node_type_dim: int = 8
    z_vocab: int = 100
    edge_vocab: int = 5
    use_rd: bool = False
    subgraph_pooling: str = "mean"  # mean | center
    out_dim: int = 1
    residual: bool = True
    compute_dtype: str = "float32"  # bfloat16: bf16 messages + aggregation
    # node-level head: one copy per original node, so stop at the copy
    # level and run the head per copy row
    node_level: bool = False


def _dtype(name: str) -> torch.dtype:
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {name!r}")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class NGNNGINConv(nn.Module):
    """GIN conv with edge-type embedded messages:
        mlp((1 + eps) x + sum_{j->i} relu(x_j + emb(edge type))),
    mlp = Linear(m, 2m) -> BN -> ReLU -> Linear(2m, m_out)."""

    def __init__(self, m_in: int, m_out: int, edge_vocab: int,
                 compute_dtype: str = "float32", *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.cdt = _dtype(compute_dtype)
        self.eps = nn.Parameter(torch.zeros(()))
        self.edge_encoder = EmbedMM(edge_vocab, m_in, generator=g)
        self.mlp_0 = TorchDense(m_in, 2 * m_in, generator=g)
        self.mlp_bn = MaskedBatchNorm(2 * m_in)
        self.mlp_1 = TorchDense(2 * m_in, m_out, generator=g)

    def forward(self, x, batch: GraphBatch):
        ea = batch.edge_attr
        e = self.edge_encoder(ea.reshape(ea.shape[0]))
        x, e = x.to(self.cdt), e.to(self.cdt)
        if batch.seg_regions is not None:
            agg = _dense_local_aggregate_regions(
                x, batch.senders, batch.receivers, e, batch.edge_mask,
                batch.seg_regions)
        elif batch.nodes_per_seg is not None:
            agg = _dense_local_aggregate(
                x, batch.senders, batch.receivers, e, batch.edge_mask,
                batch.nodes_per_seg)
        else:
            msg = F.relu(gather_rows(x, batch.senders) + e)
            agg = segment_sum(msg, batch.receivers, x.shape[0],
                              batch.edge_mask)
        # JAX promotes a bf16 x times the f32 eps to f32 (a 0-d tensor does
        # not promote in torch, so the casts are written out)
        h = (1.0 + self.eps) * x.float() + agg.float()
        h = F.relu(self.mlp_bn(self.mlp_0(h), batch.node_mask))
        return self.mlp_1(h)


def node_type_input(model: nn.Module, batch: GraphBatch):
    """[node-type embedding of x | x as a float], the copy models' first
    node features (x is one type id per node)."""
    x = batch.x
    xt = model.node_type_embedding(x.reshape(x.shape[0]))
    return torch.cat([xt, x.reshape(x.shape[0], -1).float()], dim=-1)


def copy_roots(node_mask, node_segment, num_segments: int):
    """(first node of each copy, is-root indicator per node). The copy
    transforms place each copy's root first, so it is the smallest node
    index of its segment; an empty segment points at the last node, as
    JAX's clamped gather reads it."""
    n = node_mask.shape[0]
    idx = torch.where(node_mask, torch.arange(n, device=node_mask.device),
                      n)
    ids = masked_ids(node_segment, node_mask).long()
    first = torch.full((num_segments,), n, dtype=idx.dtype,
                       device=idx.device).scatter_reduce(
        0, ids, idx, "amin", include_self=True)
    is_root = (idx == first[ids]) & node_mask
    return first.clamp_max(n - 1), is_root


class NGNN(nn.Module):
    """Reads `x` (one type id per node), `extras['z']` and, with `use_rd`,
    `extras['rd']` (one resistance distance per node, to the root)."""

    def __init__(self, cfg: NGNNConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.subgraph_pooling not in ("mean", "center"):
            raise ValueError(f"subgraph_pooling {cfg.subgraph_pooling!r}")
        _dtype(cfg.compute_dtype)
        device = resolve_device(device)
        g = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        self.cfg = cfg
        self.node_type_embedding = EmbedMM(100, cfg.node_type_dim,
                                           generator=g)
        m_in = cfg.node_type_dim + 1
        for layer in range(cfg.num_layers):
            self.add_module(f"z_embedding_{layer}",
                            EmbedMM(cfg.z_vocab, m_in, generator=g))
            if cfg.use_rd:
                self.add_module(f"rd_projection_{layer}",
                                TorchDense(1, m_in, generator=g))
            self.add_module(f"conv{layer}", NGNNGINConv(
                2 * m_in, cfg.hidden, cfg.edge_vocab, cfg.compute_dtype,
                generator=g))
            self.add_module(f"norm{layer}", MaskedBatchNorm(cfg.hidden))
            m_in = cfg.hidden
        self.fc1 = TorchDense(cfg.hidden, 32, generator=g)
        self.fc2 = TorchDense(32, 16, generator=g)
        self.fc3 = TorchDense(16, cfg.out_dim, generator=g)
        self.to(device)

    def forward(self, batch: GraphBatch):
        cfg = self.cfg
        z = batch.extras["z"]
        nm = batch.node_mask
        h = node_type_input(self, batch)
        h_prev = None
        for layer in range(cfg.num_layers):
            z_emb = getattr(self, f"z_embedding_{layer}")(z).sum(1)
            if cfg.use_rd:
                z_emb = z_emb + getattr(self, f"rd_projection_{layer}")(
                    batch.extras["rd"].float())
            h = torch.cat([h, z_emb], dim=-1)
            h = getattr(self, f"conv{layer}")(h, batch)
            h = F.elu(getattr(self, f"norm{layer}")(h, nm))
            if layer > 0 and cfg.residual:
                h = h + h_prev
            h_prev = h

        # two-level pooling: node -> copy -> graph
        S = batch.segment_mask.shape[0]
        n_c = batch.nodes_per_seg
        if cfg.subgraph_pooling == "center":
            if n_c is not None and batch.num_nodes == S * n_c:
                sub = h.reshape(S, n_c, -1)[:, 0]  # the root is slot 0
            else:
                sub = h[copy_roots(nm, batch.node_segment, S)[0]]
        else:
            sub = pool_copy_blocks(h, batch, S, reduce="mean")
            if sub is None:
                sub = segment_mean(h, batch.node_segment, S,
                                   mask=nm)
        if cfg.node_level:
            g = sub  # one row per original node
        else:
            g = segment_mean(
                sub, masked_ids(batch.segment_graph, batch.segment_mask),
                batch.num_graphs, mask=batch.segment_mask)
        g = F.elu(self.fc1(g))
        g = F.elu(self.fc2(g))
        return self.fc3(g)
