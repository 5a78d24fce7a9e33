"""Graph pooling (counterpart of `escgnn_tpu/models/pooling.py`):
`to_dense_batch`, `Set2Set`, `global_sort_pool`, `GlobalAttentionPool`
and `graph_pool`, the dispatch that BaselineGNN pools through.

`TopKPool`, `dense_diff_pool` and graclus come with the TU driver
(ROADMAP 9).
"""

from __future__ import annotations

import torch
from torch import nn

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.models.layers import TorchDense
from escgnn_tpu_torch.ops.segment import (
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)


def to_dense_batch(x, batch: GraphBatch, max_nodes: int):
    """(N, F) node features -> (G, M, F) dense per-graph view + (G, M)
    mask, each graph's nodes in rows [0, n_g) by `node_local`; padding
    rows are zero. Masked node rows are routed to slot 0 with a zero
    value (JAX drops an out-of-range slot; a CUDA index_add would fault)."""
    G = batch.num_graphs
    flat = batch.node_graph.long() * max_nodes + batch.node_local.long()
    flat = torch.where(batch.node_mask, flat, torch.zeros_like(flat))
    dense = segment_sum(x, flat, G * max_nodes, mask=batch.node_mask)
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    mask = segment_sum(ones, flat, G * max_nodes, mask=batch.node_mask) > 0
    return (dense.reshape(G, max_nodes, x.shape[-1]),
            mask.reshape(G, max_nodes))


class LSTMCell(nn.Module):
    """flax `nn.OptimizedLSTMCell` written out: input projections `ii`,
    `if`, `ig`, `io` (no bias) and hidden projections `hi`, `hf`, `hg`,
    `ho` (with bias), gates i, f, g, o, carry (c, h). The modules carry
    flax's names, so `weights.py` maps them one to one."""

    def __init__(self, in_features: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        for gate in "ifgo":
            self.add_module(f"i{gate}", TorchDense(
                in_features, features, bias=False, generator=generator))
            self.add_module(f"h{gate}", TorchDense(
                features, features, generator=generator))

    def forward(self, carry, x):
        c, h = carry

        def pre(gate):
            return (getattr(self, f"h{gate}")(h)
                    + getattr(self, f"i{gate}")(x))

        i = torch.sigmoid(pre("i"))
        f = torch.sigmoid(pre("f"))
        g = torch.tanh(pre("g"))
        o = torch.sigmoid(pre("o"))
        c = f * c + i * g
        h = o * torch.tanh(c)
        return (c, h), h


class Set2Set(nn.Module):
    """Set2Set pooling: `processing_steps` rounds of LSTM query ->
    attention over the nodes -> readout; returns (G, 2F)."""

    def __init__(self, features: int, processing_steps: int = 3, *,
                 generator: torch.Generator):
        super().__init__()
        self.processing_steps = processing_steps
        self.lstm = LSTMCell(2 * features, features, generator=generator)

    def forward(self, x, batch: GraphBatch, ids=None, mask=None):
        # ids / mask default to node -> graph; a two-level batch passes
        # its copy -> graph ids
        ids = batch.node_graph if ids is None else ids
        mask = batch.node_mask if mask is None else mask
        G, F = batch.num_graphs, x.shape[-1]
        carry = (x.new_zeros(G, F), x.new_zeros(G, F))
        q_star = x.new_zeros(G, 2 * F)
        for _ in range(self.processing_steps):
            carry, q = self.lstm(carry, q_star)
            e = (x * q.index_select(0, ids.long())).sum(-1)
            a = segment_softmax(e, ids, G, mask=mask)
            r = segment_sum(x * a[:, None], ids, G, mask=mask)
            q_star = torch.cat([q, r], dim=-1)
        return q_star


def global_sort_pool(x, batch: GraphBatch, k: int, max_nodes: int):
    """DGCNN SortPooling: each graph's nodes sorted by the last feature
    channel, descending (a stable sort, as `jnp.argsort`: ties keep node
    order; padding rows take the key -inf and sort last), the first k
    rows kept (zero-padded), flattened to (G, k * F)."""
    dense, mask = to_dense_batch(x, batch, max_nodes)
    key = torch.where(mask, dense[..., -1],
                      torch.full((), float("-inf"), dtype=dense.dtype,
                                 device=dense.device))
    order = torch.argsort(-key, dim=1, stable=True)[:, :k]
    top = torch.take_along_dim(dense, order[..., None], dim=1)
    kept = torch.take_along_dim(mask, order, dim=1)
    top = torch.where(kept[..., None], top, torch.zeros((), dtype=top.dtype,
                                                        device=top.device))
    return top.reshape(dense.shape[0], k * x.shape[-1])


class GlobalAttentionPool(nn.Module):
    """PyG GlobalAttention: a gate (a Linear, or Linear -> ReLU -> Linear
    with `gate_hidden`) softmax-normalized over each graph's nodes
    weights their sum."""

    def __init__(self, features: int, gate_hidden: int = 0, *,
                 generator: torch.Generator):
        super().__init__()
        d = features
        if gate_hidden:
            self.gate_hidden = TorchDense(features, gate_hidden,
                                          generator=generator)
            d = gate_hidden
        self.gate = TorchDense(d, 1, generator=generator)

    def forward(self, x, batch: GraphBatch):
        g = x
        if hasattr(self, "gate_hidden"):
            g = torch.relu(self.gate_hidden(g))
        gate = self.gate(g)[:, 0]
        G = batch.num_graphs
        attn = segment_softmax(gate, batch.node_graph, G, mask=batch.node_mask)
        return segment_sum(x * attn[:, None], batch.node_graph, G,
                           mask=batch.node_mask)


GRAPH_POOLS = ("add", "mean", "max", "attention", "set2set", "sort", "center")


def graph_pool(module: nn.Module, how: str, x, batch: GraphBatch,
               sort_k: int = 10):
    """Node rows -> graph rows by `how`; `attention` and `set2set` use
    `module.attn_pool` / `module.set2set`. `sort` keeps `sort_k` rows of
    a per-graph budget of max(ceil(N / G), sort_k) nodes, as JAX sizes it
    from the static shapes; `center` takes each graph's first node."""
    G = batch.num_graphs
    ng, nm = batch.node_graph, batch.node_mask
    if how == "add":
        return segment_sum(x, ng, G, mask=nm)
    if how == "mean":
        return segment_mean(x, ng, G, mask=nm)
    if how == "max":
        return segment_max(x, ng, G, mask=nm)
    if how == "attention":
        return module.attn_pool(x, batch)
    if how == "set2set":
        return module.set2set(x, batch)
    if how == "sort":
        m = max(-(-x.shape[0] // max(G, 1)), sort_k)
        return global_sort_pool(x, batch, sort_k, m)
    if how == "center":
        return segment_sum(x, ng, G, mask=(batch.node_local == 0) & nm)
    raise ValueError(how)


def graph_pool_width(how: str, features: int, sort_k: int = 10) -> int:
    """The width of `graph_pool`'s output rows for `features`-wide nodes."""
    if how == "set2set":
        return 2 * features
    if how == "sort":
        return sort_k * features
    return features
