"""Graph pooling (counterpart of `escgnn_tpu/models/pooling.py`):
`to_dense_batch`, `Set2Set`, `global_sort_pool`, `GlobalAttentionPool`,
`graph_pool` (the dispatch that BaselineGNN pools through) and the TU
baselines' pooling zoo: `TopKPool` in mask form (dropped nodes gated to
zero and masked out, so the node set keeps its static size),
`dense_diff_pool` on the dense per-graph view, `batch_dense_adj`,
`graclus_cluster` (greedy heavy-edge matching, host numpy) and
`pool_by_cluster`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.models.layers import TorchDense
from escgnn_tpu_torch.ops.segment import (
    gather_rows,
    masked_ids,
    segment_max,
    segment_mean,
    segment_min,
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
            e = (x * gather_rows(q, ids)).sum(-1)
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


class TopKPool(nn.Module):
    """TopK pooling (Gao & Ji; PyG TopKPooling) in mask form: score =
    x . p / |p|; the nodes of each graph whose descending score rank is
    at least ceil(ratio * n_g) are gated to zero and masked out; the kept
    ones are scaled by tanh(score). Returns (x', node_mask'). `weight`
    (p) is drawn N(0, 0.1) from `generator`, as flax's init draws it."""

    def __init__(self, features: int, ratio: float = 0.8, *,
                 generator: torch.Generator):
        super().__init__()
        self.ratio = ratio
        self.weight = nn.Parameter(
            torch.empty(features).normal_(0.0, 0.1, generator=generator))

    def forward(self, x, batch: GraphBatch, node_mask):
        p = self.weight
        score = x @ p / torch.linalg.vector_norm(p).clamp_min(1e-12)
        G, n = batch.num_graphs, x.shape[0]
        node_graph = batch.node_graph.long()
        # within-graph descending rank: sort by score (descending; masked
        # nodes last), then stably by graph id; a node's rank is its
        # sorted position less its graph's first sorted position
        s = torch.where(node_mask, score.detach(),
                        torch.full((), float("-inf"), dtype=score.dtype,
                                   device=score.device))
        by_score = torch.argsort(-s, stable=True)
        perm = by_score[torch.argsort(node_graph[by_score], stable=True)]
        pos = torch.empty(n, dtype=torch.long, device=x.device)
        pos[perm] = torch.arange(n, device=x.device)
        first = segment_min(pos.to(torch.float32), node_graph, G)
        rank = pos.to(torch.float32) - first[node_graph]
        n_per_graph = segment_sum(node_mask.to(torch.float32), node_graph, G)
        keep_n = torch.ceil(self.ratio * n_per_graph)
        keep = (rank < keep_n[node_graph]) & node_mask
        x_out = torch.where(keep[:, None], x * torch.tanh(score)[:, None],
                            torch.zeros((), dtype=x.dtype, device=x.device))
        return x_out, keep


def dense_diff_pool(x_dense, adj_dense, s_logits, mask):
    """DiffPool (Ying et al.; PyG dense_diff_pool): S = softmax(s_logits)
    over the clusters, masked rows zero; X' = S^T X, A' = S^T A S; the
    link loss |A - S S^T|_F^2 / n^2 and the entropy loss, each averaged
    over the graphs. Returns (x', adj', link_loss, ent_loss)."""
    s = torch.softmax(s_logits, dim=-1)
    s = torch.where(mask[..., None], s, torch.zeros((), dtype=s.dtype,
                                                    device=s.device))
    x_out = torch.einsum("bnk,bnf->bkf", s, x_dense)
    adj_out = torch.einsum("bnk,bnm,bml->bkl", s, adj_dense, s)
    link = adj_dense - torch.einsum("bnk,bmk->bnm", s, s)
    denom = mask.sum(1).clamp_min(1).to(link.dtype)
    link_loss = (link * link).sum((1, 2)) / denom ** 2
    ent = -torch.where(s > 1e-15, s * torch.log(s + 1e-15),
                       torch.zeros((), dtype=s.dtype, device=s.device)
                       ).sum(-1)
    ent_loss = torch.where(mask, ent, torch.zeros(
        (), dtype=ent.dtype, device=ent.device)).sum(1) / denom
    return x_out, adj_out, link_loss.mean(), ent_loss.mean()


def batch_dense_adj(batch: GraphBatch, max_nodes: int):
    """Dense (G, M, M) adjacency from the padded edge list (padding edges
    routed to slot 0 with weight 0)."""
    G = batch.num_graphs
    local = batch.node_local.long()
    s, r = batch.senders.long(), batch.receivers.long()
    flat = (batch.node_graph.long()[r] * max_nodes * max_nodes
            + local[s] * max_nodes + local[r])
    flat = masked_ids(flat, batch.edge_mask)
    ones = torch.ones(s.shape[0], dtype=torch.float32, device=s.device)
    adj = segment_sum(ones, flat, G * max_nodes * max_nodes,
                      mask=batch.edge_mask)
    return adj.reshape(G, max_nodes, max_nodes)


def graclus_cluster(edge_index: np.ndarray, num_nodes: int,
                    edge_weight: Optional[np.ndarray] = None,
                    seed: int = 0) -> np.ndarray:
    """Greedy heavy-edge matching (graclus; torch_cluster.graclus): nodes
    visited in the order of `np.random.default_rng(seed).permutation`,
    each unmatched node paired with its heaviest unmatched neighbour
    (first such on ties). Host numpy, JAX's draws: the same ids for the
    same seed. Returns (N,) int64 cluster ids in [0, num_clusters)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(num_nodes)
    cluster = np.full(num_nodes, -1, np.int64)
    src, dst = edge_index[0], edge_index[1]
    if edge_weight is None:
        edge_weight = np.ones(src.shape[0], np.float64)
    adj: list = [[] for _ in range(num_nodes)]
    for u, v, w in zip(src.tolist(), dst.tolist(), edge_weight.tolist()):
        if u != v:
            adj[u].append((v, float(w)))
    next_id = 0
    for v in order.tolist():
        if cluster[v] >= 0:
            continue
        best, best_w = -1, -1.0
        for u, w in adj[v]:
            if cluster[u] < 0 and w > best_w:
                best, best_w = u, w
        cluster[v] = next_id
        if best >= 0:
            cluster[best] = next_id
        next_id += 1
    return cluster


def pool_by_cluster(x, cluster, num_clusters: int, mask=None, how="avg"):
    """avg / max / sum pool of node rows into cluster rows (k_gnn
    avg_pool, PyG avg_pool_x)."""
    if how == "avg":
        return segment_mean(x, cluster, num_clusters, mask=mask)
    if how == "max":
        return segment_max(x, cluster, num_clusters, mask=mask)
    return segment_sum(x, cluster, num_clusters, mask=mask)
