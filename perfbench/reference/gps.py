"""GraphGPS (Rampášek et al., arXiv:2205.12454) on the ESC encoding with a
shortest-path-distance attention bias, as ESC-GNN's GPS fork runs it on
ZINC (arXiv:2303.10576): GINE + Transformer layers, BatchNorm, add pool.
Written out per graph over each graph's real nodes (no padded grid), on
flat node and edge arrays:

  h      = node_emb[type],  e = edge_emb[bond]
  per layer:
    e     = e + zMLP(rows_e @ z_table)     zMLP = elu(BN(Dense(elu(BN(.)))))
    h_loc = BN(h + MLP_0((1 + eps) h_i
                         + sum_{e = (j -> i)} relu(h_j + Dense(e))))
                                           MLP_0 = [Dense, BN, relu] x 2
    h_att = BN(h + Dense_out(MHA(h) per graph)), the logits of head k
            q_i.k_j / sqrt(d_k) + spd_bias[SPD(i, j), k]
    h     = h_loc + h_att
    h     = BN(h + W2 relu(W1 h))              W1: D -> 2D, W2: 2D -> D
  out_g  = Dense(relu(Dense(sum_{i in g} h_i)))

Each graph's SPD is its own breadth-first search over the batch's edge
list: hop counts up to 100, and 101 for a pair farther apart or not
connected (the port's `featurize/spd.py` gives an unconnected pair of a
graph of n <= 100 nodes min(100, n) + 1 instead; every graph the
benchmark draws is connected). Every BatchNorm runs over the batch's real
rows (edges or nodes). Parameter names are the system's, so one dict of
weights serves both.

Departures from GraphGPS's `GPSLayer` (`configs/GPS/zinc-GPS+RWSE.yaml`),
each as the JAX package and the port build the model:
  - the GINE MLP is [Dense, BN, relu] x 2 (GraphGPS: Dense, relu, Dense),
    and the edge features pass a Dense before the message;
  - the ESC fork's per-layer z embedding is added to the edge features,
    which carry it on into the next layer;
  - no attention dropout (GraphGPS: 0.5) and no RWSE;
  - node and edge type embeddings of 100 rows; a two-layer head (GraphGPS:
    three)."""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from perfbench.reference.nn import l1_mean, linear

SPD_CAP = 100  # hop counts kept; farther or unconnected pairs: SPD_CAP + 1
SUPPORTED = dict(dropout=0.0, attn_dropout=0.0, local_model="gine",
                 global_model="transformer", use_esc=True,
                 use_attn_bias=True, use_lap_pe=False, use_signnet=False,
                 use_rwse=False, use_degree=False, use_equivstable_pe=False,
                 node_encoder_kind="embed", edge_encoder_kind="embed",
                 graph_pred=True, pool="add", head="default")


def check(fields: dict) -> None:
    for k, v in SUPPORTED.items():
        if fields.get(k, v) != v:
            raise NotImplementedError(f"reference GPS: {k}={fields[k]!r}")
    if fields["dim_h"] % fields["num_heads"]:
        raise NotImplementedError("reference GPS: num_heads must divide "
                                  "dim_h")


def spd(num_nodes: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(n, n) int64 hop counts of one graph by breadth-first search from
    every node along its edges (src -> dst), SPD_CAP + 1 past SPD_CAP hops
    and between unconnected nodes."""
    nbrs = [[] for _ in range(num_nodes)]
    for a, b in zip(src.tolist(), dst.tolist()):
        nbrs[a].append(b)
    out = np.full((num_nodes, num_nodes), SPD_CAP + 1, np.int64)
    for r in range(num_nodes):
        out[r, r] = 0
        queue = collections.deque([r])
        while queue:
            a = queue.popleft()
            if out[r, a] == SPD_CAP:
                continue
            for b in nbrs[a]:
                if out[r, b] > out[r, a] + 1:
                    out[r, b] = out[r, a] + 1
                    queue.append(b)
    return out


def size_groups(b) -> list:
    """The batch's graphs grouped by node count, each group
    (nodes (g, n) long: the flat ids of its graphs' nodes, spd (g, n, n)
    long), computed once per batch."""
    if getattr(b, "gps_groups", None) is not None:
        return b.gps_groups
    npg = b.nodes_per_graph.cpu().numpy()
    start = np.concatenate([[0], np.cumsum(npg)])
    src, dst = b.src.cpu().numpy(), b.dst.cpu().numpy()
    g_of_edge = b.node_graph.cpu().numpy()[src]
    by_size: dict = collections.defaultdict(lambda: ([], []))
    for gi, n in enumerate(npg.tolist()):
        on = g_of_edge == gi
        ids, grids = by_size[n]
        ids.append(np.arange(start[gi], start[gi] + n))
        grids.append(spd(n, src[on] - start[gi], dst[on] - start[gi]))
    dev = b.x.device
    b.gps_groups = [
        (torch.as_tensor(np.stack(ids), device=dev),
         torch.as_tensor(np.stack(grids), device=dev))
        for _, (ids, grids) in sorted(by_size.items())]
    return b.gps_groups


def attention(p: dict, name: str, h: torch.Tensor, groups: list,
              heads: int) -> torch.Tensor:
    """Multi-head self-attention within each graph, with the SPD bias."""
    N, D = h.shape
    hd = D // heads
    q, k, v = (linear(p, f"{name}.{s}", h) for s in ("q", "k", "v"))
    table = p[name + ".spd_bias.weight"]  # (vocab, heads)
    outs, order = [], []
    for ids, grid in groups:
        g, n = ids.shape
        qg, kg, vg = (t[ids.reshape(-1)].reshape(g, n, heads, hd)
                      for t in (q, k, v))
        logits = torch.einsum("gihd,gjhd->ghij", qg, kg) / math.sqrt(hd)
        logits = logits + table[grid].permute(0, 3, 1, 2)
        a = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("ghij,gjhd->gihd", a, vg).reshape(g * n, D))
        order.append(ids.reshape(-1))
    back = torch.argsort(torch.cat(order))
    return linear(p, name + ".out", torch.cat(outs)[back])


def forward(p: dict, b, fields: dict, norms) -> torch.Tensor:
    elu, relu = torch.nn.functional.elu, torch.relu
    groups = size_groups(b)
    h = p["node_encoder.weight"][b.x[:, 0]]
    e = p["edge_encoder.weight"][b.edge_attr]
    for i in range(fields["num_layers"]):
        L = f"layer{i}"
        z = elu(norms(p, f"{L}.z_embedding.MaskedBatchNorm_0",
                      b.rows @ p[f"{L}.z_initial"]))
        z = elu(norms(p, f"{L}.z_embedding.MaskedBatchNorm_1",
                      linear(p, f"{L}.z_embedding.TorchDense_0", z)))
        e = e + z
        msg = relu(h[b.src] + linear(p, f"{L}.local_gine.lin_edge", e))
        agg = torch.zeros_like(h).index_add(0, b.dst, msg)
        loc = (1.0 + p[f"{L}.local_gine.eps"]) * h + agg
        for j in range(2):
            loc = relu(norms(p, f"{L}.MLP_0.MaskedBatchNorm_{j}",
                             linear(p, f"{L}.MLP_0.TorchDense_{j}", loc)))
        h_loc = norms(p, f"{L}.norm1_local", h + loc)
        att = attention(p, f"{L}.self_attn", h, groups, fields["num_heads"])
        h_att = norms(p, f"{L}.norm1_attn", h + att)
        h = h_loc + h_att
        ff = linear(p, f"{L}.ff_linear2",
                    relu(linear(p, f"{L}.ff_linear1", h)))
        h = norms(p, f"{L}.norm2", h + ff)
    pooled = h.new_zeros(b.num_graphs, h.shape[1]).index_add(
        0, b.node_graph, h)
    return linear(p, "head2", relu(linear(p, "head1", pooled)))


def loss(out: torch.Tensor, b) -> torch.Tensor:
    """Mean absolute error over the batch's graphs."""
    return l1_mean(out, b.y)


def errors(out: torch.Tensor, b) -> torch.Tensor:
    """|out - y| per graph and target."""
    return (out - b.y).abs()
