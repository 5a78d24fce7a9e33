"""Small host-side graph utilities (a copy of `escgnn_tpu/utils/graph.py`).

`negate_edge_index` mirrors the reference GraphGPS helper
(`GraphGPS/graphgps/utils.py:12-58`, unit-tested at
`GraphGPS/unittests/test_negate_edge_index.py`): the complementary edge
set of a (batched) sparse adjacency, ignoring self-loops — used by
SAN-style attention layers that attend over real and absent edges with
separate keys.
"""

from __future__ import annotations

import numpy as np


def negate_edge_index(edge_index, batch=None) -> np.ndarray:
    """Complementary (2, E') edge index per graph, self-loops excluded.

    `batch` assigns each node to a graph (None = one graph). Nodes of a
    graph must be contiguous. Output edges are sorted by (source, dest)
    within each graph, matching the reference's dense-mask scan order.
    """
    edge_index = np.asarray(edge_index).reshape(2, -1)
    if batch is None:
        n = int(edge_index.max()) + 1 if edge_index.size else 1
        batch = np.zeros(n, np.int64)
    batch = np.asarray(batch, np.int64)
    out_src, out_dst = [], []
    for g in range(int(batch.max()) + 1 if batch.size else 0):
        nodes = np.flatnonzero(batch == g)
        if nodes.size == 0:
            continue
        lo, n = nodes[0], nodes.size
        adj = np.zeros((n, n), bool)
        sel = (batch[edge_index[0]] == g) & (batch[edge_index[1]] == g)
        adj[edge_index[0][sel] - lo, edge_index[1][sel] - lo] = True
        np.fill_diagonal(adj, True)  # self-loops excluded from the complement
        a, b = np.nonzero(~adj)
        out_src.append(a + lo)
        out_dst.append(b + lo)
    if not out_src:
        return np.zeros((2, 0), np.int64)
    return np.stack(
        [np.concatenate(out_src), np.concatenate(out_dst)]
    ).astype(np.int64)


def disjoint_union(graphs) -> "GraphData":  # noqa: F821
    """Disjoint union of raw `GraphData` records into ONE graph.

    Used by the node-split cycle trainers: the reference runs them on a
    single dataset graph ("only one data actually",
    `kernel/train_eval.py:374`, Planetoid-style); for multi-graph TU
    datasets the union gives the same one-graph node-split protocol.
    Only x / edge_attr / pos payloads are carried (no extras)."""
    from escgnn_tpu_torch.data.container import GraphData

    off, ei, xs, eas, poss = 0, [], [], [], []
    for g in graphs:
        ei.append(np.asarray(g.edge_index) + off)
        if g.x is not None:
            xs.append(np.asarray(g.x))
        if g.edge_attr is not None:
            eas.append(np.asarray(g.edge_attr))
        if g.pos is not None:
            poss.append(np.asarray(g.pos))
        off += g.num_nodes
    return GraphData(
        num_nodes=off,
        edge_index=np.concatenate(ei, axis=1) if ei else
        np.zeros((2, 0), np.int64),
        x=np.concatenate(xs) if xs else None,
        edge_attr=np.concatenate(eas) if eas else None,
        pos=np.concatenate(poss) if poss else None,
    )
