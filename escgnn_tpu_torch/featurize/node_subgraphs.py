"""Node-rooted subgraph copies — the NGNN pre-transform (copy of
`escgnn_tpu/featurize/node_subgraphs.py`, bit-equal output).

Mirror of reference `utils.py:18-132` (`create_subgraphs`): for every node
v, materialize a relabeled copy of its h-hop ego-net with hop-distance
labels z and optional resistance distance to the root; compose all copies
into one disconnected graph with `node_to_subgraph` / `subgraph_to_graph`
assignment vectors (two-level pooling indices).

Vectorized like the ESC encoder: one capped all-pairs BFS per graph, one
batched float64 pinv over padded copy Laplacians.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.featurize.bfs import hop_distance_matrix


@dataclasses.dataclass(frozen=True)
class NodeSubgraphConfig:
    h: int = 3
    use_rd: bool = False
    node_label: str = "hop"  # hop | spd (== spd2) | drnl
    keep_orig_adj: bool = False  # store dense original adjacency (NestedPPGN)

    def cache_key(self) -> str:
        key = f"ngnn_h{self.h}_{self.node_label}"
        if self.use_rd:
            key += "_rd"
        if self.keep_orig_adj:
            key += "_adj"
        return key


def _spd_labels(D, ei, n, h):
    """The reference's BFS 'spd' labels (`utils.py:135-229`): per node,
    [first-reach hop + 1, same value again iff the node was reached from
    >= 2 previous-frontier neighbors, else 0]. The root gets [1, 0]."""
    # count, for each (root r, node w), edges from the hop-(k-1) set to w
    # where k = D[r, w]
    A = np.zeros((n, n), np.int64)
    np.add.at(A, (ei[1], ei[0]), 1)  # reversed: same direction BFS expands
    enc2 = np.zeros((n, n), bool)
    for k in range(1, h + 1):
        prev = D == (k - 1)  # (roots, nodes) at hop k-1
        cnt = prev.astype(np.int64) @ A  # (roots, nodes): #edges from prev
        enc2 |= (D == k) & (cnt >= 2)
    z1 = np.where(D <= h, D + 1, 0)
    np.fill_diagonal(z1, 1)
    z2 = np.where(enc2, z1, 0)
    return z1, z2


def create_node_subgraphs(g: GraphData, cfg: NodeSubgraphConfig) -> GraphData:
    n = g.num_nodes
    h = cfg.h
    ei = np.asarray(g.edge_index, np.int64)
    D = hop_distance_matrix(n, ei, h)  # (N, N)
    member = D <= h  # (N_roots, N)
    label = cfg.node_label
    if label.startswith("spd") or label == "drnl":
        z1, z2 = _spd_labels(D, ei, n, h)
        if label == "drnl":
            Z = np.where(z2 > 0, z1 * (h + 1) + z2, z1)[..., None]
        else:
            Z = np.stack([z1, z2], axis=-1)  # (roots, nodes, 2)
    else:
        Z = D[..., None]  # hop distances, 1 col

    # copy node lists: root first, then members ascending
    copies = []
    for v in range(n):
        rest = np.flatnonzero(member[v])
        rest = rest[rest != v]
        copies.append(np.concatenate([[v], rest]))
    sizes = np.asarray([len(c) for c in copies])
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    total = int(offsets[-1])

    # relabeled edges per copy
    new_src, new_dst, new_eid = [], [], []
    for v, nodes in enumerate(copies):
        local = np.full(n, -1, np.int64)
        local[nodes] = np.arange(len(nodes))
        em = member[v][ei[0]] & member[v][ei[1]]
        idx = np.flatnonzero(em)
        new_src.append(local[ei[0, idx]] + offsets[v])
        new_dst.append(local[ei[1, idx]] + offsets[v])
        new_eid.append(idx)
    big_ei = np.stack(
        [np.concatenate(new_src), np.concatenate(new_dst)]
    ).astype(np.int32)
    eid = np.concatenate(new_eid)

    # per-copy-node fields
    z = np.concatenate([Z[v][c] for v, c in enumerate(copies)], axis=0).astype(
        np.int64
    )
    node_to_subgraph = np.concatenate(
        [np.full(s, v, np.int64) for v, s in enumerate(sizes)]
    )
    x_big = None
    if g.x is not None:
        x_big = np.concatenate([np.asarray(g.x)[c] for c in copies], axis=0)
    ea_big = None
    if g.edge_attr is not None:
        ea_big = np.asarray(g.edge_attr)[eid]

    extras = {
        "z": z if z.ndim == 2 else z[:, None],
        "node_to_subgraph": node_to_subgraph,
        "num_subgraphs": n,
    }
    if cfg.keep_orig_adj:
        # subgraph v is rooted at original node v, so the graph-level
        # coupling between subgraphs IS the original adjacency (the
        # `original_edge_index` channel of reference `kernel/ppgn.py:192`).
        adj = np.zeros((n, n), np.float32)
        adj[ei[0], ei[1]] = 1.0
        extras["orig_adj"] = adj

    if cfg.use_rd:
        max_s = int(sizes.max())
        A = np.zeros((n, n), np.float64)
        np.add.at(A, (ei[0], ei[1]), 1.0)
        np.fill_diagonal(A, 0.0)
        mats = np.zeros((n, max_s, max_s))
        for v, nodes in enumerate(copies):
            s = len(nodes)
            sub = A[np.ix_(nodes, nodes)]
            L = np.diag(sub.sum(1)) - sub
            mats[v, :s, :s] = L
        Li = np.linalg.pinv(mats)
        rds = []
        for v in range(n):
            s = sizes[v]
            diag = np.diagonal(Li[v])[:s]
            rd = Li[v, 0, 0] + diag - Li[v, 0, :s] - Li[v, :s, 0]
            rds.append(rd)
        extras["rd"] = np.concatenate(rds).astype(np.float32)[:, None]

    return GraphData(
        num_nodes=total,
        edge_index=big_ei,
        x=x_big,
        edge_attr=ea_big,
        y=g.y,
        extras=extras,
    )
