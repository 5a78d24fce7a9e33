"""Edge-rooted subgraph copies — the non-efficient ESC-GNN pre-transform (copy of
`escgnn_tpu/featurize/edge_subgraphs.py`, bit-equal output).

Mirror of reference `utils_edge.py:19-157` (`create_subgraphs`): for every
edge (u, v) of the (optionally self-looped) graph, materialize one
relabeled copy of the UNION of u's and v's h-hop ego-nets, with the
2-column hop-distance labels z = (d_u, d_v) (h + 1 for unreachable) and
optional resistance distance to the two roots. All copies compose into
one disconnected graph with `node_to_subgraph` (node -> edge copy) and
`subgraph_to_graph` — the same two-level pooling indices as the NGNN
node-copy transform, so the copy-based models (NGNN/BaselineGNN
nested=True) run on these batches unchanged.

With self_loop=True every node contributes a (v, v) copy too, which is
how edge-level nesting subsumes node-level nesting
(`utils_edge_efficient.py:33-36` — same convention as the efficient
encoder; copies are rooted at the canonical self-looped edge list:
original edges first, then one loop per node).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.featurize.bfs import hop_distance_matrix


@dataclasses.dataclass(frozen=True)
class EdgeSubgraphConfig:
    h: int = 3
    use_rd: bool = False
    self_loop: bool = True

    def cache_key(self) -> str:
        key = f"edgecopy_h{self.h}"
        if self.use_rd:
            key += "_rd"
        if self.self_loop:
            key += "_self"
        return key


def canonical_edge_list(edge_index: np.ndarray, n: int, self_loop: bool):
    """Remove self loops; optionally append one (v, v) per node — the
    reference's remove_self_loops + add_self_loops ordering."""
    ei = np.asarray(edge_index, np.int64)
    keep = ei[0] != ei[1]
    ei = ei[:, keep]
    if self_loop:
        loops = np.arange(n, dtype=np.int64)
        ei = np.concatenate([ei, np.stack([loops, loops])], axis=1)
    return ei


def create_edge_subgraphs(g: GraphData, cfg: EdgeSubgraphConfig) -> GraphData:
    n = g.num_nodes
    h = cfg.h
    ei_orig = np.asarray(g.edge_index, np.int64)
    ei = canonical_edge_list(ei_orig, n, cfg.self_loop)
    num_copies = ei.shape[1]
    D = hop_distance_matrix(n, ei_orig, h)  # (N, N), cap h+1

    copies, z_cols = [], []
    for e in range(num_copies):
        u, v = int(ei[0, e]), int(ei[1, e])
        member = (D[u] <= h) | (D[v] <= h)
        nodes = np.flatnonzero(member)
        # roots first (u then v if distinct), then the rest ascending
        roots = [u] if u == v else [u, v]
        rest = nodes[~np.isin(nodes, roots)]
        order = np.concatenate([roots, rest])
        copies.append(order)
        z_cols.append(np.stack([D[u][order], D[v][order]], axis=1))
    sizes = np.asarray([len(c) for c in copies])
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    total = int(offsets[-1])

    new_src, new_dst, new_eid = [], [], []
    member_all = D <= h
    for e, nodes in enumerate(copies):
        u, v = int(ei[0, e]), int(ei[1, e])
        inset = np.zeros(n, bool)
        inset[nodes] = True
        local = np.full(n, -1, np.int64)
        local[nodes] = np.arange(len(nodes))
        em = inset[ei_orig[0]] & inset[ei_orig[1]]
        idx = np.flatnonzero(em)
        new_src.append(local[ei_orig[0, idx]] + offsets[e])
        new_dst.append(local[ei_orig[1, idx]] + offsets[e])
        new_eid.append(idx)
    big_ei = np.stack(
        [np.concatenate(new_src), np.concatenate(new_dst)]
    ).astype(np.int32)
    eid = np.concatenate(new_eid)

    z = np.concatenate(z_cols, axis=0).astype(np.int64)
    node_to_subgraph = np.concatenate(
        [np.full(s, e, np.int64) for e, s in enumerate(sizes)]
    )
    x_big = None
    if g.x is not None:
        x_big = np.concatenate(
            [np.asarray(g.x)[c] for c in copies], axis=0
        )
    ea_big = None
    if g.edge_attr is not None:
        ea_big = np.asarray(g.edge_attr)[eid]

    extras = {
        "z": z,
        "node_to_subgraph": node_to_subgraph,
        "num_subgraphs": num_copies,
        "num_original_nodes": n,
        "node_to_original_node": np.concatenate(copies).astype(np.int64),
    }

    if cfg.use_rd:
        max_s = int(sizes.max())
        A = np.zeros((n, n), np.float64)
        np.add.at(A, (ei_orig[0], ei_orig[1]), 1.0)
        np.fill_diagonal(A, 0.0)
        mats = np.zeros((num_copies, max_s, max_s))
        for e, nodes in enumerate(copies):
            s = len(nodes)
            sub = A[np.ix_(nodes, nodes)]
            L = np.diag(sub.sum(1)) - sub
            mats[e, :s, :s] = L
        Li = np.linalg.pinv(mats)
        rds = []
        for e in range(num_copies):
            s = sizes[e]
            diag = np.diagonal(Li[e])[:s]
            rd = Li[e, 0, 0] + diag - Li[e, 0, :s] - Li[e, :s, 0]
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
