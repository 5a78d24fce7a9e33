"""(root, neighbor)-pair subgraph copies — the I²GNN pre-transform (copy of
`escgnn_tpu/featurize/pair_subgraphs.py`, bit-equal output).

Mirror of reference `utils_edge_I2.py:132-256` (`create_subgraphs2`) +
`subgraph_to_subgraph2_with_idx` (`:726-813`): for every node v, extract
its h-hop ego-net once, then tile it deg(v) times — copy i marks neighbor
n_i with label 2 (hop labeling), carries a 2-column resistance distance
(to root, to neighbor), and records the (root, neighbor) node pair in
`center_idx`. Output keys: `node_to_subgraph2` (node -> copy),
`subgraph2_to_subgraph` (copy -> root subgraph), `node_to_original_node`,
plus z / rd node-aligned arrays — consumed by the I2GNN model's
three-level pooling cascade.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.featurize.bfs import hop_distance_matrix


@dataclasses.dataclass(frozen=True)
class PairSubgraphConfig:
    h: int = 3
    use_rd: bool = False
    self_loop: bool = False  # add the root itself as an extra "neighbor"

    def cache_key(self) -> str:
        key = f"i2_h{self.h}"
        if self.use_rd:
            key += "_rd"
        if self.self_loop:
            key += "_sl"
        return key


def _subgraph_rd_matrix(A_sub: np.ndarray) -> np.ndarray:
    """All-pairs resistance distance of one subgraph (float64 pinv)."""
    deg = A_sub.sum(1)
    L = np.diag(deg) - A_sub
    Li = np.linalg.pinv(L)
    d = np.diagonal(Li)
    return (d[:, None] + d[None, :] - Li - Li.T).astype(np.float32)


def create_pair_subgraphs(g: GraphData, cfg: PairSubgraphConfig) -> GraphData:
    n = g.num_nodes
    ei = np.asarray(g.edge_index, np.int64)
    D = hop_distance_matrix(n, ei, cfg.h)
    member = D <= cfg.h

    xs, eas, zs, rds = [], [], [], []
    srcs, dsts = [], []
    node_to_s2, s2_to_s1, centers, node_orig = [], [], [], []
    n_off = 0
    s2_off = 0
    adj = [np.flatnonzero((ei[0] == v)) for v in range(n)]

    for v in range(n):
        nodes = np.flatnonzero(member[v])
        nodes = np.concatenate([[v], nodes[nodes != v]])
        local = np.full(n, -1, np.int64)
        local[nodes] = np.arange(len(nodes))
        s = len(nodes)
        em = member[v][ei[0]] & member[v][ei[1]]
        idx = np.flatnonzero(em)
        se, de = local[ei[0, idx]], local[ei[1, idx]]
        z_base = D[v][nodes].astype(np.int64)  # root-rooted hop labels

        # neighbors of the root (within the subgraph = all 1-hop nbrs)
        nbrs = [int(local[ei[1, e]]) for e in adj[v] if ei[1, e] != v]
        nbrs = sorted(set(nbrs))
        if cfg.self_loop:
            nbrs = nbrs + [0]
        if not nbrs:
            nbrs = [0]

        if cfg.use_rd:
            A_sub = np.zeros((s, s))
            np.add.at(A_sub, (se, de), 1.0)
            np.fill_diagonal(A_sub, 0.0)
            rd_mat = _subgraph_rd_matrix(A_sub)

        for ci, nb in enumerate(nbrs):
            z_copy = z_base.copy()
            z_copy[nb] = 2  # mark the neighbor (reference: z_n[n] = 2)
            zs.append(z_copy[:, None])
            if cfg.use_rd:
                rds.append(
                    np.stack([rd_mat[0], rd_mat[nb]], axis=1)
                )
            if g.x is not None:
                xs.append(np.asarray(g.x)[nodes])
            if g.edge_attr is not None:
                eas.append(np.asarray(g.edge_attr)[idx])
            srcs.append(se + n_off)
            dsts.append(de + n_off)
            node_to_s2.append(np.full(s, s2_off + ci, np.int64))
            centers.append([n_off, n_off + nb])
            node_orig.append(nodes)
            n_off += s
        s2_to_s1.extend([v] * len(nbrs))
        s2_off += len(nbrs)

    extras = {
        "z": np.concatenate(zs, axis=0),
        "node_to_subgraph2": np.concatenate(node_to_s2)
        - 0,  # already global within graph
        "num_subgraphs2": s2_off,
        "subgraph2_to_subgraph": np.asarray(s2_to_s1, np.int64),
        "num_subgraphs": n,
        "center_idx": np.asarray(centers, np.int64),
        "node_to_original_node": np.concatenate(node_orig),
        "num_original_nodes": n,
    }
    if cfg.use_rd:
        extras["rd"] = np.concatenate(rds, axis=0)

    return GraphData(
        num_nodes=n_off,
        edge_index=np.stack(
            [np.concatenate(srcs), np.concatenate(dsts)]
        ).astype(np.int32),
        x=np.concatenate(xs, axis=0) if xs else None,
        edge_attr=np.concatenate(eas, axis=0) if eas else None,
        y=g.y,
        extras=extras,
    )
