"""The ESC per-edge structural count vector, written out plainly.

For each edge (u, v) of a graph with a self-loop appended at every node,
the subgraph is the union of the h-hop balls around u and v. Its 1800
buckets (the ESC-GNN paper, arXiv:2303.10576, with its reference code's
quirks):

  [0, 200)      one count at each member's out-degree inside the subgraph
                (stored directed edges, self-loops included), clipped to 199
  [200, 300)    one count at each member's hop distance to u (h+1 if over h)
  [300, 400)    the same for v
  [400, 500)    one count at each member's resistance distance to u in the
                subgraph (self-loops ignored), cast to float32 and truncated
  [500, 1800)   one count per stored non-self-loop edge (a, b) inside the
                subgraph at 216 z0[a] + 36 z1[a] + 6 z0[b] + z1[b]

A self-loop edge (u, u) keeps the reference code's phantom copy of u: one
more member of degree 0, distances 0 and 0, resistance distance 0, and the
resistance distances of the real members are the diagonal of the pseudo-
inverse (the phantom root is disconnected).

Hop distances come from SciPy's breadth-first shortest paths, resistance
distances from an eigen-decomposition pseudo-inverse of each subgraph's
Laplacian in float64."""

from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import shortest_path

DIM = 1800
DEG, Z0, Z1, RD, ET = 0, 200, 300, 400, 500


def canonical_edges(num_nodes: int, edge_index: np.ndarray) -> np.ndarray:
    """The graph's non-self-loop edges in their order, then (i, i) for
    every node: (2, E) int64."""
    ei = np.asarray(edge_index, np.int64).reshape(2, -1)
    ei = ei[:, ei[0] != ei[1]]
    loops = np.arange(num_nodes, dtype=np.int64)
    return np.concatenate([ei, np.stack([loops, loops])], axis=1)


def encode(num_nodes: int, edge_index: np.ndarray, h: int = 3):
    """(edges (2, E), rows (E, 1800) float32 counts) of one graph."""
    n = int(num_nodes)
    edges = canonical_edges(n, edge_index)
    E = edges.shape[1]
    u, v = edges
    loop = u == v
    A = np.zeros((n, n), np.float64)
    np.add.at(A, (u, v), 1.0)  # stored directed edges with multiplicity
    offdiag = A.copy()
    np.fill_diagonal(offdiag, 0.0)
    hops = shortest_path(csr_matrix(offdiag), unweighted=True)
    hops = np.where(hops <= h, hops, h + 1).astype(np.int64)
    z0, z1 = hops[u], hops[v]  # (E, n)
    member = (z0 <= h) | (z1 <= h)
    rows = np.zeros((E, DIM), np.float64)
    e_of, w_of = np.nonzero(member)
    # out-degree inside the subgraph
    deg = (member.astype(np.float64) @ A.T).astype(np.int64)  # (E, n)
    np.add.at(rows, (e_of, np.minimum(deg[e_of, w_of], 199)), 1.0)
    np.add.at(rows, (e_of, Z0 + z0[e_of, w_of]), 1.0)
    np.add.at(rows, (e_of, Z1 + z1[e_of, w_of]), 1.0)
    # resistance distance to u over the subgraph's Laplacian
    mm = member[:, :, None] & member[:, None, :]
    sub = offdiag[None] * mm
    lap = np.zeros_like(sub)
    idx = np.arange(n)
    lap[:, idx, idx] = sub.sum(axis=2)
    lap -= sub
    pinv = np.linalg.pinv(lap, rcond=1e-10, hermitian=True)
    diag = np.diagonal(pinv, axis1=1, axis2=2)  # (E, n)
    ar = np.arange(E)
    rd = (diag[ar, u][:, None] + diag - pinv[ar, u, :] - pinv[ar, :, u])
    rd = np.where(loop[:, None], diag, rd)
    rd_bucket = np.clip(rd.astype(np.float32).astype(np.int64), 0, 99)
    np.add.at(rows, (e_of, RD + rd_bucket[e_of, w_of]), 1.0)
    # the phantom copy of a self-loop's root
    le = np.nonzero(loop)[0]
    for off in (DEG, Z0, Z1, RD):
        rows[le, off] += 1.0
    # edge types inside the subgraph
    nd = u != v
    a, b = u[nd], v[nd]
    inside = member[:, a] & member[:, b]  # (E, E_nd)
    t = 216 * z0[:, a] + 36 * z1[:, a] + 6 * z0[:, b] + z1[:, b]
    ef, jf = np.nonzero(inside)
    np.add.at(rows, (ef, ET + t[ef, jf]), 1.0)
    return edges, rows.astype(np.float32)


def encode_sparse(args):
    """`encode` for a process pool: (num_nodes, edge_index, h) ->
    (edges, (row, bucket) int32 pairs, counts float32)."""
    n, ei, h = args
    edges, rows = encode(n, ei, h)
    r, c = np.nonzero(rows)
    return edges, np.stack([r, c]).astype(np.int32), rows[r, c]
