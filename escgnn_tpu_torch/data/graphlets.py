"""Per-node induced graphlet counts (counterpart of
`escgnn_tpu/data/graphlets.py`, pure numpy).

The `count_graphlet` targets of the reference's counting benchmark
(`GraphCountDataset.py`, README `count_graphlet` runs, targets 0-4):
for every node, the number of induced subgraphs of each type it belongs
to — columns = [tailed triangle, chordal cycle (diamond), 4-clique,
4-path (P4), triangle-rectangle]. The first four are 4-node graphlets,
counted by exact enumeration over all C(n, 4) node subsets (vectorized:
one (Q, 4, 4) adjacency gather; n <= ~30 in the benchmark so Q <= ~30k).
The fifth is the 6-node motif of a triangle and a chordless 4-cycle
sharing exactly one vertex (induced: the 6-node subgraph has exactly the
7 motif edges), counted by crossing the triangle list with the
induced-C4 list.
"""

from __future__ import annotations

import itertools

import numpy as np


def _adj(num_nodes: int, edge_index) -> np.ndarray:
    ei = np.asarray(edge_index)
    A = np.zeros((num_nodes, num_nodes), bool)
    A[ei[0], ei[1]] = True
    A |= A.T
    np.fill_diagonal(A, False)
    return A


def count_graphlets_per_node(num_nodes: int, edge_index) -> np.ndarray:
    A = _adj(num_nodes, edge_index)
    counts = np.zeros((num_nodes, 5), np.int64)
    if num_nodes < 3:
        return counts

    tris = np.asarray(
        list(itertools.combinations(range(num_nodes), 3)), np.int64
    )
    tri_mask = (
        A[tris[:, 0], tris[:, 1]]
        & A[tris[:, 1], tris[:, 2]]
        & A[tris[:, 0], tris[:, 2]]
    )
    triangles = tris[tri_mask]

    c4s = np.zeros((0, 4), np.int64)
    if num_nodes >= 4:
        quads = np.asarray(
            list(itertools.combinations(range(num_nodes), 4)), np.int64
        )
        sub = A[quads[:, :, None], quads[:, None, :]]  # (Q, 4, 4)
        deg = sub.sum(2)
        ne = deg.sum(1) // 2
        degmax = deg.max(1)
        col_masks = [
            (ne == 4) & (degmax == 3),                    # tailed triangle
            ne == 5,                                      # diamond
            ne == 6,                                      # 4-clique
            (ne == 3) & (degmax == 2) & (deg.min(1) == 1),  # induced P4
        ]
        for col, m in enumerate(col_masks):
            np.add.at(counts[:, col], quads[m].ravel(), 1)
        c4s = quads[(ne == 4) & (degmax == 2)]  # chordless 4-cycles

    # triangle-rectangle: triangle x induced C4 sharing exactly one
    # vertex, no extra edges in the 6-node union (7 induced edges)
    if len(triangles) and len(c4s):
        memT = np.zeros((len(triangles), num_nodes), bool)
        memT[np.arange(len(triangles))[:, None], triangles] = True
        memC = np.zeros((len(c4s), num_nodes), bool)
        memC[np.arange(len(c4s))[:, None], c4s] = True
        inter = memT.astype(np.int64) @ memC.T.astype(np.int64)
        for ti, ci in np.argwhere(inter == 1):
            union = np.flatnonzero(memT[ti] | memC[ci])
            if int(A[np.ix_(union, union)].sum()) // 2 == 7:
                counts[union, 4] += 1
    return counts


def count_graphlets_per_node_slow(num_nodes: int, edge_index) -> np.ndarray:
    """Straight-line per-subset oracle (the original implementation);
    kept as the equivalence reference for tests."""
    A = _adj(num_nodes, edge_index)
    counts = np.zeros((num_nodes, 5), np.int64)
    c4s: list[tuple[int, ...]] = []
    for quad in itertools.combinations(range(num_nodes), 4):
        sub = A[np.ix_(quad, quad)]
        deg = sub.sum(1)
        ne = int(deg.sum()) // 2
        col = -1
        if ne == 6:
            col = 2
        elif ne == 5:
            col = 1
        elif ne == 4 and deg.max() == 3:
            col = 0
        elif ne == 4 and deg.max() == 2:
            c4s.append(quad)
        elif ne == 3 and deg.max() == 2 and deg.min() == 1:
            col = 3
        if col >= 0:
            counts[list(quad), col] += 1
    triangles = [
        t for t in itertools.combinations(range(num_nodes), 3)
        if A[t[0], t[1]] and A[t[1], t[2]] and A[t[0], t[2]]
    ]
    for tri in triangles:
        ts = set(tri)
        for quad in c4s:
            if len(ts.intersection(quad)) != 1:
                continue
            union = list(ts.union(quad))
            if int(A[np.ix_(union, union)].sum()) // 2 == 7:
                counts[union, 4] += 1
    return counts
