"""Vectorized all-pairs h-hop BFS (copy of `escgnn_tpu/featurize/bfs.py`,
without the sampled variant).

Every edge's labels only need hop distances *from each node*, so the full
capped distance matrix is computed once per graph with boolean frontier
propagation (h sparse-matrix steps); every per-edge quantity is then a
row lookup.

BFS direction matches the reference's `flow='source_to_target'`: from a
frontier node x, the next frontier is all senders s of edges (s -> x). For
undirected graphs (both directions stored) this is ordinary BFS.
"""

from __future__ import annotations

import numpy as np


def hop_distance_matrix(
    num_nodes: int, edge_index: np.ndarray, num_hops: int
) -> np.ndarray:
    """Capped BFS distance matrix.

    Returns D of shape (N, N) int16 with D[r, w] = hop distance from root r
    to w following edges backwards (sender <- receiver), capped at
    num_hops + 1 for nodes unreachable within num_hops.
    """
    n = num_nodes
    cap = num_hops + 1
    # B[x, s] = True iff edge (s -> x) exists: one frontier step is
    # frontier_row @ B.
    B = np.zeros((n, n), dtype=bool)
    if edge_index.size:
        B[edge_index[1], edge_index[0]] = True
    D = np.full((n, n), cap, dtype=np.int16)
    np.fill_diagonal(D, 0)
    reach = np.eye(n, dtype=bool)
    frontier = np.eye(n, dtype=bool)
    for k in range(1, num_hops + 1):
        frontier = (frontier @ B) & ~reach
        if not frontier.any():
            break
        D[frontier] = k
        reach |= frontier
    return D
