"""Vectorized all-pairs h-hop BFS (copy of `escgnn_tpu/featurize/bfs.py`).

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


def _sample_frontier(cand_nodes: np.ndarray, cap: int, seed: int,
                     root: int, hop: int) -> np.ndarray:
    """Canonical deterministic frontier subsample: permutation of the
    ASCENDING candidate list under a rng derived from (seed, root, hop),
    first `cap` kept. Both the vectorized matrix BFS and the per-edge
    oracle call exactly this, so their sampled ego-nets are bit-equal
    (the reference re-samples per edge with a global rng,
    `utils_edge_efficient.py:238-240`; deriving the stream per (root,
    hop) determinizes that choice — one consistent subgraph per root)."""
    rng = np.random.default_rng([seed, root, hop])
    keep = rng.permutation(cand_nodes.shape[0])[:cap]
    return cand_nodes[keep]


def sampled_hop_distance_matrix(
    num_nodes: int,
    edge_index: np.ndarray,
    num_hops: int,
    max_nodes_per_hop: int,
    seed: int,
) -> np.ndarray:
    """`hop_distance_matrix` with the reference's per-hop frontier
    subsampling (`max_nodes_per_hop`): when a root's hop-k frontier
    exceeds the cap, a deterministic subsample survives; non-sampled
    nodes stay undiscovered and may re-enter at a later hop through a
    surviving frontier node (exactly the reference's visited-set
    semantics). D[r, w] = discovery hop of w in root r's SAMPLED BFS,
    num_hops + 1 if never discovered."""
    n = num_nodes
    cap_d = num_hops + 1
    B = np.zeros((n, n), dtype=bool)
    if edge_index.size:
        B[edge_index[1], edge_index[0]] = True
    D = np.full((n, n), cap_d, dtype=np.int16)
    np.fill_diagonal(D, 0)
    reach = np.eye(n, dtype=bool)
    frontier = np.eye(n, dtype=bool)
    for k in range(1, num_hops + 1):
        cand = (frontier @ B) & ~reach
        counts = cand.sum(axis=1)
        for r in np.flatnonzero(counts > max_nodes_per_hop):
            nodes = np.flatnonzero(cand[r])  # ascending — canonical order
            keep = _sample_frontier(nodes, max_nodes_per_hop, seed, int(r), k)
            cand[r] = False
            cand[r, keep] = True
        if not cand.any():
            break
        D[cand] = k
        reach |= cand
        frontier = cand
    return D
