"""Random connected graphs with exact per-node cycle counts, drawn from a
seed.

Frozen copy of `escgnn_tpu_torch/data/counting.py`
`_random_connected_graph`, `count_cycles_per_node` and the draw of
`generate_counting_graphs` at commit 260b663 (task "cycle"). The
topologies are drawn in one sequence from the seed; the counts, a depth-
first search in Python and nearly all of the cost, are then made by
`workers` spawned processes. The same seed gives the same graphs."""

from __future__ import annotations

import multiprocessing as mp

import numpy as np

from perfbench.rawgraph import RawGraph


def count_cycles_per_node(num_nodes: int, edge_index) -> np.ndarray:
    """Exact per-node simple-cycle participation counts.

    Returns (num_nodes, 4) int64: columns = number of 3-, 4-, 5-, 6-cycles
    through each node. DFS rooted at each cycle's minimum node; each
    undirected cycle is found once per direction, so counts are halved.
    """
    ei = np.asarray(edge_index)
    adj: list[list[int]] = [[] for _ in range(num_nodes)]
    seen = set()
    for a, b in zip(ei[0].tolist(), ei[1].tolist()):
        if a != b and (a, b) not in seen:
            seen.add((a, b))
            adj[a].append(b)
    counts = np.zeros((num_nodes, 4), np.int64)
    max_len = 6
    path = [0] * (max_len + 1)
    on_path = [False] * num_nodes

    def dfs(root: int, v: int, depth: int):
        path[depth] = v
        on_path[v] = True
        for w in adj[v]:
            if w == root and depth >= 2:
                # cycle of length depth+1 (each counted twice overall)
                for u in path[: depth + 1]:
                    counts[u, depth - 2] += 1
            elif depth + 1 < max_len and w > root and not on_path[w]:
                dfs(root, w, depth + 1)
        on_path[v] = False

    for r in range(num_nodes):
        dfs(r, r, 0)
    if np.any(counts % 2):
        raise AssertionError("a cycle was found in one direction only")
    return counts // 2


def _random_connected_graph(rng: np.random.Generator, n: int, p: float):
    """ER graph + a random spanning path so every node sits in one
    component (isolated nodes carry no counting signal)."""
    upper = np.triu(rng.random((n, n)) < p, k=1)
    order = rng.permutation(n)
    upper[np.minimum(order[:-1], order[1:]),
          np.maximum(order[:-1], order[1:])] = True
    a, b = np.nonzero(upper)
    ei = np.stack(
        [np.concatenate([a, b]), np.concatenate([b, a])]
    ).astype(np.int32)
    return ei


def _counts(args) -> np.ndarray:
    n, ei = args
    return count_cycles_per_node(n, ei)


def generate(params: dict, seed: int, workers: int = 1) -> list[RawGraph]:
    """`params["num_graphs"]` graphs of `n_min`..`n_max` nodes at mean
    degree `avg_degree`; x = ones(n, 10), y = (n, 4) float32 counts of
    3- to 6-cycles through each node."""
    if params.get("task", "cycle") != "cycle":
        raise ValueError("the counting generator makes the cycle task only")
    rng = np.random.default_rng(seed)
    tops = []
    for _ in range(int(params["num_graphs"])):
        n = int(rng.integers(int(params["n_min"]), int(params["n_max"]) + 1))
        p = min(float(params["avg_degree"]) / max(n - 1, 1), 0.9)
        tops.append((n, _random_connected_graph(rng, n, p)))
    if workers > 1 and len(tops) > 64:
        with mp.get_context("spawn").Pool(workers) as pool:
            ys = pool.map(_counts, tops, chunksize=64)
            pool.close()
            pool.join()
    else:
        ys = [_counts(t) for t in tops]
    return [RawGraph(num_nodes=n, edge_index=ei,
                     x=np.ones((n, 10), np.float32), y=y.astype(np.float32))
            for (n, ei), y in zip(tops, ys)]
