"""Substructure-counting dataset (counterpart of
`escgnn_tpu/data/counting.py`; the graphs are bit-equal to the JAX
package's for the same config).

Capability mirror of the reference's `GraphCountDataset.py`: random graphs
with per-node substructure-count targets (y columns = 3..6-cycles for
`count_cycle`, five graphlets for `count_graphlet`,
`GraphCountDataset.py:34-120`). The reference ships the graphs as .mat
blobs (not distributed, `.MISSING_LARGE_BLOBS`); here the dataset is
regenerated deterministically from a seed and the targets are computed
exactly by DFS/enumeration — the commented-out oracle assertion at
reference `run_graphcount.py:497` made executable.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.data.graphlets import count_graphlets_per_node


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
    assert np.all(counts % 2 == 0)
    return counts // 2


# y-column counts per task; part of the featurization cache key so a
# target-schema change (e.g. adding the triangle-rectangle column)
# invalidates cached count_graphlet datasets instead of serving stale y
TARGET_COLUMNS = {"cycle": 4, "graphlet": 5}


@dataclasses.dataclass(frozen=True)
class CountingDatasetConfig:
    num_graphs: int = 1500
    seed: int = 0
    task: str = "cycle"  # cycle | graphlet
    n_min: int = 10
    n_max: int = 24
    avg_degree: float = 3.0
    train_frac: float = 0.8
    val_frac: float = 0.1


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


def generate_counting_graphs(cfg: CountingDatasetConfig) -> dict:
    """Deterministic train/val/test splits of counting graphs.

    Each graph: x = ones(n, 10) (the reference's featureless input,
    `GraphCountDataset.py:69-84`), y = (n, 4) float32 exact counts.
    """
    rng = np.random.default_rng(cfg.seed)
    graphs = []
    for _ in range(cfg.num_graphs):
        n = int(rng.integers(cfg.n_min, cfg.n_max + 1))
        p = min(cfg.avg_degree / max(n - 1, 1), 0.9)
        ei = _random_connected_graph(rng, n, p)
        if cfg.task == "graphlet":
            y = count_graphlets_per_node(n, ei)
        else:
            y = count_cycles_per_node(n, ei)
        graphs.append(
            GraphData(
                num_nodes=n,
                edge_index=ei,
                x=np.ones((n, 10), np.float32),
                y=y.astype(np.float32),
            )
        )
    n_tr = int(cfg.train_frac * cfg.num_graphs)
    n_val = int(cfg.val_frac * cfg.num_graphs)
    return {
        "train": graphs[:n_tr],
        "val": graphs[n_tr:n_tr + n_val],
        "test": graphs[n_tr + n_val:],
    }


def normalize_targets(splits: dict, target: int):
    """Select y column `target` and standardize by the train split's
    mean/std (the reference normalizes before its L1 loss and reports
    MAE x std, `run_graphcount.py:441-449,520`). Returns
    (splits, mean, std); y becomes (n, 1) float32 in-place."""
    ys = np.concatenate([g.y[:, target] for g in splits["train"]])
    mean, std = float(ys.mean()), float(ys.std())
    std = max(std, 1e-8)
    for graphs in splits.values():
        for g in graphs:
            g.y = ((g.y[:, target] - mean) / std).astype(np.float32)[:, None]
    return splits, mean, std
