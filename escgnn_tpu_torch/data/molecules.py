"""Synthetic ZINC-shaped molecules (counterpart of the synthetic branch of
`escgnn_tpu/data/molecules.py`).

Deterministic graphs with ZINC-12k's shapes and statistics: ~23 heavy
atoms, 28 node types, 4 bond types and a scalar regression target that
is a structural function of the graph (so models can learn it). The
real-pickle branch of the JAX package waits until a ZINC artifact is in
the repository.
"""

from __future__ import annotations

import numpy as np

from escgnn_tpu_torch.data.container import GraphData


def _molecule_skeleton(rng: np.random.Generator, n: int):
    """Connected sparse graph: a random path plus a few short chords
    (ring bonds) — ZINC-like degree statistics."""
    order = rng.permutation(n)
    src = [order[:-1]]
    dst = [order[1:]]
    extra = max(2, n // 6)
    c1 = rng.integers(0, n, extra)
    c2 = (c1 + rng.integers(2, 5, extra)) % n
    keep = c1 != c2
    src.append(c1[keep])
    dst.append(c2[keep])
    a = np.concatenate(src)
    b = np.concatenate(dst)
    # dedupe undirected pairs
    key = np.minimum(a, b) * n + np.maximum(a, b)
    _, uniq = np.unique(key, return_index=True)
    a, b = a[uniq], b[uniq]
    ei = np.stack(
        [np.concatenate([a, b]), np.concatenate([b, a])]
    ).astype(np.int32)
    return ei


def _num_triangles(n: int, ei: np.ndarray) -> int:
    A = np.zeros((n, n), np.float64)
    A[ei[0], ei[1]] = 1.0
    return int(round(np.trace(A @ A @ A) / 6.0))


def synthetic_zinc(num_graphs: int = 2000, seed: int = 0) -> list[GraphData]:
    """ZINC-shaped graphs: x (n, 1) int node types in [0, 28), edge_attr
    (E,) int bond types in [1, 4), y (1,) float32 — a deterministic
    structural pseudo-"solubility"."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        n = int(rng.integers(18, 30))
        ei = _molecule_skeleton(rng, n)
        x = rng.integers(0, 28, n).astype(np.int32)[:, None]
        ea = rng.integers(1, 4, ei.shape[1]).astype(np.int32)
        tri = _num_triangles(n, ei)
        deg = np.bincount(ei[1], minlength=n)
        y = (
            0.05 * n
            - 0.4 * tri
            + 0.1 * float((x[:, 0] % 5).mean())
            - 0.2 * float(deg.std())
        )
        out.append(
            GraphData(
                num_nodes=n,
                edge_index=ei,
                x=x,
                edge_attr=ea,
                y=np.asarray([y], np.float32),
            )
        )
    return out


def zinc_splits(num_graphs: int = 2000, seed: int = 0) -> dict:
    """Deterministic 80/10/10 split of `synthetic_zinc`."""
    raw = synthetic_zinc(num_graphs=num_graphs, seed=seed)
    n_tr, n_val = int(0.8 * len(raw)), int(0.1 * len(raw))
    return {
        "train": raw[:n_tr],
        "val": raw[n_tr:n_tr + n_val],
        "test": raw[n_tr + n_val:],
    }
