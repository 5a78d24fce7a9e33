"""ZINC molecules (counterpart of the ZINC part of
`escgnn_tpu/data/molecules.py`).

The reference's ZINC artifact is read when it is present
(`load_zinc_pickle`); otherwise `synthetic_zinc` makes deterministic
graphs with ZINC-12k's shapes and statistics: ~23 heavy atoms, 28 node
types, 4 bond types and a scalar regression target that is a structural
function of the graph (so models can learn it).
"""

from __future__ import annotations

import os

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


def load_zinc_pickle(path: str) -> dict:
    """Parse the reference's ZINC artifact (`dataset_zinc.py:45-73`): a
    pickle of (train, val, test) lists of dicts with 'x' (node one-hots or
    type ids), 'A' (bond_types, n, n) stacked adjacency and 'y' targets.
    Returns {'train', 'val', 'test'} lists of GraphData with the
    reference's conversion: edges where A sums to 1 over the bond types,
    edge type = argmax over the bond axis, y = the last target.

    Unpickling can run code: load only the reference's own artifact."""
    import pickle

    with open(path, "rb") as f:
        raw_all = pickle.load(f)
    out = {}
    for name, raw in zip(("train", "val", "test"), raw_all):
        graphs = []
        for d in raw:
            x = np.asarray(d["x"])
            A = np.asarray(d["A"])
            y = np.asarray(d["y"], np.float32).reshape(-1)[-1:]
            begin, end = np.where(A.sum(axis=0) == 1.0)
            edge_attr = np.argmax(A[:, begin, end].T, axis=-1).astype(np.int32)
            if x.ndim == 2 and x.shape[1] > 1:
                x = np.argmax(x, axis=1)
            x = x.reshape(-1, 1).astype(np.int32)
            graphs.append(GraphData(
                num_nodes=int(x.shape[0]),
                edge_index=np.stack([begin, end]).astype(np.int32),
                x=x,
                edge_attr=edge_attr,
                y=y,
            ))
        out[name] = graphs
    return out


def zinc_splits(data_dir: str, num_graphs: int = 2000,
                seed: int = 0) -> tuple[dict, bool]:
    """The real ZINC splits when the reference artifact
    (`<data_dir>/ZINC.pkl` or `<data_dir>/zinc/raw/ZINC.pkl`) exists,
    otherwise a deterministic 80/10/10 split of `synthetic_zinc`. Returns
    (splits, is_real)."""
    for cand in (os.path.join(data_dir, "ZINC.pkl"),
                 os.path.join(data_dir, "zinc", "raw", "ZINC.pkl")):
        if os.path.exists(cand):
            return load_zinc_pickle(cand), True
    raw = synthetic_zinc(num_graphs=num_graphs, seed=seed)
    n_tr, n_val = int(0.8 * len(raw)), int(0.1 * len(raw))
    return {
        "train": raw[:n_tr],
        "val": raw[n_tr:n_tr + n_val],
        "test": raw[n_tr + n_val:],
    }, False
