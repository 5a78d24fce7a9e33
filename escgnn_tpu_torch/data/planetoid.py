"""Planetoid citation datasets (Cora / Citeseer / PubMed; a copy of
`escgnn_tpu/data/planetoid.py`).

Mirrors the reference's Planetoid dispatch in its dataset factory
(`kernel/datasets.py:47,68-69` — `Planetoid(path, name, pre_transform)`),
which feeds the single-graph node-split cycle trainers
(`kernel/train_eval.py:359-561`). Reads the standard Planetoid raw
format (`ind.<name>.{x,tx,allx,y,ty,ally,graph,test.index}` — pickled
scipy sparse matrices + adjacency dict) when the files exist under
`<root>/<Name>/raw`, and falls back to a deterministic synthetic
citation-style graph otherwise, the same real-if-present convention as `data/tu.py`.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from escgnn_tpu_torch.data.container import GraphData

PLANETOID_NAMES = ("Cora", "Citeseer", "PubMed")


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _to_dense(m) -> np.ndarray:
    try:  # scipy sparse
        return np.asarray(m.todense(), np.float32)
    except AttributeError:
        return np.asarray(m, np.float32)


def load_planetoid_raw(root: str, name: str) -> GraphData:
    """Assemble the full graph from the raw Planetoid splits: rows of
    `allx`+`tx` (test rows permuted to `test.index` order), labels from
    `ally`+`ty`, undirected edges from the `graph` adjacency dict."""
    low = name.lower()
    raw = os.path.join(root, name, "raw")
    parts = {}
    for suffix in ("x", "tx", "allx", "y", "ty", "ally", "graph"):
        parts[suffix] = _load_pickle(os.path.join(raw, f"ind.{low}.{suffix}"))
    test_idx = np.loadtxt(
        os.path.join(raw, f"ind.{low}.test.index"), dtype=np.int64
    )

    allx = _to_dense(parts["allx"])
    tx = _to_dense(parts["tx"])
    ally = np.asarray(parts["ally"], np.float32)
    ty = np.asarray(parts["ty"], np.float32)

    sorted_test = np.sort(test_idx)
    n = int(sorted_test.max()) + 1
    d = allx.shape[1]
    x = np.zeros((n, d), np.float32)
    x[: allx.shape[0]] = allx
    y_onehot = np.zeros((n, ally.shape[1]), np.float32)
    y_onehot[: ally.shape[0]] = ally
    # test rows arrive in test.index order; Citeseer has holes in the
    # test range (isolated nodes left all-zero)
    for row, idx in zip(tx, test_idx):
        x[idx] = row
    for row, idx in zip(ty, test_idx):
        y_onehot[idx] = row
    y = y_onehot.argmax(axis=1).astype(np.int64)

    src, dst = [], []
    for u, nbrs in parts["graph"].items():
        for v in nbrs:
            if u < n and v < n and u != v:
                src.append(u)
                dst.append(v)
    ei = np.stack([np.asarray(src + dst), np.asarray(dst + src)])
    # coalesce duplicates
    key = ei[0].astype(np.int64) * n + ei[1]
    _, keep = np.unique(key, return_index=True)
    ei = ei[:, np.sort(keep)].astype(np.int64)
    return GraphData(num_nodes=n, edge_index=ei, x=x, y=y[:, None])


def synthetic_planetoid(
    name: str, num_nodes: int = 600, num_classes: int = 6,
    feat_dim: int = 64, seed: int = 0,
) -> GraphData:
    """Deterministic citation-style stand-in: a stochastic block model
    (strong in-class preference) with class-correlated bag-of-words
    features — enough structure for the node-split trainers to learn."""
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    labels = rng.integers(0, num_classes, num_nodes)
    p_in, p_out = 0.02, 0.002
    same = labels[:, None] == labels[None, :]
    prob = np.where(same, p_in, p_out)
    upper = np.triu(rng.random((num_nodes, num_nodes)) < prob, k=1)
    a, b = np.nonzero(upper | upper.T)
    ei = np.stack([a, b]).astype(np.int64)
    centers = rng.random((num_classes, feat_dim)) < 0.15
    flip = rng.random((num_nodes, feat_dim)) < 0.05
    x = (centers[labels] ^ flip).astype(np.float32)
    return GraphData(
        num_nodes=num_nodes, edge_index=ei, x=x,
        y=labels.astype(np.int64)[:, None],
    )


def get_planetoid(
    name: str, root: str = "data/Planetoid", pre_transform=None
) -> GraphData:
    """One `GraphData` citation graph; real raw files if present, else
    the synthetic stand-in."""
    if name not in PLANETOID_NAMES:
        raise ValueError(f"Planetoid name {name!r}: one of {PLANETOID_NAMES}")
    try:
        g = load_planetoid_raw(root, name)
    except (FileNotFoundError, OSError):
        g = synthetic_planetoid(name)
    if pre_transform is not None:
        g = pre_transform(g)
    return g
