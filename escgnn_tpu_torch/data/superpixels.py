"""Superpixel graph-classification datasets (MNIST / CIFAR10 stand-ins;
a copy of `escgnn_tpu/data/superpixels.py`).

The reference's GraphGPS fork loads the GNNBenchmark superpixel datasets
through `preformat_GNNBenchmarkDataset` in
`GraphGPS/graphgps/loader/master_loader.py` (MNIST/CIFAR10 rows of the
dataset zoo; node features are superpixel intensity + (x, y) centroid,
edges are a k-NN graph over centroids, and the task is 10-class graph
classification with LINEAR — not embedding — feature encoders).  The
artifacts are not in the repository, so this module provides:

* `load_superpixel_pickle` — reader for a pre-extracted artifact:
  a pickle of `{split: [ {x, edge_index, (edge_attr), y}, ... ]}`.
* `synthetic_superpixels` — deterministic generator with the real
  datasets' shapes and statistics: ~40–75 superpixels in the unit
  square, 8-NN connectivity, distance edge features, and a 10-class
  label that is a learnable function of the node-feature field (the
  class controls how many bright blobs are painted and their hue), so
  drivers/models can actually train on it.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from escgnn_tpu_torch.data.container import GraphData

NUM_CLASSES = 10


def _knn_edges(pos: np.ndarray, k: int = 8) -> np.ndarray:
    """Symmetrized k-nearest-neighbour edge list over 2-D centroids
    (the GNNBenchmark superpixel construction)."""
    n = pos.shape[0]
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    kk = min(k, n - 1)
    nbr = np.argsort(d2, axis=1)[:, :kk]
    src = np.repeat(np.arange(n), kk)
    dst = nbr.reshape(-1)
    a = np.concatenate([src, dst])
    b = np.concatenate([dst, src])
    key = a * n + b
    _, uniq = np.unique(key, return_index=True)
    return np.stack([a[uniq], b[uniq]]).astype(np.int32)


def synthetic_superpixels(
    name: str = "MNIST",
    num_graphs: int = 600,
    seed: int = 0,
) -> list[GraphData]:
    """Superpixel-shaped graphs.

    MNIST: x = (n, 3) float [intensity, cx, cy]; CIFAR10: x = (n, 5)
    float [r, g, b, cx, cy].  edge_attr = (E, 1) float centroid
    distance.  y = (1,) int class in [0, 10).  The class determines the
    number of bright Gaussian blobs (1 + c % 5) and, for CIFAR10, the
    dominant hue (c / 10) — a deterministic, structure-plus-feature
    signal standing in for digit/object identity.
    """
    name = name.upper()
    if name not in ("MNIST", "CIFAR10"):
        raise ValueError(f"unknown superpixel dataset {name!r}")
    rng = np.random.default_rng(seed + (0 if name == "MNIST" else 7))
    out = []
    for i in range(num_graphs):
        c = int(i % NUM_CLASSES)
        n = int(rng.integers(40, 76))
        pos = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
        # class-keyed intensity field: (1 + c % 5) bright blobs placed
        # deterministically per class on a unit circle of radius 0.3,
        # plus per-graph jitter
        n_blobs = 1 + c % 5
        angles = 2 * np.pi * (np.arange(n_blobs) + c / NUM_CLASSES) / n_blobs
        centers = 0.5 + 0.3 * np.stack(
            [np.cos(angles), np.sin(angles)], axis=1
        )
        centers = centers + rng.normal(0.0, 0.02, centers.shape)
        d2 = ((pos[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        intensity = np.exp(-d2 / (2 * 0.08**2)).max(axis=1)
        intensity = (
            intensity + rng.normal(0.0, 0.05, n)
        ).clip(0.0, 1.0).astype(np.float32)
        if name == "MNIST":
            x = np.concatenate([intensity[:, None], pos], axis=1)
        else:
            hue = c / NUM_CLASSES
            rgb = np.stack(
                [
                    intensity * (0.5 + 0.5 * np.cos(2 * np.pi * hue)),
                    intensity * (0.5 + 0.5 * np.cos(2 * np.pi * (hue + 1 / 3))),
                    intensity * (0.5 + 0.5 * np.cos(2 * np.pi * (hue + 2 / 3))),
                ],
                axis=1,
            ).astype(np.float32)
            x = np.concatenate([rgb, pos], axis=1)
        ei = _knn_edges(pos, k=8)
        dist = np.linalg.norm(
            pos[ei[0]] - pos[ei[1]], axis=1
        ).astype(np.float32)[:, None]
        out.append(
            GraphData(
                num_nodes=n,
                edge_index=ei,
                x=x.astype(np.float32),
                edge_attr=dist,
                y=np.asarray([c], np.int32),
            )
        )
    return out


def load_superpixel_pickle(path: str) -> dict:
    """Read a pre-extracted superpixel artifact: a pickle holding
    `{split_name: [ {x, edge_index, edge_attr?, y}, ... ]}` with numpy
    arrays (the conversion of the torch GNNBenchmarkDataset tensors)."""
    with open(path, "rb") as f:
        raw = pickle.load(f)
    out = {}
    for split, items in raw.items():
        graphs = []
        for d in items:
            x = np.asarray(d["x"], np.float32)
            ei = np.asarray(d["edge_index"], np.int32)
            ea = d.get("edge_attr")
            if ea is not None:
                ea = np.asarray(ea, np.float32)
                if ea.ndim == 1:
                    ea = ea[:, None]
            graphs.append(
                GraphData(
                    num_nodes=int(x.shape[0]),
                    edge_index=ei,
                    x=x,
                    edge_attr=ea,
                    y=np.asarray(d["y"], np.int32).reshape(-1)[:1],
                )
            )
        out[split] = graphs
    return out


def superpixel_splits(
    data_dir: str,
    name: str = "MNIST",
    num_graphs: int = 600,
    seed: int = 0,
) -> tuple[dict, bool]:
    """Real splits when `<data_dir>/superpixels/<NAME>.pkl` exists;
    otherwise a deterministic approximately-stratified 80/10/10 split of
    the synthetic generator: per-class shuffles interleaved round-robin,
    then global proportional cuts — classes spread as evenly as the
    split sizes allow (a split smaller than the class count cannot hold
    every class). Returns (splits, is_real)."""
    cand = os.path.join(data_dir, "superpixels", f"{name.upper()}.pkl")
    if os.path.exists(cand):
        return load_superpixel_pickle(cand), True
    raw = synthetic_superpixels(name, num_graphs=num_graphs, seed=seed)
    rng = np.random.default_rng(seed)
    labels = np.asarray([int(np.asarray(g.y).reshape(-1)[0]) for g in raw])
    per_class = [
        list(rng.permutation(np.flatnonzero(labels == c)))
        for c in rng.permutation(np.unique(labels))
    ]
    order: list[int] = []
    while any(per_class):
        for lst in per_class:
            if lst:
                order.append(int(lst.pop()))
    raw = [raw[i] for i in order]
    n_tr, n_val = int(0.8 * len(raw)), int(0.1 * len(raw))
    return {
        "train": raw[:n_tr],
        "val": raw[n_tr:n_tr + n_val],
        "test": raw[n_tr + n_val:],
    }, False


VOC_NUM_CLASSES = 21
COCO_NUM_CLASSES = 81


def synthetic_voc_coco(
    name: str, num_graphs: int = 300, seed: int = 0
) -> list[GraphData]:
    """VOC/COCO-superpixel-shaped graphs (reference GraphGPS
    `loader/dataset/{voc,coco}_superpixels.py`): larger region-boundary
    graphs with a per-NODE semantic class — the LRGB node-classification
    rows. x = 12 floats (RGB mean/std + centroid stats, the
    edge_wt_region_boundary feature layout), edge_attr = 2 floats,
    y = (n,) int class in [0, 21) / [0, 81). Labels are spatially
    correlated blobs so segmentation is learnable."""
    C = VOC_NUM_CLASSES if name.lower().startswith("voc") else \
        COCO_NUM_CLASSES
    rng = np.random.default_rng(seed + (0 if C == VOC_NUM_CLASSES else 1))
    out = []
    for _ in range(num_graphs):
        n = int(rng.integers(60, 140))
        cent = rng.random((n, 2)).astype(np.float32)
        # kNN graph over centroids (region-boundary stand-in)
        d2 = ((cent[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        k = 8
        nbr = np.argsort(d2, axis=1)[:, :k]
        a = np.repeat(np.arange(n), k)
        b = nbr.reshape(-1)
        ei = np.unique(
            np.sort(np.stack([a, b]), axis=0), axis=1
        )
        ei = np.concatenate([ei, ei[::-1]], axis=1).astype(np.int32)
        # labels: a few random class "blobs" + background 0
        y = np.zeros(n, np.int64)
        for _ in range(int(rng.integers(1, 4))):
            c = int(rng.integers(1, C))
            center = rng.random(2)
            radius = rng.uniform(0.15, 0.35)
            y[((cent - center) ** 2).sum(-1) < radius ** 2] = c
        # features: class-correlated "color" + noise + centroid stats
        base = rng.random((C, 6)).astype(np.float32)
        x = np.concatenate([
            base[y] + 0.1 * rng.normal(size=(n, 6)).astype(np.float32),
            cent,
            np.tile(cent.mean(0), (n, 1)).astype(np.float32),
            np.tile(cent.std(0), (n, 1)).astype(np.float32),
        ], axis=1).astype(np.float32)  # (n, 12)
        w = np.exp(-d2[ei[0], ei[1]] / 0.05).astype(np.float32)
        ea = np.stack([w, np.sqrt(d2[ei[0], ei[1]]).astype(np.float32)], 1)
        out.append(GraphData(
            num_nodes=n, edge_index=ei, x=x, edge_attr=ea,
            y=y[:, None].astype(np.float32),
        ))
    return out


def voc_coco_splits(
    data_dir: str, name: str, num_graphs: int = 300, seed: int = 0
) -> tuple[dict, bool]:
    """Real splits when `<data_dir>/superpixels/<NAME>.pkl` exists;
    otherwise a deterministic 80/10/10 split of the synthetic generator.
    Returns (splits, is_real)."""
    cand = os.path.join(data_dir, "superpixels", f"{name.upper()}.pkl")
    if os.path.exists(cand):
        return load_superpixel_pickle(cand), True
    raw = synthetic_voc_coco(name, num_graphs=num_graphs, seed=seed)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(raw))
    raw = [raw[i] for i in order]
    n_tr, n_val = int(0.8 * len(raw)), int(0.1 * len(raw))
    return {
        "train": raw[:n_tr],
        "val": raw[n_tr:n_tr + n_val],
        "test": raw[n_tr + n_val:],
    }, False
