"""ZINC, AQSOL, OGB and PCQM4Mv2 graphs (counterpart of
`escgnn_tpu/data/molecules.py`).

The reference's ZINC artifact is read when it is present
(`load_zinc_pickle`); otherwise `synthetic_zinc` makes deterministic
graphs with ZINC-12k's shapes and statistics: ~23 heavy atoms, 28 node
types, 4 bond types and a scalar regression target that is a structural
function of the graph (so models can learn it).

The OGB datasets: an extracted raw directory is read without the `ogb`
package (`load_ogb_graph_dir`); otherwise `synthetic_ogb_mol` (ogbg-mol*
shapes) and `synthetic_ppa` (ogbg-ppa shapes) make deterministic
stand-ins; `synthetic_aqsol` and `synthetic_pcqm4mv2` make the GPS
zoo's AQSOL and PCQM4Mv2 rows. Every generator's output is bit-equal to the JAX package's for
the same seed.
"""

from __future__ import annotations

import os

import numpy as np

from escgnn_tpu_torch.data.container import GraphData

# OGB atom / bond feature vocabularies (ogb.utils.features)
_ATOM_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
_BOND_DIMS = (5, 6, 2)


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


def _split_80_10_10(raw: list) -> dict:
    n_tr, n_val = int(0.8 * len(raw)), int(0.1 * len(raw))
    return {"train": raw[:n_tr], "val": raw[n_tr:n_tr + n_val],
            "test": raw[n_tr + n_val:]}


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
    return _split_80_10_10(synthetic_zinc(num_graphs=num_graphs,
                                          seed=seed)), False


def synthetic_ogb_mol(
    num_graphs: int = 2000,
    seed: int = 0,
    num_tasks: int = 1,
    nan_frac: float = 0.0,
    label_kind: str = "parity",
) -> list[GraphData]:
    """ogbg-mol*-shaped graphs: x (n, 9) int atom features within the OGB
    vocab bounds, edge_attr (E, 3) int bond features, y (num_tasks,)
    float32 in {0, 1} with a `nan_frac` fraction of NaN holes (unlabeled
    entries, masked out of the BCE).

    `label_kind`: "parity" (a node-feature / triangle parity, measured
    near-unlearnable at this scale: rows trained on it show that the path
    trains, not that the model learns) or "tri" (triangle count above the
    dataset median, inside the ESC encoding's counting power: a capable
    model reaches a high ROC-AUC)."""
    rng = np.random.default_rng(seed)
    out = []
    tris = []
    for _ in range(num_graphs):
        n = int(rng.integers(12, 28))
        ei = _molecule_skeleton(rng, n)
        x = np.stack(
            [rng.integers(0, min(d, 16), n) for d in _ATOM_DIMS], axis=1
        ).astype(np.int32)
        ea = np.stack(
            [rng.integers(0, d, ei.shape[1]) for d in _BOND_DIMS], axis=1
        ).astype(np.int32)
        tri = _num_triangles(n, ei)
        base = (tri % 2) ^ (n % 2)
        y = np.empty(num_tasks, np.float32)
        for t in range(num_tasks):
            y[t] = float((base + t + int(x[:, 0].sum())) % 2)
        if nan_frac > 0:
            holes = rng.random(num_tasks) < nan_frac
            y[holes] = np.nan
        out.append(GraphData(num_nodes=n, edge_index=ei, x=x, edge_attr=ea,
                             y=y))
        tris.append(tri)
    if label_kind == "tri":
        med = float(np.median(tris))
        for g, tri in zip(out, tris):
            keep_nan = np.isnan(g.y)
            g.y[:] = float(tri > med)
            g.y[keep_nan] = np.nan
    elif label_kind != "parity":
        raise ValueError(f"unknown label_kind {label_kind!r}")
    return out


def synthetic_aqsol(num_graphs: int = 2000, seed: int = 0) -> list[GraphData]:
    """AQSOL-shaped graphs (reference GraphGPS
    `loader/dataset/aqsol_molecules.py`): ZINC-style int atom/bond types
    (65 atom, 5 bond classes) with a structural pseudo-solubility target
    — the aqueous-solubility regression row of the GPS zoo."""
    rng = np.random.default_rng(seed + 7)
    out = []
    for _ in range(num_graphs):
        n = int(rng.integers(10, 30))
        ei = _molecule_skeleton(rng, n)
        x = rng.integers(0, 65, n).astype(np.int32)[:, None]
        ea = rng.integers(0, 5, ei.shape[1]).astype(np.int32)
        tri = _num_triangles(n, ei)
        deg = np.bincount(ei[1], minlength=n)
        y = (
            -0.08 * n
            + 0.3 * tri
            - 0.15 * float((x[:, 0] % 7).mean())
            + 0.25 * float(deg.mean())
        )
        out.append(GraphData(
            num_nodes=n, edge_index=ei, x=x,
            edge_attr=ea.astype(np.int32),
            y=np.asarray([y], np.float32),
        ))
    return out


def aqsol_splits(
    data_dir: str, num_graphs: int = 2000, seed: int = 0
) -> tuple[dict, bool]:
    """Real AQSOL splits when `<data_dir>/aqsol/<split>.pickle` artifacts
    exist (the reference's per-split pickles); otherwise a deterministic
    80/10/10 split of `synthetic_aqsol`. Returns (splits, is_real)."""
    import os

    names = {s: os.path.join(data_dir, "aqsol", f"{s}.pickle")
             for s in ("train", "val", "test")}
    if all(os.path.exists(p) for p in names.values()):
        return {s: load_zinc_pickle(p) for s, p in names.items()}, True
    raw = synthetic_aqsol(num_graphs=num_graphs, seed=seed)
    n_tr, n_val = int(0.8 * len(raw)), int(0.1 * len(raw))
    return {
        "train": raw[:n_tr],
        "val": raw[n_tr:n_tr + n_val],
        "test": raw[n_tr + n_val:],
    }, False


def synthetic_ppa(num_graphs: int = 2000, seed: int = 0,
                  num_classes: int = 37) -> list[GraphData]:
    """ogbg-ppa-shaped graphs: no node features (x = zeros), 7-dim float
    edge features, one of 37 species classes tied to graph statistics so
    that models can learn it."""
    rng = np.random.default_rng(seed + 11)
    out = []
    for _ in range(num_graphs):
        n = int(rng.integers(15, 40))
        # denser association-network-like topology
        p = rng.uniform(0.12, 0.3)
        upper = np.triu(rng.random((n, n)) < p, k=1)
        order = rng.permutation(n)
        upper[np.minimum(order[:-1], order[1:]),
              np.maximum(order[:-1], order[1:])] = True
        a, b = np.nonzero(upper)
        ei = np.stack([np.concatenate([a, b]), np.concatenate([b, a])]
                      ).astype(np.int32)
        ea = rng.random((ei.shape[1], 7)).astype(np.float32)
        tri = _num_triangles(n, ei)
        cls = int((n // 3 + tri + int(ea.mean() * 10)) % num_classes)
        out.append(GraphData(num_nodes=n, edge_index=ei,
                             x=np.zeros((n, 1), np.int32), edge_attr=ea,
                             y=np.asarray([cls], np.int64)))
    return out


def ppa_splits(data_dir: str, num_graphs: int = 2000,
               seed: int = 0) -> tuple[dict, bool]:
    """ogbg-ppa splits: an 80/10/10 split of `synthetic_ppa` (the real
    dataset's loader needs the `ogb` package). Returns (splits, False)."""
    return _split_80_10_10(synthetic_ppa(num_graphs=num_graphs,
                                         seed=seed)), False


def load_ogb_graph_dir(root: str) -> dict:
    """Parse an OGB graph-property-prediction dataset directory without
    the `ogb` package, in the raw schema that package downloads:

        <root>/raw/num-node-list.csv.gz   one int per graph
        <root>/raw/num-edge-list.csv.gz   one int per graph
        <root>/raw/edge.csv.gz            src,dst per directed edge row
        <root>/raw/node-feat.csv.gz       one int row per node (optional)
        <root>/raw/edge-feat.csv.gz       one row per edge (optional)
        <root>/raw/graph-label.csv.gz     one row per graph (NaN or an
                                          empty field = unlabeled)
        <root>/split/<scheme>/{train,valid,test}.csv.gz  graph indices

    Edge rows are taken as they are (OGB molecule datasets store both
    directions); integer-valued edge features stay ints. The first split
    scheme in name order is used. Returns {'train', 'val', 'test'} lists
    of GraphData."""
    import glob
    import gzip

    def read_csv(name, dtype):
        path = os.path.join(root, "raw", name)
        if not os.path.exists(path):
            return None
        with gzip.open(path, "rt") as f:
            rows = [[dtype(v) if v else float("nan")
                     for v in line.strip("\n").split(",")]
                    for line in f if line.strip()]
        return np.asarray(rows)

    n_nodes = read_csv("num-node-list.csv.gz", int)[:, 0]
    n_edges = read_csv("num-edge-list.csv.gz", int)[:, 0]
    edges = read_csv("edge.csv.gz", int)
    node_feat = read_csv("node-feat.csv.gz", float)
    edge_feat = read_csv("edge-feat.csv.gz", float)
    labels = read_csv("graph-label.csv.gz", float)

    graphs = []
    noff = eoff = 0
    for g, (nn, ne) in enumerate(zip(n_nodes, n_edges)):
        ei = edges[eoff:eoff + ne].T.astype(np.int32)
        x = (node_feat[noff:noff + nn].astype(np.int32)
             if node_feat is not None else np.zeros((nn, 1), np.int32))
        ea = edge_feat[eoff:eoff + ne] if edge_feat is not None else None
        if ea is not None:
            ea = (ea.astype(np.int32) if np.allclose(ea, np.round(ea))
                  else ea.astype(np.float32))
        graphs.append(GraphData(num_nodes=int(nn), edge_index=ei, x=x,
                                edge_attr=ea,
                                y=labels[g].astype(np.float32)))
        noff += nn
        eoff += ne

    split_dirs = sorted(glob.glob(os.path.join(root, "split", "*")))
    if not split_dirs:
        raise FileNotFoundError(f"no split scheme under {root}/split")
    out = {}
    for fname, key in (("train", "train"), ("valid", "val"),
                       ("test", "test")):
        with gzip.open(os.path.join(split_dirs[0], f"{fname}.csv.gz"),
                       "rt") as f:
            idx = [int(line.strip()) for line in f if line.strip()]
        out[key] = [graphs[i] for i in idx]
    return out


def synthetic_pcqm4mv2(
    num_graphs: int = 2000, seed: int = 0
) -> list[GraphData]:
    """PCQM4Mv2-shaped graphs (OGB-LSC HOMO-LUMO gap regression,
    reference `master_loader.py:441-525`): OGB atom/bond int features,
    scalar float y. The synthetic target is a smooth structural
    function (triangle count + size + mean degree), so a working
    regression pipeline must drive MAE well below the label std."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        n = int(rng.integers(12, 28))
        ei = _molecule_skeleton(rng, n)
        x = np.stack(
            [rng.integers(0, min(d, 16), n) for d in _ATOM_DIMS], axis=1
        ).astype(np.int32)
        ea = np.stack(
            [rng.integers(0, d, ei.shape[1]) for d in _BOND_DIMS], axis=1
        ).astype(np.int32)
        tri = _num_triangles(n, ei)
        y = np.asarray(
            [0.15 * tri + 0.05 * n + 0.2 * ei.shape[1] / n], np.float32
        )
        out.append(GraphData(
            num_nodes=n, edge_index=ei, x=x, edge_attr=ea, y=y,
        ))
    return out


def pcqm4mv2_splits(
    data_dir: str,
    subset: str = "subset",
    num_graphs: int = 2000,
    seed: int = 0,
) -> tuple[dict, bool]:
    """PCQM4Mv2 splits (reference `preformat_OGB_PCQM4Mv2`,
    master_loader.py:441-525). Real-if-present: an extracted
    `<data_dir>/pcqm4mv2/raw` graph dir in the OGB csv layout loads via
    `load_ogb_graph_dir`; otherwise `synthetic_pcqm4mv2`.

    `subset`: 'subset' trains on 10% of the train split (the
    reference's debugging subset), 'full' on all of it; 'inference'
    mirrors the LSC challenge layout — labeled original-valid as
    "train", unlabeled (NaN-y) test-dev / test-challenge as val/test."""
    import os

    assert subset in ("subset", "full", "inference"), subset
    for cand in (os.path.join(data_dir, "pcqm4mv2"),):
        if os.path.isdir(os.path.join(cand, "raw")):
            return load_ogb_graph_dir(cand), True
    raw = synthetic_pcqm4mv2(num_graphs=num_graphs, seed=seed)
    n_tr, n_val = int(0.8 * len(raw)), int(0.1 * len(raw))
    train, val, test = (
        raw[:n_tr], raw[n_tr:n_tr + n_val], raw[n_tr + n_val:]
    )
    if subset == "subset":
        train = train[: max(1, len(train) // 10)]
    elif subset == "inference":
        for g in val + test:
            g.y = np.full_like(g.y, np.nan)
    return {"train": train, "val": val, "test": test}, False


def ogb_mol_splits(
    data_dir: str,
    dataset: str,
    num_graphs: int = 2000,
    seed: int = 0,
    num_tasks: int = 1,
    nan_frac: float = 0.0,
    label_kind: str = "parity",
) -> tuple[dict, bool]:
    """The real OGB molecule splits when `<data_dir>/<dataset>/raw` exists
    (underscores for dashes first, as the package extracts it); otherwise
    an 80/10/10 split of `synthetic_ogb_mol`. Raises when the real labels'
    width is not `num_tasks`. Returns (splits, is_real)."""
    for cand in (os.path.join(data_dir, dataset.replace("-", "_")),
                 os.path.join(data_dir, dataset)):
        if os.path.isdir(os.path.join(cand, "raw")):
            splits = load_ogb_graph_dir(cand)
            g0 = next((g for s in splits.values() for g in s
                       if g.y is not None), None)
            if g0 is not None:
                width = int(np.asarray(g0.y).reshape(-1).shape[0])
                if width != num_tasks:
                    raise ValueError(
                        f"{dataset}: real label width {width} != requested "
                        f"num_tasks {num_tasks}; pass --num_tasks {width}")
            return splits, True
    return _split_80_10_10(synthetic_ogb_mol(
        num_graphs=num_graphs, seed=seed, num_tasks=num_tasks,
        nan_frac=nan_frac, label_kind=label_kind)), False
