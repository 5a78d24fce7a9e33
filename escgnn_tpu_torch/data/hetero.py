"""(A copy of `escgnn_tpu/data/hetero.py`.) WebKB (Cornell/Texas/Wisconsin),
Actor, and WikipediaNetwork
(chameleon/squirrel) heterophilous node-classification graphs — the
generic-PyG rows of the reference's GPS master_loader
(`GraphGPS/graphgps/loader/master_loader.py:132-190`:
`Actor(dataset_dir)`, `WebKB(dataset_dir, name)`,
`WikipediaNetwork(dataset_dir, name)`).

Real-if-present: both PyG dataset classes download the same raw text
schema, which is parsed here directly —

    <root>/<name>/raw/out1_node_feature_label.txt
        header line, then "node_id<TAB>features<TAB>label" rows where
        `features` is a comma list: full 0/1 vectors (WebKB, 1703-dim)
        or one-hot INDICES (Actor, 932-dim sparse rows);
    <root>/<name>/raw/out1_graph_edges.txt
        header line, then "src<TAB>dst" rows (directed; symmetrized
        here, self-loops dropped).

Fallback: a deterministic heterophilous SBM (out-class preference,
unlike the homophilous Planetoid stand-in) with class-correlated
features.
"""

from __future__ import annotations

import os

import numpy as np

from escgnn_tpu_torch.data.container import GraphData

WEBKB_NAMES = ("cornell", "texas", "wisconsin")
WIKI_NAMES = ("chameleon", "squirrel")
ACTOR_FEAT_DIM = 932
# sparse-row (one-hot index) feature widths by dataset — Actor and the
# geom-gcn-preprocessed WikipediaNetwork dumps both use index lists in
# out1_node_feature_label.txt; WebKB ships full 0/1 vectors
SPARSE_FEAT_DIMS = {"actor": ACTOR_FEAT_DIM,
                    "chameleon": 2325, "squirrel": 2089}


def load_hetero_raw(root: str, name: str) -> GraphData:
    raw = os.path.join(root, name, "raw")
    feat_path = os.path.join(raw, "out1_node_feature_label.txt")
    edge_path = os.path.join(raw, "out1_graph_edges.txt")
    with open(feat_path) as f:
        lines = f.read().strip().split("\n")[1:]
    ids, feats, labels = [], [], []
    for line in lines:
        nid, fstr, lab = line.split("\t")
        ids.append(int(nid))
        feats.append([int(v) for v in fstr.split(",")])
        labels.append(int(lab))
    n = max(ids) + 1
    sparse = any(max(f, default=0) > 1 for f in feats)
    dim = SPARSE_FEAT_DIMS.get(
        name, max((max(f, default=0) for f in feats), default=0) + 1
    ) if sparse else len(feats[0])
    x = np.zeros((n, dim), np.float32)
    y = np.zeros(n, np.int64)
    for nid, f, lab in zip(ids, feats, labels):
        if sparse:
            x[nid, np.asarray(f, np.int64)] = 1.0
        else:
            x[nid] = np.asarray(f, np.float32)
        y[nid] = lab
    with open(edge_path) as f:
        lines = f.read().strip().split("\n")[1:]
    src, dst = [], []
    for line in lines:
        a, b = (int(v) for v in line.split("\t"))
        if a != b:
            src += [a, b]
            dst += [b, a]
    ei = np.stack([np.asarray(src), np.asarray(dst)])
    key = ei[0].astype(np.int64) * n + ei[1]
    _, keep = np.unique(key, return_index=True)
    ei = ei[:, np.sort(keep)].astype(np.int64)
    return GraphData(num_nodes=n, edge_index=ei, x=x, y=y[:, None])


def synthetic_hetero(
    name: str, num_nodes: int = 400, num_classes: int = 5,
    feat_dim: int = 48, seed: int = 0,
) -> GraphData:
    """Heterophilous SBM stand-in: edges prefer DIFFERENT classes (the
    regime WebKB/Actor are benchmarks for)."""
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    labels = rng.integers(0, num_classes, num_nodes)
    same = labels[:, None] == labels[None, :]
    prob = np.where(same, 0.003, 0.02)
    upper = np.triu(rng.random((num_nodes, num_nodes)) < prob, k=1)
    a, b = np.nonzero(upper | upper.T)
    ei = np.stack([a, b]).astype(np.int64)
    centers = rng.random((num_classes, feat_dim)) < 0.2
    flip = rng.random((num_nodes, feat_dim)) < 0.05
    x = (centers[labels] ^ flip).astype(np.float32)
    return GraphData(
        num_nodes=num_nodes, edge_index=ei, x=x,
        y=labels.astype(np.int64)[:, None],
    )


def get_hetero_graph(
    name: str, root: str = "data/hetero"
) -> tuple[GraphData, bool]:
    """(graph, is_real). `name`: cornell | texas | wisconsin | actor |
    chameleon | squirrel."""
    names = WEBKB_NAMES + ("actor",) + WIKI_NAMES
    if name not in names:
        raise ValueError(f"heterophilous graph {name!r}: one of {names}")
    try:
        return load_hetero_raw(root, name), True
    except (FileNotFoundError, OSError):
        return synthetic_hetero(name), False


def node_split_copies(
    g: GraphData, seed: int = 0, ratios=(0.6, 0.2, 0.2)
) -> dict:
    """Single-graph node-classification splits: three copies of the
    SAME graph whose labels are masked to -1 outside the split's node
    set (stratified per class). The node-level CE loss and F1 metric
    ignore y < 0, so train/val/test gradients and scores come only
    from that split's nodes — the Planetoid/WebKB/Actor mask protocol
    in split-list form."""
    rng = np.random.default_rng(seed)
    y = np.asarray(g.y).reshape(-1)
    owner = np.zeros(len(y), np.int64)  # 0 train, 1 val, 2 test
    for c in np.unique(y):
        idx = rng.permutation(np.flatnonzero(y == c))
        n_tr = max(int(ratios[0] * len(idx)), 1)
        n_val = max(int(ratios[1] * len(idx)), 1)
        owner[idx[n_tr:n_tr + n_val]] = 1
        owner[idx[n_tr + n_val:]] = 2
    out = {}
    for k, split in enumerate(("train", "val", "test")):
        yk = np.where(owner == k, y, -1).astype(np.int64)
        out[split] = [GraphData(
            num_nodes=g.num_nodes, edge_index=g.edge_index, x=g.x,
            y=yk[:, None],
        )]
    return out
