"""TU benchmark datasets (a copy of `escgnn_tpu/data/tu.py`).

Mirror of the reference's `kernel/tu_dataset.py` + `kernel/datasets.py`:
parse the TU text format (A / graph_indicator / graph_labels /
node_labels files) into GraphData records, one-hot node labels, degree
features as the fallback when a dataset ships none
(`kernel/datasets.py:98-112`), and a deterministic synthetic 2-class
dataset when the raw files are absent.
"""

from __future__ import annotations

import os

import numpy as np

from escgnn_tpu_torch.data.container import GraphData


def _read_ints(path: str) -> np.ndarray:
    with open(path) as f:
        rows = [
            [int(float(t)) for t in ln.replace(",", " ").split()]
            for ln in f if ln.strip()
        ]
    return np.asarray(rows, np.int64)


def load_tu_dataset(root: str, name: str) -> list[GraphData]:
    """Parse `<root>/<name>/raw/<name>_*.txt` (the TU dortmund format)."""
    raw = os.path.join(root, name, "raw")
    a_path = os.path.join(raw, f"{name}_A.txt")
    if not os.path.exists(a_path):
        raise FileNotFoundError(a_path)
    edges = _read_ints(a_path) - 1  # 1-indexed pairs
    indicator = _read_ints(
        os.path.join(raw, f"{name}_graph_indicator.txt")
    ).reshape(-1) - 1
    g_labels = _read_ints(
        os.path.join(raw, f"{name}_graph_labels.txt")
    ).reshape(-1)
    # map labels onto 0..C-1 in sorted order ({1,-1} -> {1,0} etc.)
    classes = {c: i for i, c in enumerate(sorted(set(g_labels.tolist())))}
    g_labels = np.asarray([classes[c] for c in g_labels])

    node_labels = None
    nl_path = os.path.join(raw, f"{name}_node_labels.txt")
    if os.path.exists(nl_path):
        node_labels = _read_ints(nl_path).reshape(-1)
        vocab = {c: i for i, c in enumerate(
            sorted(set(node_labels.tolist()))
        )}
        node_labels = np.asarray([vocab[c] for c in node_labels])
        width = len(vocab)

    num_graphs = int(indicator.max()) + 1
    node_of_graph = [np.flatnonzero(indicator == i) for i in range(num_graphs)]
    out = []
    e_graph = indicator[edges[:, 0]]
    for i in range(num_graphs):
        nodes = node_of_graph[i]
        lo = int(nodes[0])
        n = len(nodes)
        e = edges[e_graph == i] - lo
        x = None
        if node_labels is not None:
            x = np.eye(width, dtype=np.float32)[node_labels[nodes]]
        out.append(
            GraphData(
                num_nodes=n,
                edge_index=e.T.astype(np.int32),
                x=x,
                y=np.asarray([g_labels[i]], np.int64),
            )
        )
    return out


def add_degree_features(graphs: list[GraphData]) -> list[GraphData]:
    """One-hot in-degree features (the reference's fallback for TU sets
    without node labels, `kernel/datasets.py:98-112`)."""
    degs = []
    for g in graphs:
        d = np.zeros(g.num_nodes, np.int64)
        ei = np.asarray(g.edge_index)
        if ei.size:
            np.add.at(d, ei[1], 1)
        degs.append(d)
    width = int(max(int(d.max()) for d in degs if d.size)) + 1
    out = []
    for g, d in zip(graphs, degs):
        out.append(
            GraphData(
                num_nodes=g.num_nodes,
                edge_index=g.edge_index,
                x=np.eye(width, dtype=np.float32)[d],
                edge_attr=g.edge_attr,
                y=g.y,
                pos=g.pos,
                enc_idx=g.enc_idx,
                enc_cnt=g.enc_cnt,
                enc_offsets=g.enc_offsets,
                extras=g.extras,
            )
        )
    return out


def synthetic_tu(num_graphs: int = 200, seed: int = 0) -> list[GraphData]:
    """Deterministic 2-class stand-in: class 1 graphs carry extra
    triangles (ring chords), class 0 are near-trees — separable by any
    message-passing model, featureless apart from degree one-hots."""
    rng = np.random.default_rng(seed)
    graphs = []
    for i in range(num_graphs):
        cls = i % 2
        n = int(rng.integers(8, 16))
        order = rng.permutation(n)
        a = [order[:-1]]
        b = [order[1:]]
        if cls == 1:  # close triangles
            tri = rng.integers(0, n - 2, max(2, n // 4))
            a.append(order[tri])
            b.append(order[tri + 2])
        a, b = np.concatenate(a), np.concatenate(b)
        key = np.minimum(a, b) * n + np.maximum(a, b)
        _, uniq = np.unique(key, return_index=True)
        a, b = a[uniq], b[uniq]
        ei = np.stack(
            [np.concatenate([a, b]), np.concatenate([b, a])]
        ).astype(np.int32)
        graphs.append(
            GraphData(
                num_nodes=n,
                edge_index=ei,
                y=np.asarray([cls], np.int64),
            )
        )
    return add_degree_features(graphs)


def get_tu_dataset(
    name: str,
    root: str = "data",
    pre_transform=None,
) -> list[GraphData]:
    """Load a real TU dataset if its raw files exist under `root`, else
    fall back to the synthetic 2-class set; degree features are added
    when the dataset has no node features; `pre_transform` (e.g. the
    NGNN copies transform) is applied per graph."""
    try:
        graphs = load_tu_dataset(root, name)
    except FileNotFoundError:
        graphs = synthetic_tu()
    if graphs[0].x is None:
        graphs = add_degree_features(graphs)
    if pre_transform is not None:
        graphs = [pre_transform(g) for g in graphs]
    return graphs
