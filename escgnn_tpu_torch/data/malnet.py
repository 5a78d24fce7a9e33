"""MalNet-Tiny stand-in: function-call-graph classification (a copy of
`escgnn_tpu/data/malnet.py`).

The reference's GraphGPS fork loads MalNet-Tiny (5-class Android
call-graph classification, up to ~5k nodes) through `preformat_MalNetTiny`
in `GraphGPS/graphgps/loader/master_loader.py`; the graphs are
featureless (a constant or local-degree feature is attached at load
time). The artifact is not in the repository, so this generator produces deterministic call-graph-shaped DAG-ish graphs whose
class controls the topology generator — the same role: large sparse
directed graphs, no node features beyond degree, 5-way labels.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from escgnn_tpu_torch.data.container import GraphData

NUM_CLASSES = 5


def synthetic_malnet(
    num_graphs: int = 200,
    seed: int = 0,
    min_nodes: int = 60,
    max_nodes: int = 160,
) -> list[GraphData]:
    """Call-graph-shaped graphs: a mostly-forward sparse DAG (call edges
    from earlier to later functions) plus class-dependent wiring — the
    class picks the out-degree distribution, back-edge (recursion) rate,
    and hub fraction. x = (n, 1) float log-degree (the degree feature
    MalNet configs attach); y = (1,) int class in [0, 5)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num_graphs):
        c = int(i % NUM_CLASSES)
        n = int(rng.integers(min_nodes, max_nodes + 1))
        fanout = 1 + c          # mean out-degree grows with class
        back_rate = 0.05 * c    # recursion back-edges
        hub_frac = 0.02 + 0.03 * (c % 3)
        hubs = rng.choice(n, max(1, int(hub_frac * n)), replace=False)
        src, dst = [], []
        for u in range(n - 1):
            k = 1 + rng.poisson(fanout)
            lo = u + 1
            tgt = rng.integers(lo, n, k)
            src.extend([u] * k)
            dst.extend(tgt.tolist())
            # hub attraction: one extra call into a hub
            h = int(hubs[rng.integers(0, len(hubs))])
            if h != u:
                src.append(u)
                dst.append(h)
            if u > 0 and rng.random() < back_rate:  # recursion
                src.append(u)
                dst.append(int(rng.integers(0, u)))
        a = np.asarray(src)
        b = np.asarray(dst)
        key = a * n + b
        _, uniq = np.unique(key, return_index=True)
        a, b = a[uniq], b[uniq]
        ei = np.stack([a, b]).astype(np.int32)
        deg = np.bincount(
            np.concatenate([ei[0], ei[1]]), minlength=n
        ).astype(np.float32)
        x = np.log1p(deg)[:, None]
        out.append(
            GraphData(
                num_nodes=n, edge_index=ei, x=x,
                y=np.asarray([c], np.int32),
            )
        )
    return out


def load_malnet_pickle(path: str) -> dict:
    """Read a pre-extracted MalNet artifact: a pickle of
    `{split: [ {edge_index, num_nodes, y}, ... ]}`; the log-degree node
    feature is attached here (the master_loader attaches its node
    feature at load time the same way)."""
    with open(path, "rb") as f:
        raw = pickle.load(f)
    out = {}
    for split, items in raw.items():
        graphs = []
        for d in items:
            ei = np.asarray(d["edge_index"], np.int32)
            n = int(d["num_nodes"])
            deg = np.bincount(
                np.concatenate([ei[0], ei[1]]), minlength=n
            ).astype(np.float32)
            graphs.append(
                GraphData(
                    num_nodes=n, edge_index=ei,
                    x=np.log1p(deg)[:, None],
                    y=np.asarray(d["y"], np.int32).reshape(-1)[:1],
                )
            )
        out[split] = graphs
    return out


def malnet_splits(
    data_dir: str,
    num_graphs: int = 200,
    seed: int = 0,
) -> tuple[dict, bool]:
    """Real splits when `<data_dir>/malnet/malnet-tiny.pkl` exists;
    otherwise a deterministic 80/10/10 split of the synthetic generator.
    Returns (splits, is_real)."""
    cand = os.path.join(data_dir, "malnet", "malnet-tiny.pkl")
    if os.path.exists(cand):
        return load_malnet_pickle(cand), True
    raw = synthetic_malnet(num_graphs=num_graphs, seed=seed)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(raw))
    raw = [raw[i] for i in order]
    n_tr, n_val = int(0.8 * len(raw)), int(0.1 * len(raw))
    return {
        "train": raw[:n_tr],
        "val": raw[n_tr:n_tr + n_val],
        "test": raw[n_tr + n_val:],
    }, False
