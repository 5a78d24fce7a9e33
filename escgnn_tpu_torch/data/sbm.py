"""PATTERN / CLUSTER — GNNBenchmark SBM node-classification rows (a copy
of `escgnn_tpu/data/sbm.py`).

Capability mirror of the reference master_loader's GNNBenchmarkDataset
branch (`GraphGPS/graphgps/loader/master_loader.py:331-343`:
`GNNBenchmarkDataset(root, name)` for PATTERN/CLUSTER). The real
datasets are Dwivedi et al.'s stochastic-block-model benchmarks:

  * PATTERN — binary node classification: does the node belong to one
    of the planted denser sub-patterns?
  * CLUSTER — 6-way node classification: which SBM community does the
    node belong to, given ONE labeled seed node per community (all
    other node features are 0 = unknown)?

The upstream artifacts are PyG-processed pickles behind a download
(not in the repository), so these rows generate the same-shaped SBM tasks
deterministically — the synthetic-regeneration protocol the counting
and CSL rows already use (CSL precedent: generated exactly)."""

from __future__ import annotations

import numpy as np

from escgnn_tpu_torch.data.container import GraphData


def _sbm_edges(rng, sizes, p_intra, p_inter):
    n = int(np.sum(sizes))
    block = np.repeat(np.arange(len(sizes)), sizes)
    upper = np.triu(rng.random((n, n)), k=1)
    same = block[:, None] == block[None, :]
    prob = np.where(same, p_intra, p_inter)
    a, b = np.nonzero((upper < prob) & (upper > 0))
    ei = np.stack([np.concatenate([a, b]), np.concatenate([b, a])])
    return ei.astype(np.int32), block


def synthetic_pattern(num_graphs: int = 200, seed: int = 0):
    """PATTERN-shaped graphs: a 5-community SBM plus a denser planted
    pattern over a random node subset; y = 1 on pattern nodes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        sizes = rng.integers(15, 25, size=5)
        ei, _ = _sbm_edges(rng, sizes, 0.5, 0.2)
        n = int(np.sum(sizes))
        k = int(rng.integers(12, 18))
        pat = rng.choice(n, size=k, replace=False)
        # densify the pattern: add edges among pattern nodes w.p. 0.6
        extra = []
        for i in range(k):
            for j in range(i + 1, k):
                if rng.random() < 0.6:
                    extra.append((pat[i], pat[j]))
        if extra:
            ex = np.asarray(extra, np.int64).T
            ei = np.concatenate(
                [ei, np.concatenate([ex, ex[::-1]], axis=1)], axis=1
            )
            key = ei[0].astype(np.int64) * n + ei[1]
            _, keep = np.unique(key, return_index=True)
            ei = ei[:, np.sort(keep)].astype(np.int32)
        y = np.zeros(n, np.int64)
        y[pat] = 1
        x = rng.integers(0, 3, n).astype(np.int32)  # vocab-3 node signal
        out.append(GraphData(
            num_nodes=n, edge_index=ei, x=x[:, None], y=y[:, None],
        ))
    return out


def synthetic_cluster(num_graphs: int = 200, seed: int = 0,
                      num_clusters: int = 6):
    """CLUSTER-shaped graphs: SBM with `num_clusters` communities; one
    revealed seed node per community carries feature c+1, every other
    node 0; y = community id."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        sizes = rng.integers(8, 18, size=num_clusters)
        ei, block = _sbm_edges(rng, sizes, 0.55, 0.12)
        n = int(np.sum(sizes))
        x = np.zeros(n, np.int32)
        for c in range(num_clusters):
            members = np.flatnonzero(block == c)
            x[rng.choice(members)] = c + 1
        out.append(GraphData(
            num_nodes=n, edge_index=ei, x=x[:, None],
            y=block.astype(np.int64)[:, None],
        ))
    return out


def sbm_splits(name: str, num_graphs: int = 200, seed: int = 0) -> dict:
    gen = {"pattern": synthetic_pattern, "cluster": synthetic_cluster}[
        name.lower()
    ]
    raw = gen(num_graphs=num_graphs, seed=seed)
    n_tr, n_val = int(0.8 * len(raw)), int(0.1 * len(raw))
    return {
        "train": raw[:n_tr],
        "val": raw[n_tr:n_tr + n_val],
        "test": raw[n_tr + n_val:],
    }
