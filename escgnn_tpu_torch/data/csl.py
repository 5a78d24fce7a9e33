"""Circular Skip Link (CSL) graphs (counterpart of
`escgnn_tpu/data/csl.py`).

The 10-class isomorphism benchmark of the reference's `run_csl.py`:
41-node 4-regular graphs, each node i linked to i+-1 and i+-R (mod 41)
for a class-specific skip R; 15 randomly permuted copies per class (150
graphs). 1-WL cannot distinguish the classes; the ESC structural
encoding can. The graphs equal the JAX package's for the same seed.
"""

from __future__ import annotations

import numpy as np

from escgnn_tpu_torch.data.container import GraphData

CSL_N = 41
CSL_SKIPS = (2, 3, 4, 5, 6, 9, 11, 12, 13, 16)
CSL_COPIES = 15


def _csl_edges(n: int, skip: int) -> np.ndarray:
    i = np.arange(n)
    pairs = np.concatenate(
        [np.stack([i, (i + 1) % n], 1), np.stack([i, (i + skip) % n], 1)]
    )
    ei = np.concatenate([pairs, pairs[:, ::-1]]).T
    # canonical dedupe (skip == n-1 etc. would alias; not the case here)
    key = ei[0] * n + ei[1]
    _, uniq = np.unique(key, return_index=True)
    return ei[:, uniq].astype(np.int32)


def generate_csl(seed: int = 0) -> list[GraphData]:
    """150 graphs, class-major order: graphs[15*c : 15*(c+1)] are random
    node permutations of the class-c skip graph."""
    rng = np.random.default_rng(seed)
    out = []
    for cls, skip in enumerate(CSL_SKIPS):
        base = _csl_edges(CSL_N, skip)
        for copy in range(CSL_COPIES):
            perm = (
                np.arange(CSL_N)
                if copy == 0
                else rng.permutation(CSL_N)
            )
            ei = perm[base]
            out.append(
                GraphData(
                    num_nodes=CSL_N,
                    edge_index=ei.astype(np.int32),
                    x=np.ones((CSL_N, 1), np.float32),
                    y=np.asarray([cls], np.int64),
                )
            )
    return out
