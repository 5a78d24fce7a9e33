"""Strongly-regular graphs (SR25) from graph6 (counterpart of
`escgnn_tpu/data/sr.py`).

Mirror of the reference's `SRDataset.py:30-48`: parse a .g6 file into
featureless graphs (x = ones). The canonical artifact is `sr251256.g6`
(in the repository under `data/sr25/raw/`), the 15 strongly regular
SR(25,12,5,6) graphs of `run_sr.py`'s untrained-embedding collision
test. Paths are read relative to the working directory, as in the JAX
package.
"""

from __future__ import annotations

import os

import numpy as np

from escgnn_tpu_torch.data.container import GraphData

_DEFAULT_PATHS = (
    "data/sr25/raw/sr251256.g6",
    "data/sr25/sr251256.g6",
    "data/sr251256.g6",
)


def parse_graph6(line: bytes) -> tuple[int, np.ndarray]:
    """Decode one graph6 line into (num_nodes, edge_index). Supports the
    short (n < 63) and 3-byte (n < 258048) headers."""
    data = np.frombuffer(line.strip(), np.uint8).astype(np.int64) - 63
    if data[0] == 63:  # '~' escape: 3-byte n
        n = int(data[1] * 64 * 64 + data[2] * 64 + data[3])
        data = data[4:]
    else:
        n = int(data[0])
        data = data[1:]
    bits = (
        (data[:, None] >> np.arange(5, -1, -1)[None, :]) & 1
    ).reshape(-1)
    iu = np.triu_indices(n, k=1)
    # graph6 packs the upper triangle column-major: (0,1),(0,2),(1,2),...
    order = np.lexsort((iu[0], iu[1]))
    r, c = iu[0][order], iu[1][order]
    on = bits[: len(r)].astype(bool)
    a, b = r[on], c[on]
    ei = np.stack(
        [np.concatenate([a, b]), np.concatenate([b, a])]
    ).astype(np.int32)
    return n, ei


def load_sr_graphs(path: str | None = None) -> list[GraphData]:
    if path is None:
        for cand in _DEFAULT_PATHS:
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"no sr25 .g6 file found in {_DEFAULT_PATHS}; pass a path"
            )
    with open(path, "rb") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    out = []
    for ln in lines:
        n, ei = parse_graph6(ln)
        out.append(
            GraphData(
                num_nodes=n,
                edge_index=ei,
                x=np.ones((n, 1), np.float32),
            )
        )
    return out
