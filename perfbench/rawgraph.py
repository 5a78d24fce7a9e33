"""The raw graphs a traffic generator makes and the benchmark hands to
both the system under test and the plain reference."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class RawGraph:
    """One undirected graph, both directions of each edge stored.

    `x`: (n, F) node features (int type ids or floats); `edge_attr`: (E,)
    int bond types or None; `y`: the targets, (T,) per graph or (n, T) per
    node, as the generator draws them (before any normalization)."""

    num_nodes: int
    edge_index: np.ndarray
    x: np.ndarray
    y: np.ndarray
    edge_attr: Optional[np.ndarray] = None

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])
