"""Graph containers (counterpart of `escgnn_tpu/data/container.py`).

`GraphData` is the host-side (numpy, ragged) record of one graph.
`GraphBatch` is the statically-shaped padded batch: a dataclass of
tensors plus validity masks, with the uniform-block sizes kept as plain
ints. Sizes (`num_nodes` etc.) are read from the mask shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from escgnn_tpu_torch.device import resolve_device


@dataclasses.dataclass
class GraphData:
    """One ragged graph (host side, numpy).

    Required: `num_nodes`, `edge_index` (2, E).
    Optional payloads: node features `x` (N, ...), edge features
    `edge_attr` (E, ...), targets `y` (node-level (N, T) or graph-level
    (T,)), 3D coordinates `pos` (N, 3).

    ESC structural encoding (ragged CSR over edges): `enc_idx`/`enc_cnt`
    are flat (total_nnz,) arrays and `enc_offsets` (E+1,) delimits each
    edge's run. `extras` holds named per-graph annotations; the batcher
    of this package takes graphs without them.
    """

    num_nodes: int
    edge_index: np.ndarray
    x: Optional[np.ndarray] = None
    edge_attr: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    pos: Optional[np.ndarray] = None
    enc_idx: Optional[np.ndarray] = None
    enc_cnt: Optional[np.ndarray] = None
    enc_offsets: Optional[np.ndarray] = None
    extras: Optional[dict] = None

    @property
    def num_edges(self) -> int:
        return int(np.asarray(self.edge_index).shape[1])


@dataclasses.dataclass
class GraphBatch:
    """Statically-shaped padded batch of tensors.

    Padding conventions follow the JAX package: padding edges park on a
    padding node slot (receivers stay non-decreasing), padding nodes are
    flagged by `node_mask`. The dedup encoding layout carries the batch's
    unique (R, P) rows in `enc_idx`/`enc_cnt`, the edge -> row map
    `enc_edge_row`, the rows' real-edge multiplicities `enc_row_weight`,
    the sorted-CSR view `enc_edge_perm`/`enc_row_sorted` (the input of the
    sorted-segment-sum kernel), the compact bucket ids `enc_bucket_ids`
    and, where it fits, the host count matrix `enc_countmat`.
    """

    x: Optional[torch.Tensor] = None
    y: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    edge_attr: Optional[torch.Tensor] = None
    senders: Optional[torch.Tensor] = None
    receivers: Optional[torch.Tensor] = None
    node_mask: Optional[torch.Tensor] = None
    edge_mask: Optional[torch.Tensor] = None
    graph_mask: Optional[torch.Tensor] = None
    node_graph: Optional[torch.Tensor] = None
    node_local: Optional[torch.Tensor] = None
    enc_idx: Optional[torch.Tensor] = None
    enc_cnt: Optional[torch.Tensor] = None
    enc_edge_row: Optional[torch.Tensor] = None
    enc_row_weight: Optional[torch.Tensor] = None
    enc_edge_perm: Optional[torch.Tensor] = None
    enc_row_sorted: Optional[torch.Tensor] = None
    enc_bucket_ids: Optional[torch.Tensor] = None
    enc_countmat: Optional[torch.Tensor] = None
    # uniform layout (static sizes): node id g*nodes_per_graph + i, edge
    # id g*edges_per_graph + k
    nodes_per_graph: Optional[int] = None
    edges_per_graph: Optional[int] = None

    def tensors(self) -> dict:
        """The tensor fields that are set, by name."""
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }

    def to(self, device="cuda") -> "GraphBatch":
        device = resolve_device(device)
        return dataclasses.replace(
            self, **{k: v.to(device) for k, v in self.tensors().items()}
        )

    @property
    def num_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]
