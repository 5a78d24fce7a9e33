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

# flat name prefix of an extra in `GraphBatch.tensors()` and in the host
# arrays of `data/batching.py`
EXTRAS_PREFIX = "extras."


@dataclasses.dataclass
class GraphData:
    """One ragged graph (host side, numpy).

    Required: `num_nodes`, `edge_index` (2, E).
    Optional payloads: node features `x` (N, ...), edge features
    `edge_attr` (E, ...), targets `y` (node-level (N, T) or graph-level
    (T,)), 3D coordinates `pos` (N, 3).

    ESC structural encoding (ragged CSR over edges): `enc_idx`/`enc_cnt`
    are flat (total_nnz,) arrays and `enc_offsets` (E+1,) delimits each
    edge's run. `extras` holds named per-graph annotations (such as QM9's
    `node_type`); the batcher carries the node- and edge-aligned ones.
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
    flagged by `node_mask`. The width encoding layout carries (E, P)
    rows in `enc_idx`/`enc_cnt`; the flat layout carries (K,) COO
    entries `enc_flat_idx`/`enc_flat_cnt`/`enc_flat_edge` sorted by edge
    id (padding entries: count 0 on edge E - 1). The dedup encoding
    layout carries the batch's unique (R, P) rows in `enc_idx`/`enc_cnt`,
    the edge -> row map `enc_edge_row`, the rows' real-edge
    multiplicities `enc_row_weight`, the sorted-CSR view
    `enc_edge_perm`/`enc_row_sorted` (the input of the
    sorted-segment-sum kernel), the compact bucket ids `enc_bucket_ids`
    and, where it fits, the host count matrix `enc_countmat`. `extras`
    maps names to tensors padded like `x` (node-aligned), permuted like
    `edge_attr` (edge-aligned), padded to the copy budget (copy-aligned)
    or stacked per graph (`orig_adj`). The copy levels follow the JAX
    package's padding: padding nodes carry an out-of-range segment id,
    padding copies an out-of-range parent, and `center_idx` padding
    points at the last node slot (gathered, never scattered).

    `tensors()` lists every tensor by a flat name (an extra as
    `extras.<name>`) and `with_tensors` builds the batch back from such a
    mapping, so copies, stacks and pool entries carry the extras with the
    fields. The static layout ints (`nodes_per_graph`, `nodes_per_seg`,
    `seg_regions`, ...) ride along unchanged.
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
    # flat COO layout: (K,) entries sorted by edge id
    enc_flat_idx: Optional[torch.Tensor] = None
    enc_flat_cnt: Optional[torch.Tensor] = None
    enc_flat_edge: Optional[torch.Tensor] = None
    enc_edge_row: Optional[torch.Tensor] = None
    enc_row_weight: Optional[torch.Tensor] = None
    enc_edge_perm: Optional[torch.Tensor] = None
    enc_row_sorted: Optional[torch.Tensor] = None
    enc_bucket_ids: Optional[torch.Tensor] = None
    enc_countmat: Optional[torch.Tensor] = None
    # subgraph-copy level (NGNN two-level pooling)
    node_segment: Optional[torch.Tensor] = None  # node -> subgraph copy
    segment_graph: Optional[torch.Tensor] = None  # copy -> graph
    segment_mask: Optional[torch.Tensor] = None
    # (root, neighbor)-pair copy level (I2GNN three-level pooling)
    node_segment2: Optional[torch.Tensor] = None  # node -> pair copy
    segment2_parent: Optional[torch.Tensor] = None  # pair copy -> subgraph
    segment2_mask: Optional[torch.Tensor] = None
    center_idx: Optional[torch.Tensor] = None  # (S2, 2) (root, nbr) nodes
    # original-node level (I2GNN mean-context pooling)
    node_original: Optional[torch.Tensor] = None  # copy node -> orig node
    original_mask: Optional[torch.Tensor] = None
    extras: Optional[dict] = None
    # uniform layout (static sizes): node id g*nodes_per_graph + i, edge
    # id g*edges_per_graph + k
    nodes_per_graph: Optional[int] = None
    edges_per_graph: Optional[int] = None
    # uniform per-copy layout (`data/uniform_copies.py`): every copy
    # occupies an identical (nodes_per_seg, edges_per_seg) block, block
    # index == copy segment id
    nodes_per_seg: Optional[int] = None
    edges_per_seg: Optional[int] = None
    # two-size bucketed copy layout ((Cs, n_s, e_s), (Cl, n_l, e_l)): a
    # small region of Cs blocks, then a large region of Cl blocks
    seg_regions: Optional[tuple] = None

    def tensors(self) -> dict:
        """The tensors that are set, by flat name: fields by their name,
        extras as `extras.<name>`."""
        out = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        for k, v in (self.extras or {}).items():
            out[EXTRAS_PREFIX + k] = v
        return out

    def with_tensors(self, tensors: dict) -> "GraphBatch":
        """This batch with every tensor replaced from `tensors`, a mapping
        shaped like `tensors()` (the extras are replaced as a whole)."""
        fields = {k: v for k, v in tensors.items()
                  if not k.startswith(EXTRAS_PREFIX)}
        extras = {k[len(EXTRAS_PREFIX):]: v for k, v in tensors.items()
                  if k.startswith(EXTRAS_PREFIX)}
        return dataclasses.replace(self, extras=extras or None, **fields)

    def to(self, device="cuda") -> "GraphBatch":
        device = resolve_device(device)
        return self.with_tensors(
            {k: v.to(device) for k, v in self.tensors().items()})

    @property
    def num_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]
