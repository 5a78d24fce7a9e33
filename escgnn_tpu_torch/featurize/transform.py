"""Graph-level ESC pre-transform (counterpart of
`escgnn_tpu/featurize/transform.py`).

Takes a raw graph and returns the same graph with (a) the canonical
self-looped edge list, (b) edge attributes extended over appended
self-loops with a fill value (PyG add_self_loops semantics), and (c)
per-edge structural encoding rows attached.
"""

from __future__ import annotations

import numpy as np

from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.featurize.escgnn import EscConfig, esc_encode
from escgnn_tpu_torch.native.escfeat import esc_encode_native


def esc_transform(
    g: GraphData,
    cfg: EscConfig,
    self_loop_fill=1,
) -> GraphData:
    # native C++ core first (bit-equal, OpenMP across edges); it returns
    # None when it declines (build unavailable, non-default layout, or a
    # failed Laplacian residual check) and the numpy encoder takes over
    enc = esc_encode_native(g.num_nodes, g.edge_index, cfg)
    if enc is None:
        enc = esc_encode(g.num_nodes, g.edge_index, cfg)
    edge_attr = g.edge_attr
    if edge_attr is not None and cfg.self_loop:
        # Original non-self-loop edges keep their attrs (in order); the
        # appended (i, i) loops get the fill value.
        orig = g.edge_index[0] != g.edge_index[1]
        base = edge_attr[orig]
        fill_shape = (int(enc.self_loop_attr_mask.sum()),) + edge_attr.shape[1:]
        fill = np.full(fill_shape, self_loop_fill, dtype=edge_attr.dtype)
        edge_attr = np.concatenate([base, fill], axis=0)
    return GraphData(
        num_nodes=g.num_nodes,
        edge_index=enc.edge_index,
        x=g.x,
        edge_attr=edge_attr,
        y=g.y,
        pos=g.pos,
        enc_idx=enc.enc_idx,
        enc_cnt=enc.enc_cnt,
        enc_offsets=enc.enc_offsets,
        extras=g.extras,
    )


def featurize_many(
    graphs: list[GraphData],
    cfg: EscConfig,
    self_loop_fill=1,
) -> list[GraphData]:
    """Apply `esc_transform` to every graph, in this process (the native
    core already spreads each graph's edges over OpenMP threads)."""
    return [esc_transform(g, cfg, self_loop_fill) for g in graphs]
