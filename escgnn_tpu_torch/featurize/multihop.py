"""Multihop edge transform for GINE+ (k-hop message passing); the
counterpart of `escgnn_tpu/featurize/multihop.py`, bit-equal to it.

Capability mirror of reference `modules/gine_operations.py:256-303`
(`make_multihop_edges`): augment a graph with every node pair at shortest-
path distance 1..k, labeled with that distance ("min-coalesce" of the
adjacency powers).

Differences from the reference: instead of torch_sparse matmuls producing a
*separate* `multihop_edge_index`, the transform REPLACES the edge list
with the multihop one (row-major sorted, like torch_sparse.coalesce) and
stores the per-edge hop distance as an edge-aligned extra
(`extras["edge_distance"]`). The original bond features ride on the
distance-1 rows; higher-distance rows carry zero edge_attr. Downstream,
GINE+ masks messages by distance, so one padded edge list serves every
hop — no per-distance edge sets, no dynamic shapes.
"""

from __future__ import annotations

import numpy as np

from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.featurize.bfs import hop_distance_matrix


def make_multihop_edges(g: GraphData, k: int) -> GraphData:
    """Return a new GraphData whose edge list contains all pairs at
    shortest-path distance 1..k (self pairs / distance 0 excluded, as the
    reference never propagates over them), sorted row-major.

    Adds extras:
      edge_distance: (E',) int16 hop distance per edge, in [1, k].
    Distance-1 rows keep the original `edge_attr` (duplicate parallel
    edges are merged; molecules have none).
    """
    n = g.num_nodes
    ei = np.asarray(g.edge_index, np.int64)
    D = hop_distance_matrix(n, ei, k)  # (N, N); > k where unreachable
    src, dst = np.nonzero((D >= 1) & (D <= k))
    dist = D[src, dst].astype(np.int16)
    # row-major (src, dst) order == torch_sparse coalesce order
    order = np.lexsort((dst, src))
    src, dst, dist = src[order], dst[order], dist[order]

    edge_attr = None
    if g.edge_attr is not None:
        ea = np.asarray(g.edge_attr)
        ea2 = ea.reshape(ea.shape[0], -1)
        out = np.zeros((src.shape[0],) + ea2.shape[1:], ea2.dtype)
        # map original edges onto their (deduped) distance-1 rows
        key_new = src * n + dst
        key_old = ei[0] * n + ei[1]
        pos = np.searchsorted(key_new, key_old)
        ok = (pos < key_new.shape[0]) & (key_new[np.minimum(pos, len(key_new) - 1)] == key_old)
        out[pos[ok]] = ea2[ok]
        edge_attr = out.reshape((src.shape[0],) + ea.shape[1:])

    extras = dict(g.extras or {})
    extras["edge_distance"] = dist
    return GraphData(
        num_nodes=n,
        edge_index=np.stack([src, dst]).astype(np.int32),
        x=g.x,
        edge_attr=edge_attr,
        y=g.y,
        pos=g.pos,
        extras=extras,
    )
