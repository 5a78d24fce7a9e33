"""All-pairs SPD attention bias (GraphGPS / Graphormer-style); a copy of
`escgnn_tpu/featurize/spd.py`.

Mirror of reference `GraphGPS/graphgps/loader/utils_escgnn.py:28-39`:
per-graph dense shortest-path-distance matrix, capped (default 100);
unreachable pairs, and pairs over `cap` hops apart, get min(cap, n) + 1
for a graph of n nodes (the BFS runs min(cap, n) hops). Consumed by the
GPS BiasedTransformer as a per-head additive attention bias
(distance-bucket embedding). `attach_attn_bias_many` runs it over a list
under the span `featurize.spd` and counts its graphs in
`featurize.spd_graphs` (`utils/trace.py`).
"""

from __future__ import annotations

import numpy as np

from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.featurize.bfs import hop_distance_matrix
from escgnn_tpu_torch.utils import trace

SPD_CAP = 100


def attach_attn_bias(g: GraphData, cap: int = SPD_CAP) -> GraphData:
    n = g.num_nodes
    D = hop_distance_matrix(n, np.asarray(g.edge_index, np.int64), min(cap, n))
    D = np.minimum(D, cap + 1).astype(np.int16)
    extras = dict(g.extras or {})
    extras["attn_bias"] = D
    g.extras = extras
    return g


def attach_attn_bias_many(graphs, cap: int = SPD_CAP) -> list:
    """`attach_attn_bias` on each of `graphs`, in place, as one
    `featurize.spd` span; the graphs count in `featurize.spd_graphs`."""
    with trace.span("featurize.spd"):
        out = [attach_attn_bias(g, cap) for g in graphs]
    trace.count("featurize.spd_graphs", len(out))
    return out
