"""All-pairs SPD attention bias (GraphGPS / Graphormer-style); a copy of
`escgnn_tpu/featurize/spd.py`.

Mirror of reference `GraphGPS/graphgps/loader/utils_escgnn.py:28-39`:
per-graph dense shortest-path-distance matrix, capped (default 100);
unreachable pairs get cap + 1. Consumed by the GPS BiasedTransformer as a
per-head additive attention bias (distance-bucket embedding).
"""

from __future__ import annotations

import numpy as np

from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.featurize.bfs import hop_distance_matrix

SPD_CAP = 100


def attach_attn_bias(g: GraphData, cap: int = SPD_CAP) -> GraphData:
    n = g.num_nodes
    D = hop_distance_matrix(n, np.asarray(g.edge_index, np.int64), min(cap, n))
    D = np.minimum(D, cap + 1).astype(np.int16)
    extras = dict(g.extras or {})
    extras["attn_bias"] = D
    g.extras = extras
    return g
