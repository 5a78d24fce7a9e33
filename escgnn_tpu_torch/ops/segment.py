"""Masked segment reductions (counterpart of the parts of
`escgnn_tpu/ops/segment.py` the flagship path uses).

Every op takes an explicit validity mask instead of relying on
out-of-range ids being dropped, so padding policy lives in one place.
"""

from __future__ import annotations

from typing import Optional

import torch


def _apply_mask(values, mask: Optional[torch.Tensor]):
    if mask is None:
        return values
    m = mask.reshape(mask.shape + (1,) * (values.dim() - mask.dim()))
    return torch.where(m, values, torch.zeros((), dtype=values.dtype,
                                              device=values.device))


def segment_sum(values, segment_ids, num_segments: int,
                mask: Optional[torch.Tensor] = None):
    """sum_i values[i] into rows segment_ids[i]; masked-out rows
    contribute 0."""
    values = _apply_mask(values, mask)
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, segment_ids.long(), values)


def pool_nodes_to_graphs(values, batch, reduce: str = "sum"):
    """Pool per-node rows to per-graph rows: (N, F) -> (G, F).

    On the uniform per-graph block layout this is a masked reshape + axis
    reduction, which (as `jnp.sum` does) sums low-precision inputs in f32
    and casts the result back; otherwise the masked segment reduction.
    """
    G = batch.num_graphs
    n_u = batch.nodes_per_graph
    mask = batch.node_mask
    if n_u is not None and values.shape[0] == G * n_u:
        v = values.reshape(G, n_u, *values.shape[1:])
        m = mask.reshape(G, n_u)
        mm = m.reshape(m.shape + (1,) * (v.dim() - 2))
        s = torch.where(mm, v.float(), 0.0).sum(1)
        if reduce == "sum":
            return s.to(values.dtype)
        if reduce == "mean":
            cnt = m.float().sum(1).clamp_min(1.0)
            return (s / cnt.reshape((G,) + (1,) * (s.dim() - 1))).to(
                values.dtype)
        raise ValueError(reduce)
    s = segment_sum(values, batch.node_graph, G, mask)
    if reduce == "sum":
        return s
    if reduce == "mean":
        cnt = segment_sum(mask.to(s.dtype), batch.node_graph, G).clamp_min(1.0)
        return s / cnt.reshape((G,) + (1,) * (s.dim() - 1))
    raise ValueError(reduce)
