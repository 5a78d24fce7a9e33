"""Graph-level ESC pre-transform (counterpart of
`escgnn_tpu/featurize/transform.py`).

Takes a raw graph and returns the same graph with (a) the canonical
self-looped edge list, (b) edge attributes extended over appended
self-loops with a fill value (PyG add_self_loops semantics), and (c)
per-edge structural encoding rows attached.
"""

from __future__ import annotations

import multiprocessing as mp
from functools import partial

import numpy as np

from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.featurize.escgnn import EscConfig, esc_encode
from escgnn_tpu_torch.native.escfeat import esc_encode_native, set_num_threads
from escgnn_tpu_torch.utils import trace


def esc_transform(
    g: GraphData,
    cfg: EscConfig,
    self_loop_fill=1,
) -> GraphData:
    if cfg.max_nodes_per_hop is not None:
        # per-hop frontier subsampling runs on the numpy encoder (the
        # native core has no sampler), its rng derived per (seed, root,
        # hop) from this per-graph seed: the JAX package's rule
        seed = int(
            (np.asarray(g.edge_index, np.uint64).sum()
             + np.uint64(g.num_nodes)) & np.uint64(0x7FFFFFFF)
        )
        enc = esc_encode(g.num_nodes, g.edge_index, cfg, sample_seed=seed)
    else:
        # native C++ core first (bit-equal, OpenMP across edges); it
        # returns None when it declines (build unavailable, non-default
        # layout, or a failed Laplacian residual check) and the numpy
        # encoder takes over
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
    num_workers: int = 0,
    self_loop_fill=1,
) -> list[GraphData]:
    """Apply `esc_transform` to every graph, across `num_workers` forked
    processes when there are more than one (and more than 8 graphs), in
    the input's order.

    Fork, as the JAX package does, and not spawn: a spawned worker
    re-imports the caller's main module and with it torch, seconds per
    worker. Two hazards of fork, and what is done about them:
      * a child inherits the parent's OpenMP runtime without its threads,
        so a parallel region there could wait for them forever: each
        worker first sets its OpenMP team to one thread (`_one_thread`),
        and a team of one never waits for the pool;
      * a process that holds a CUDA context may fork only children that
        never touch CUDA: the workers run numpy and the native core only.
    Start no threads of your own before featurizing."""
    fn = partial(esc_transform, cfg=cfg, self_loop_fill=self_loop_fill)
    trace.count("featurize.graphs", len(graphs))
    with trace.span("featurize"):
        if num_workers and num_workers > 1 and len(graphs) > 8:
            with mp.get_context("fork").Pool(
                    num_workers, initializer=_one_thread) as pool:
                return pool.map(fn, graphs, chunksize=32)
        return [fn(g) for g in graphs]


def _one_thread() -> None:
    """Pool initializer: one OpenMP thread per worker, in torch's runtime
    and in the native core's (the same one when their sonames match)."""
    import torch

    torch.set_num_threads(1)
    set_num_threads(1)
