"""Batches for the reference: the raw graphs of one batch, in order, with
their ESC rows, concatenated into flat node and edge arrays."""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
from typing import Optional

import numpy as np
import torch

from perfbench.reference import esc

SELF_LOOP_BOND = 1  # the bond type of an appended self-loop


@dataclasses.dataclass
class Batch:
    num_graphs: int
    nodes_per_graph: torch.Tensor  # (G,) long
    x: torch.Tensor  # (N, F) node features as drawn
    node_graph: torch.Tensor  # (N,) long
    src: torch.Tensor  # (E,) long, global node ids
    dst: torch.Tensor  # (E,) long
    edge_attr: Optional[torch.Tensor]  # (E,) long or None
    rows: torch.Tensor  # (E, 1800) float32 ESC counts
    y: torch.Tensor  # (G, T) or (N, T) float32, normalized


def encode_all(graphs, h: int, workers: int) -> list:
    """`esc.encode_sparse` of every graph, across `workers` spawned
    processes when there are many."""
    args = [(g.num_nodes, g.edge_index, h) for g in graphs]
    if workers > 1 and len(args) > 64:
        with mp.get_context("spawn").Pool(workers) as pool:
            out = pool.map(esc.encode_sparse, args, chunksize=16)
            pool.close()
            pool.join()
        return out
    return [esc.encode_sparse(a) for a in args]


def make_batch(graphs, encodings, ys, device) -> Batch:
    """One batch of `graphs` with their `encodings` (`encode_all`) and
    normalized targets `ys` ((T,) per graph or (n, T) per node), on
    `device`."""
    width = int(np.asarray(ys[0]).shape[-1])
    xs, ng, src, dst, ea, rr, rc, rv, npg = [], [], [], [], [], [], [], [], []
    n_off = e_off = 0
    for gi, (g, (edges, pairs, cnt)) in enumerate(zip(graphs, encodings)):
        n, E = g.num_nodes, edges.shape[1]
        xs.append(np.asarray(g.x))
        ng.append(np.full(n, gi))
        npg.append(n)
        src.append(edges[0] + n_off)
        dst.append(edges[1] + n_off)
        if g.edge_attr is not None:
            ei = np.asarray(g.edge_index)
            base = np.asarray(g.edge_attr)[ei[0] != ei[1]]
            ea.append(np.concatenate(
                [base, np.full(E - base.shape[0], SELF_LOOP_BOND)]))
        rr.append(pairs[0].astype(np.int64) + e_off)
        rc.append(pairs[1])
        rv.append(cnt)
        n_off += n
        e_off += E
    rows = np.zeros((e_off, esc.DIM), np.float32)
    rows[np.concatenate(rr), np.concatenate(rc)] = np.concatenate(rv)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return Batch(
        num_graphs=len(graphs),
        nodes_per_graph=t(npg, torch.long),
        x=t(np.concatenate(xs), torch.float32 if np.asarray(xs[0]).dtype.kind
            == "f" else torch.long),
        node_graph=t(np.concatenate(ng), torch.long),
        src=t(np.concatenate(src), torch.long),
        dst=t(np.concatenate(dst), torch.long),
        edge_attr=t(np.concatenate(ea), torch.long) if ea else None,
        rows=t(rows, torch.float32),
        y=t(np.concatenate([np.asarray(y, np.float32).reshape(-1, width)
                            for y in ys]), torch.float32),
    )
