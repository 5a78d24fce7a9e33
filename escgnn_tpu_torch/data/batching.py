"""Static-shape batching (counterpart of `escgnn_tpu/data/batching.py`).

Graphs are packed into a fixed `BatchSpec` budget (padded arrays +
validity masks). Edges are re-ordered by receiver inside every graph and
every edge payload (attrs, ESC encoding rows) rides the same
permutation. The host arrays are bit-equal to the JAX batcher's; only
the last step differs: `pad_and_batch` hands them over as tensors on the
requested device.

This package carries the whole JAX batcher: `BatchSpec.from_graphs` /
`BatchSpec.uniform` / `BatchSpec.exact` with the `width`, `dedup` and
`flat` encoding layouts, `BatchSpec.copy_uniform` (the uniform per-copy
blocks of `data/uniform_copies.py`), `batch_iterator`,
`packed_batch_iterator` (greedy packing under every budget, the flat
entries included), the subgraph-copy levels of the copy family (`node_segment`,
`node_segment2`, `center_idx`, `node_original` and their masks), the
dense `orig_adj`, the k-set levels of the k-GNN family (`kset{k}_*` and
`assign_2to3_*` extras), GPS's dense SPD matrix `attn_bias` (stacked into
(G, M, M), M = `max_nodes_per_graph`) and labeled link pairs
(`pair_index` / `pair_label` / `pair_graph` / `pair_mask` under the
`num_pairs` budget), and the generic node-, edge- and copy-aligned graph
extras.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from escgnn_tpu_torch.data.container import EXTRAS_PREFIX, GraphBatch, GraphData
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.utils import trace

# extras that the JAX batcher folds into dedicated fields and budgets
_STRUCTURAL_KEYS = frozenset({
    "node_to_subgraph", "num_subgraphs",
    "node_to_subgraph2", "num_subgraphs2", "subgraph2_to_subgraph",
    "center_idx", "node_to_original_node", "num_original_nodes",
    "orig_adj", "node_valid", "edge_valid",
    "assign_2to3", "num_assign_2to3",
    "attn_bias", "pair_index", "pair_label",
})

# wire dtypes: the ESC bucket ids (< 1800) and counts (small ints) ship as
# int16; ops cast on device
_ENC_DTYPE = np.int16


def _round_up(v: int, m: int) -> int:
    return int(-(-int(v) // m) * m)


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Static padding budget: every batch of a dataset has these shapes.

    `from_graphs` sizes every budget as batch_size x the per-graph
    maximum, so any `batch_size`-subset of the dataset fits; `uniform`
    pads every graph to an identical (nodes, edges) block; `exact` sizes
    the budgets for one specific list of graphs with minimal rounding.
    """

    num_graphs: int
    num_nodes: int
    num_edges: int
    # ESC encoding: fixed-width rows (enc_width > 0), optionally
    # deduplicated into num_enc_rows unique rows + an edge->row map, or
    # flat COO entries (num_enc_nnz > 0)
    enc_width: int = 0
    y_is_node_level: bool = False
    num_enc_nnz: int = 0
    num_enc_rows: int = 0
    # >0: compact the bucket universe per batch — enc_idx is remapped to
    # [0, num_enc_buckets) and `enc_bucket_ids` maps back to table rows
    num_enc_buckets: int = 0
    # subgraph-copy budgets
    num_segments: int = 0
    num_segments2: int = 0
    num_original: int = 0
    # dense budgets (NestedPPGN's orig_adj)
    max_nodes_per_graph: int = 0
    max_segments_per_graph: int = 0
    # k-set graph budgets (the k-GNN family)
    num_kset2: int = 0
    num_kset2_edges: int = 0
    num_kset2_assign: int = 0
    num_kset3: int = 0
    num_kset3_edges: int = 0
    num_kset3_assign: int = 0
    num_assign_2to3: int = 0
    # uniform layout: node id g*uniform_nodes + i, edge id
    # g*uniform_edges + k
    uniform_nodes: int = 0
    uniform_edges: int = 0
    # uniform per-copy layout (copy family; `data/uniform_copies.py`):
    # graphs arrive pre-uniformized, every copy padded to an identical
    # (copy_nodes, copy_edges) block; num_nodes / num_edges are whole
    # multiples, so block index == copy segment id batch-wide
    copy_nodes: int = 0
    copy_edges: int = 0
    # labeled link-prediction pairs (the inductive-edge task)
    num_pairs: int = 0

    @classmethod
    def from_graphs(
        cls,
        graphs: Sequence[GraphData],
        batch_size: int,
        enc_layout: str = "width",
    ) -> "BatchSpec":
        kw, bs, mx = _spec_budgets(graphs, batch_size, enc_layout)
        # +1: padding edges park on a dedicated padding node
        kw["num_nodes"] = _round_up(bs * mx["nodes"] + 1, 8)
        kw["num_edges"] = _round_up(bs * mx["edges"], 128)
        return cls(
            num_graphs=bs, y_is_node_level=_infer_node_level_y(graphs), **kw
        )

    @classmethod
    def uniform(
        cls,
        graphs: Sequence[GraphData],
        batch_size: int,
        enc_layout: str = "width",
    ) -> "BatchSpec":
        """Per-graph uniform blocks: every graph is padded to the same
        (nodes, edges) block. `uniform_nodes` reserves one always-padding
        trailing slot per block (max_nodes+1 rounded up) so padding edges
        can park on it without colliding with a real node."""
        kw, bs, mx = _spec_budgets(graphs, batch_size, enc_layout)
        n_u = _round_up(mx["nodes"] + 1, 8)
        e_u = _round_up(mx["edges"], 8)
        kw["num_nodes"] = bs * n_u
        kw["num_edges"] = bs * e_u
        kw["uniform_nodes"] = n_u
        kw["uniform_edges"] = e_u
        return cls(
            num_graphs=bs, y_is_node_level=_infer_node_level_y(graphs), **kw
        )

    @classmethod
    def copy_uniform(
        cls,
        graphs: Sequence[GraphData],
        batch_size: int,
        enc_layout: str = "width",
        exact: bool = False,
    ) -> "BatchSpec":
        """Uniform per-copy blocks for the copy family (NGNN / I2GNN).

        `graphs` must come from `uniform_copies.uniformize_copies` (each
        copy padded to the dataset-wide (n_c, e_c) block). Budgets are
        whole multiples of the block, so the batch reshapes to
        (C, n_c, ...) with block index == copy segment id; the copy
        level's segment budget is pinned to the block count. `exact`
        sizes the block count for exactly this list of graphs."""
        kw, bs, _ = _spec_budgets(graphs, batch_size, enc_layout)
        ex0 = graphs[0].extras or {}
        n_c = int(ex0["num_copy_nodes"])
        e_c = int(ex0["num_copy_edges"])
        if exact:
            c_budget = _round_up(
                sum(g.num_nodes // n_c for g in graphs) + 1, 8)
        else:
            c_max = max(g.num_nodes // n_c for g in graphs)
            c_budget = _round_up(bs * c_max + 1, 8)
        kw["num_nodes"] = c_budget * n_c
        kw["num_edges"] = c_budget * e_c
        kw["copy_nodes"] = n_c
        kw["copy_edges"] = e_c
        if "node_to_subgraph2" in ex0:
            kw["num_segments2"] = c_budget
        else:
            kw["num_segments"] = c_budget
        return cls(
            num_graphs=bs, y_is_node_level=_infer_node_level_y(graphs), **kw
        )

    @classmethod
    def exact(cls, graphs: Sequence[GraphData],
              enc_layout: str = "width") -> "BatchSpec":
        """Tight budget for exactly this list of graphs: padding drops to
        rounding slack. On the dedup layout the row budget is the list's
        true cross-graph distinct-row count."""
        _check_layout(graphs, enc_layout)
        mx = _per_graph_maxima(graphs)
        stats = [_graph_stats(g) for g in graphs]
        tot = {k: sum(s.get(k, 0) for s in stats)
               for k in set().union(*stats)}
        tot["enc_w"] = mx["enc_w"]  # width is per edge: always the max
        if enc_layout == "dedup":
            if graphs[0].enc_offsets is not None:
                rows = set()
                for g in graphs:
                    off = np.asarray(g.enc_offsets)
                    gi, gc = np.asarray(g.enc_idx), np.asarray(g.enc_cnt)
                    for e in range(len(off) - 1):
                        lo, hi = int(off[e]), int(off[e + 1])
                        rows.add(tuple(gi[lo:hi].tolist()
                                       + gc[lo:hi].tolist()))
                tot["enc_rows"] = len(rows)
            tot["enc_buckets"] = _distinct_bucket_budget(graphs)
            tot["enc_rows_topk"] = tot["enc_rows_cap"] = 0
        kw = _budgets_from(tot, scale=1, enc_layout=enc_layout)
        kw["max_nodes_per_graph"] = mx["nodes"]
        kw["max_segments_per_graph"] = mx["segments"]
        kw["num_nodes"] = _round_up(tot["nodes"] + 1, 8)
        kw["num_edges"] = _round_up(max(tot["edges"], 1), 128)
        return cls(num_graphs=len(graphs),
                   y_is_node_level=_infer_node_level_y(graphs), **kw)


def _check_layout(graphs, enc_layout):
    if not graphs:
        raise ValueError("need at least one graph to size a BatchSpec")
    if enc_layout not in ("width", "dedup", "flat"):
        raise ValueError(f"enc_layout {enc_layout!r}: width, dedup or flat")


def _spec_budgets(graphs, batch_size, enc_layout):
    _check_layout(graphs, enc_layout)
    bs = int(batch_size)
    # the sizing pass over every graph (its row hashes take seconds on a
    # dataset), for each batch spec built from graphs
    with trace.span("pools.size"):
        mx = _per_graph_maxima(graphs)
        if enc_layout == "dedup":
            mx["enc_buckets"] = _distinct_bucket_budget(graphs)
            mx["enc_rows_cap"] = _distinct_row_cap(graphs)
            mx["enc_rows_topk"] = _topk_row_sum(graphs, bs)
    return _budgets_from(mx, scale=bs, enc_layout=enc_layout), bs, mx


def _infer_node_level_y(graphs) -> bool:
    g = next((g for g in graphs if g.y is not None), None)
    if g is None:
        return False
    y = np.asarray(g.y)
    return bool(y.ndim >= 1 and y.shape[0] == g.num_nodes and g.num_nodes > 1)


def _graph_stats(g: GraphData) -> dict:
    ex = g.extras or {}
    s = {"nodes": g.num_nodes, "edges": g.num_edges, "enc_w": 0,
         "enc_nnz": 0, "enc_rows": 0,
         "segments": int(ex.get("num_subgraphs", 0)),
         "segments2": int(ex.get("num_subgraphs2", 0)),
         "original": int(ex.get("num_original_nodes", 0)),
         "a23": int(ex.get("num_assign_2to3", 0)),
         "pairs": (int(np.asarray(ex["pair_index"]).shape[1])
                   if "pair_index" in ex else 0)}
    if g.enc_offsets is not None:
        nnz = np.diff(np.asarray(g.enc_offsets))
        s["enc_w"] = int(nnz.max()) if nnz.size else 0
        s["enc_nnz"] = int(nnz.sum())
        s["enc_rows"] = len(np.unique(_graph_row_hashes(g)))
    for k in (2, 3):
        if f"num_kset{k}" in ex:
            s[f"kset{k}"] = int(ex[f"num_kset{k}"])
            s[f"kset{k}_edges"] = int(ex[f"kset{k}_edge_index"].shape[1])
            s[f"kset{k}_assign"] = int(ex[f"kset{k}_assign"].shape[1])
    return s


def _per_graph_maxima(graphs) -> dict:
    stats = [_graph_stats(g) for g in graphs]
    keys = set().union(*(s.keys() for s in stats))
    return {k: max(s.get(k, 0) for s in stats) for k in keys}


def _distinct_row_cap(graphs) -> int:
    """Dataset-wide distinct (idx, cnt) encoding rows: a hard upper bound
    on any batch's unique-row count (counted via 63-bit row hashes; the
    batcher's `len(uniq) <= R` check still catches any real overflow)."""
    seen: set = set()
    for g in graphs:
        h = _graph_row_hashes(g)
        if h is not None:
            seen.update(h.tolist())
    return len(seen)


def _topk_row_sum(graphs, k: int) -> int:
    """Sum of the k largest per-graph unique-row counts: a valid static
    bound on any k-graph batch's unique rows."""
    counts = sorted(
        (
            len(np.unique(h))
            for h in (_graph_row_hashes(g) for g in graphs)
            if h is not None
        ),
        reverse=True,
    )
    return int(sum(counts[:k]))


def _graph_row_hashes(g) -> "np.ndarray | None":
    """63-bit hash per encoding row of one graph. Rows with equal (idx,
    cnt) content hash equally regardless of per-graph width (zero padding
    contributes 0; the cnt seeds use a fixed offset so they never overlap
    the idx seeds)."""
    if g.enc_offsets is None:
        return None
    off = np.asarray(g.enc_offsets)
    nnz = np.diff(off)
    n_e = len(nnz)
    if n_e == 0:
        return None
    w = int(nnz.max())
    idxm = np.zeros((n_e, w), np.int64)
    cntm = np.zeros((n_e, w), np.int64)
    rows = np.repeat(np.arange(n_e), nnz)
    cols = np.arange(len(np.asarray(g.enc_idx))) - np.repeat(off[:-1], nnz)
    idxm[rows, cols] = np.asarray(g.enc_idx)
    cntm[rows, cols] = np.asarray(g.enc_cnt)
    return idxm @ _HASH_SEED[:w] + cntm @ _HASH_SEED[2048:2048 + w]


def _distinct_bucket_budget(graphs) -> int:
    """Dataset-wide distinct ESC bucket count -> static compaction budget.
    0 disables compaction (the active set wouldn't beat the raw id
    space)."""
    ids: set = set()
    cap = 0
    for g in graphs:
        if g.enc_idx is None:
            continue
        a = np.asarray(g.enc_idx)
        if a.size == 0:
            continue
        u = np.unique(a)
        ids.update(u.tolist())
        cap = max(cap, int(u[-1]) + 1)
    if not ids:
        return 0
    budget = _round_up(len(ids), 128)
    return budget if budget < _round_up(cap, 128) else 0


def _budgets_from(m: dict, scale: int, enc_layout: str) -> dict:
    kw = dict(enc_width=0, num_enc_nnz=0, num_enc_rows=0,
              max_nodes_per_graph=m["nodes"],
              max_segments_per_graph=m["segments"])
    for level, key in (("segments", "num_segments"),
                       ("segments2", "num_segments2"),
                       ("original", "num_original")):
        kw[key] = _round_up(scale * m[level], 8) if m[level] else 0
    kw["num_assign_2to3"] = _round_up(scale * m["a23"], 16) if m["a23"] else 0
    kw["num_pairs"] = _round_up(scale * m["pairs"], 16) if m["pairs"] else 0
    for k in (2, 3):
        sets = m.get(f"kset{k}", 0)
        kw[f"num_kset{k}"] = _round_up(scale * sets, 8) if sets else 0
        for part in ("edges", "assign"):
            n = m.get(f"kset{k}_{part}", 0) if sets else 0
            kw[f"num_kset{k}_{part}"] = (
                _round_up(scale * n, 16) if sets else 0)
    if m["enc_w"] and enc_layout == "flat":
        kw["num_enc_nnz"] = _round_up(scale * m["enc_nnz"], 128)
    elif m["enc_w"]:
        kw["enc_width"] = _round_up(m["enc_w"], 8)
        if enc_layout == "dedup":
            # +1: the all-zero row every padding edge maps to; capped by
            # the top-k per-graph sum and the dataset-wide distinct-row
            # count (no batch can exceed either, whatever the shuffle)
            rows = scale * m["enc_rows"]
            if m["enc_rows_topk"]:
                rows = min(rows, m["enc_rows_topk"])
            if m["enc_rows_cap"]:
                rows = min(rows, m["enc_rows_cap"])
            kw["num_enc_rows"] = _round_up(rows + 1, 128)
            kw["num_enc_buckets"] = m["enc_buckets"]
    return kw


# ---------------------------------------------------------------------------
# pad_and_batch
# ---------------------------------------------------------------------------


def _pad_rows(parts, lengths, budget, offsets):
    """Per-graph row blocks placed at `offsets`, zero-padded to `budget`
    rows."""
    ref = np.asarray(parts[0])
    out = np.zeros((budget,) + ref.shape[1:], ref.dtype)
    for p, n, off in zip(parts, lengths, offsets):
        if n:
            out[off:off + n] = np.asarray(p).reshape((n,) + out.shape[1:])
    return out


def batch_arrays(graphs: Sequence[GraphData], spec: BatchSpec) -> dict:
    """The padded host arrays of one batch, by the flat names of
    `GraphBatch.tensors()` (bit-equal to the JAX batcher's fields and
    extras on the same graphs and spec)."""
    G = len(graphs)
    if not 0 < G <= spec.num_graphs:
        raise ValueError(f"{G} graphs for a {spec.num_graphs}-graph spec")
    n_sizes = [g.num_nodes for g in graphs]
    e_sizes = [g.num_edges for g in graphs]
    uniform = spec.uniform_nodes > 0
    if uniform:
        n_u, e_u = spec.uniform_nodes, spec.uniform_edges
        if max(n_sizes) >= n_u or max(e_sizes) > e_u:
            raise ValueError(
                f"graph ({max(n_sizes)}, {max(e_sizes)}) exceeds the "
                f"uniform block ({n_u - 1}, {e_u})"
            )
        node_off = np.arange(G + 1) * n_u
        edge_off = np.arange(G + 1) * e_u
    else:
        if sum(n_sizes) >= spec.num_nodes or sum(e_sizes) > spec.num_edges:
            raise ValueError("graphs exceed the node or edge budget")
        if spec.copy_nodes and (
                any(n % spec.copy_nodes for n in n_sizes)
                or any(e % spec.copy_edges for e in e_sizes)):
            # consecutive offsets stay block-aligned only if every graph
            # is a whole number of copy blocks
            raise ValueError("graphs are not uniformized to the spec's "
                             f"({spec.copy_nodes}, {spec.copy_edges}) "
                             "copy blocks")
        node_off = np.concatenate([[0], np.cumsum(n_sizes)])
        edge_off = np.concatenate([[0], np.cumsum(e_sizes)])
    N, E, NG = spec.num_nodes, spec.num_edges, spec.num_graphs

    # --- per-graph receiver-sorted edge permutations ---
    perms = []
    for g in graphs:
        ei = np.asarray(g.edge_index)
        perms.append(np.lexsort((ei[0], ei[1])))  # by receiver, then sender

    # --- core index arrays ---
    if uniform:
        # padding edges park on their own block's trailing slot — always
        # a padding node, keeping receivers non-decreasing
        park = (np.repeat(np.arange(NG, dtype=np.int32), e_u) * n_u
                + n_u - 1)
        senders = park.copy()
        receivers = park.copy()
    else:
        senders = np.full(E, N - 1, np.int32)  # padding parks on last slot
        receivers = np.full(E, N - 1, np.int32)
    node_graph = np.full(N, NG - 1, np.int32)
    if uniform:
        node_graph[:] = np.repeat(np.arange(NG, dtype=np.int32), n_u)
    node_local = np.full(
        N, max(spec.max_nodes_per_graph, max(n_sizes)), np.int32
    )
    node_mask = np.zeros(N, bool)
    edge_mask = np.zeros(E, bool)
    for i, g in enumerate(graphs):
        ei = np.asarray(g.edge_index)[:, perms[i]]
        ns, es = node_off[i], edge_off[i]
        senders[es:es + e_sizes[i]] = ei[0] + ns
        receivers[es:es + e_sizes[i]] = ei[1] + ns
        node_graph[ns:node_off[i + 1]] = i
        node_local[ns:ns + n_sizes[i]] = np.arange(n_sizes[i], dtype=np.int32)
        node_mask[ns:ns + n_sizes[i]] = True
        edge_mask[es:es + e_sizes[i]] = True

    graph_mask = np.zeros(NG, bool)
    graph_mask[:G] = True

    # uniform per-copy layout: the copies' padding rows and edges are
    # flagged by the node_valid / edge_valid extras, ANDed into the masks
    ex0 = graphs[0].extras or {}
    if "node_valid" in ex0:
        node_mask &= _pad_rows(
            [np.asarray(g.extras["node_valid"], bool) for g in graphs],
            n_sizes, N, node_off)
    if "edge_valid" in ex0:
        edge_mask &= _pad_rows(
            [np.asarray(g.extras["edge_valid"], bool)[perms[i]]
             for i, g in enumerate(graphs)], e_sizes, E, edge_off)

    fields: dict = dict(
        senders=senders,
        receivers=receivers,
        node_graph=node_graph,
        node_local=node_local,
        node_mask=node_mask,
        edge_mask=edge_mask,
        graph_mask=graph_mask,
    )
    if graphs[0].x is not None:
        fields["x"] = _pad_rows([g.x for g in graphs], n_sizes, N, node_off)
    if graphs[0].pos is not None:
        fields["pos"] = _pad_rows([g.pos for g in graphs], n_sizes, N, node_off)
    if graphs[0].edge_attr is not None:
        fields["edge_attr"] = _pad_rows(
            [np.asarray(g.edge_attr)[perms[i]] for i, g in enumerate(graphs)],
            e_sizes, E, edge_off,
        )
    if graphs[0].y is not None:
        if spec.y_is_node_level:
            fields["y"] = _pad_rows([g.y for g in graphs], n_sizes, N, node_off)
        else:
            rows = [np.asarray(g.y).reshape(-1) for g in graphs]
            y = np.zeros((NG, rows[0].shape[0]), rows[0].dtype)
            y[:G] = np.stack(rows)
            fields["y"] = y
    if graphs[0].enc_offsets is not None and (
            spec.enc_width > 0 or spec.num_enc_nnz > 0):
        fields.update(_batch_encoding(graphs, perms, edge_off, spec))
    if "num_subgraphs" in ex0 and spec.num_segments > 0:
        fields.update(_batch_segments(graphs, n_sizes, node_off, spec))
    if "node_to_subgraph2" in ex0 and spec.num_segments2 > 0:
        fields.update(_batch_segments2(graphs, n_sizes, node_off, spec))
    if "node_to_original_node" in ex0 and spec.num_original > 0:
        fields.update(_batch_original(graphs, n_sizes, node_off, spec))
    if "pair_index" in ex0 and spec.num_pairs > 0:
        for k, v in _batch_pairs(graphs, node_off, spec).items():
            fields[EXTRAS_PREFIX + k] = v
    for k, v in _batch_ksets(graphs, node_off, spec).items():
        fields[EXTRAS_PREFIX + k] = v
    for k, v in _batch_named_extras(graphs, n_sizes, e_sizes, perms,
                                    node_off, edge_off, spec).items():
        fields[EXTRAS_PREFIX + k] = v
    return fields


def _batch_pairs(graphs, node_off, spec: BatchSpec) -> dict:
    """Labeled link-prediction pairs, concatenated in graph order and
    offset to batch node ids. Padding pairs park on the padding node slot
    (N - 1) with label 0 in the last graph; `pair_mask` drops them from
    the loss."""
    p_sizes = [int(np.asarray(g.extras["pair_index"]).shape[1])
               for g in graphs]
    P = spec.num_pairs
    if sum(p_sizes) > P:
        raise ValueError(f"{sum(p_sizes)} pairs exceed the {P}-pair budget")
    N, NG = spec.num_nodes, spec.num_graphs
    pair_index = np.full((2, P), N - 1, np.int32)
    pair_label = np.zeros(P, np.float32)
    pair_graph = np.full(P, NG - 1, np.int32)
    pair_mask = np.zeros(P, bool)
    p_off = np.concatenate([[0], np.cumsum(p_sizes)])
    for i, g in enumerate(graphs):
        ps, pe = p_off[i], p_off[i + 1]
        pair_index[:, ps:pe] = np.asarray(g.extras["pair_index"]) + node_off[i]
        pair_label[ps:pe] = np.asarray(g.extras["pair_label"], np.float32)
        pair_graph[ps:pe] = i
        pair_mask[ps:pe] = True
    return dict(pair_index=pair_index, pair_label=pair_label,
                pair_graph=pair_graph, pair_mask=pair_mask)


def _batch_segments(graphs, n_sizes, node_off, spec: BatchSpec) -> dict:
    """Subgraph-copy level. `segment_graph` / `segment_mask` exist whenever
    graphs declare `num_subgraphs` (the pair transform has subgraphs as
    the middle pooling level without a node -> subgraph map);
    `node_segment` needs `node_to_subgraph` too. Padding nodes carry the
    out-of-range id S, padding copies the last graph slot."""
    S = spec.num_segments
    s_sizes = [int(_ex(g, "num_subgraphs", 0)) for g in graphs]
    if sum(s_sizes) > S:
        raise ValueError(f"{sum(s_sizes)} subgraphs, budget {S}")
    s_off = np.concatenate([[0], np.cumsum(s_sizes)])
    segment_graph = np.full(S, spec.num_graphs - 1, np.int32)
    segment_mask = np.zeros(S, bool)
    for i in range(len(graphs)):
        segment_graph[s_off[i]:s_off[i + 1]] = i
    segment_mask[:s_off[-1]] = True
    out = {"segment_graph": segment_graph, "segment_mask": segment_mask}
    if "node_to_subgraph" in (graphs[0].extras or {}):
        node_segment = np.full(spec.num_nodes, S, np.int32)
        for i, g in enumerate(graphs):
            ns = node_off[i]
            node_segment[ns:ns + n_sizes[i]] = (
                np.asarray(g.extras["node_to_subgraph"]) + s_off[i])
        out["node_segment"] = node_segment
    return out


def _batch_segments2(graphs, n_sizes, node_off, spec: BatchSpec) -> dict:
    """(root, neighbour)-pair copy level: node -> pair copy, pair copy ->
    root subgraph (padding: out of range), and the batched `center_idx`
    (padding: the last node slot, in range because it is gathered)."""
    S, S2 = spec.num_segments, spec.num_segments2
    s_sizes = [int(_ex(g, "num_subgraphs", 0)) for g in graphs]
    s2_sizes = [int(_ex(g, "num_subgraphs2", 0)) for g in graphs]
    if sum(s2_sizes) > S2:
        raise ValueError(f"{sum(s2_sizes)} pair copies, budget {S2}")
    s_off = np.concatenate([[0], np.cumsum(s_sizes)])
    s2_off = np.concatenate([[0], np.cumsum(s2_sizes)])
    node_segment2 = np.full(spec.num_nodes, S2, np.int32)
    segment2_parent = np.full(S2, S, np.int32)
    segment2_mask = np.zeros(S2, bool)
    center = np.full((S2, 2), spec.num_nodes - 1, np.int32)
    for i, g in enumerate(graphs):
        ex = g.extras
        ns = node_off[i]
        node_segment2[ns:ns + n_sizes[i]] = (
            np.asarray(ex["node_to_subgraph2"]) + s2_off[i])
        segment2_parent[s2_off[i]:s2_off[i + 1]] = (
            np.asarray(ex["subgraph2_to_subgraph"]) + s_off[i])
        if "center_idx" in ex:
            center[s2_off[i]:s2_off[i + 1]] = (
                np.asarray(ex["center_idx"]) + node_off[i])
    segment2_mask[:s2_off[-1]] = True
    return {
        "node_segment2": node_segment2,
        "segment2_parent": segment2_parent,
        "segment2_mask": segment2_mask,
        "center_idx": center,
    }


def _batch_original(graphs, n_sizes, node_off, spec: BatchSpec) -> dict:
    """Copy node -> original node (padding: out of range) and the
    original-node mask."""
    o_sizes = [int(_ex(g, "num_original_nodes", 0)) for g in graphs]
    if sum(o_sizes) > spec.num_original:
        raise ValueError(f"{sum(o_sizes)} original nodes, budget "
                         f"{spec.num_original}")
    o_off = np.concatenate([[0], np.cumsum(o_sizes)])
    node_original = np.full(spec.num_nodes, spec.num_original, np.int32)
    for i, g in enumerate(graphs):
        ns = node_off[i]
        node_original[ns:ns + n_sizes[i]] = (
            np.asarray(g.extras["node_to_original_node"]) + o_off[i])
    om = np.zeros(spec.num_original, bool)
    om[:sum(o_sizes)] = True
    return {"node_original": node_original, "original_mask": om}


def _batch_ksets(graphs, node_off, spec: BatchSpec) -> dict:
    """The k-set levels of the k-GNN family, per level k with a budget:
    the sets' iso types, owning graph, mask and owning copy; the
    set-graph edges, receiver-sorted within each graph; the member-node
    assignment; and, with both levels, the 2-set -> 3-set incidences.
    Padding as the JAX batcher: padding set-graph senders point at the
    last set (in range, gathered), padding receivers, assigned sets,
    owning copies and owning graphs are out of range (the models mask
    them), padding member nodes point at the last node."""
    out: dict = {}
    ex0 = graphs[0].extras or {}
    seg_sizes = [int(_ex(g, "num_subgraphs", 0)) for g in graphs]
    seg_off = np.concatenate([[0], np.cumsum(seg_sizes)])
    set_offs = {}
    for k in (2, 3):
        budget = getattr(spec, f"num_kset{k}")
        if not budget or f"num_kset{k}" not in ex0:
            continue
        sizes = [int(g.extras[f"num_kset{k}"]) for g in graphs]
        if sum(sizes) > budget:
            raise ValueError(f"{sum(sizes)} {k}-sets, budget {budget}")
        off = np.concatenate([[0], np.cumsum(sizes)])
        set_offs[k] = off
        iso = np.zeros(budget, np.int32)
        kgraph = np.full(budget, spec.num_graphs, np.int32)
        mask = np.zeros(budget, bool)
        to_sub = np.full(budget, spec.num_segments or budget, np.int32)
        for i, g in enumerate(graphs):
            iso[off[i]:off[i + 1]] = np.asarray(g.extras[f"kset{k}_iso"])
            kgraph[off[i]:off[i + 1]] = i
            shift = seg_off[i] if spec.num_segments else 0
            to_sub[off[i]:off[i + 1]] = (
                np.asarray(g.extras[f"kset{k}_to_subgraph"]) + shift)
        mask[:off[-1]] = True

        e_budget = getattr(spec, f"num_kset{k}_edges")
        e_sizes = [int(g.extras[f"kset{k}_edge_index"].shape[1])
                   for g in graphs]
        if sum(e_sizes) > e_budget:
            raise ValueError(f"{sum(e_sizes)} {k}-set edges, budget "
                             f"{e_budget}")
        ksend = np.full(e_budget, budget - 1, np.int32)
        krecv = np.full(e_budget, budget, np.int32)
        kemask = np.zeros(e_budget, bool)
        eo = 0
        for i, g in enumerate(graphs):
            ei = np.asarray(g.extras[f"kset{k}_edge_index"])
            ei = ei[:, np.lexsort((ei[0], ei[1]))]
            ksend[eo:eo + e_sizes[i]] = ei[0] + off[i]
            krecv[eo:eo + e_sizes[i]] = ei[1] + off[i]
            eo += e_sizes[i]
        kemask[:eo] = True

        a_budget = getattr(spec, f"num_kset{k}_assign")
        a_sizes = [int(g.extras[f"kset{k}_assign"].shape[1]) for g in graphs]
        if sum(a_sizes) > a_budget:
            raise ValueError(f"{sum(a_sizes)} {k}-set members, budget "
                             f"{a_budget}")
        anode = np.full(a_budget, spec.num_nodes - 1, np.int32)
        aset = np.full(a_budget, budget, np.int32)
        amask = np.zeros(a_budget, bool)
        ao = 0
        for i, g in enumerate(graphs):
            asg = np.asarray(g.extras[f"kset{k}_assign"])
            anode[ao:ao + a_sizes[i]] = asg[0] + node_off[i]
            aset[ao:ao + a_sizes[i]] = asg[1] + off[i]
            ao += a_sizes[i]
        amask[:ao] = True
        out.update({
            f"kset{k}_iso": iso,
            f"kset{k}_graph": kgraph,
            f"kset{k}_mask": mask,
            f"kset{k}_to_subgraph": to_sub,
            f"kset{k}_senders": ksend,
            f"kset{k}_receivers": krecv,
            f"kset{k}_edge_mask": kemask,
            f"kset{k}_assign_node": anode,
            f"kset{k}_assign_set": aset,
            f"kset{k}_assign_mask": amask,
        })

    if spec.num_assign_2to3 and "assign_2to3" in ex0:
        B = spec.num_assign_2to3
        row = np.zeros(B, np.int32)
        col = np.zeros(B, np.int32)
        m = np.zeros(B, bool)
        o = 0
        for i, g in enumerate(graphs):
            a = np.asarray(g.extras["assign_2to3"])
            n = a.shape[1]
            if o + n > B:
                raise ValueError(f"2-to-3 incidences exceed the budget {B}")
            row[o:o + n] = a[0] + set_offs[2][i]
            col[o:o + n] = a[1] + set_offs[3][i]
            o += n
        m[:o] = True
        out.update({"assign_2to3_row": row, "assign_2to3_col": col,
                    "assign_2to3_mask": m})
    return out


def _ex(g: GraphData, key: str, default=None):
    return (g.extras or {}).get(key, default)


def _batch_named_extras(graphs, n_sizes, e_sizes, perms, node_off, edge_off,
                        spec):
    """Generic extras: node-aligned ones padded like x, edge-aligned ones
    permuted like edge_attr, copy-aligned ones (one row per subgraph
    copy, e.g. the node-level targets of the copy models) padded to the
    segment budget, `orig_adj` stacked into (G, K, K) and `attn_bias`
    into (G, M, M) with M = `max_nodes_per_graph`; per-graph scalars
    (`num_*`) and the keys that have their own fields (copy levels, link
    pairs) are skipped, as the JAX batcher does, and so are the k-set
    extras (`_batch_ksets` lays them out)."""
    out: dict = {}
    ex0 = graphs[0].extras or {}
    seg_sizes = [int(_ex(g, "num_subgraphs", 0)) for g in graphs]
    seg_off = np.concatenate([[0], np.cumsum(seg_sizes)])
    for key, v0 in ex0.items():
        if key in ("orig_adj", "attn_bias"):
            K = (spec.max_segments_per_graph if key == "orig_adj"
                 else spec.max_nodes_per_graph)
            dense = np.zeros((spec.num_graphs, K, K), np.asarray(v0).dtype)
            for i, g in enumerate(graphs):
                a = np.asarray(g.extras[key])
                dense[i, :a.shape[0], :a.shape[1]] = a
            out[key] = dense
            continue
        if (key in _STRUCTURAL_KEYS or key.startswith("num_")
                or key.startswith("kset")):
            continue
        v0 = np.asarray(v0)
        if v0.ndim >= 1 and v0.shape[0] == graphs[0].num_nodes:
            out[key] = _pad_rows([np.asarray(g.extras[key]) for g in graphs],
                                 n_sizes, spec.num_nodes, node_off)
        elif v0.ndim >= 1 and v0.shape[0] == graphs[0].num_edges:
            out[key] = _pad_rows(
                [np.asarray(g.extras[key])[perms[i]]
                 for i, g in enumerate(graphs)],
                e_sizes, spec.num_edges, edge_off)
        elif (v0.ndim >= 1 and seg_sizes[0]
              and v0.shape[0] == seg_sizes[0] and spec.num_segments > 0):
            out[key] = _pad_rows([np.asarray(g.extras[key]) for g in graphs],
                                 seg_sizes, spec.num_segments, seg_off)
        else:
            raise ValueError(
                f"extras[{key!r}] has no batching rule "
                f"(shape {v0.shape}, graph has {graphs[0].num_nodes} nodes/"
                f"{graphs[0].num_edges} edges)")
    return out


def pad_and_batch(
    graphs: Sequence[GraphData], spec: BatchSpec, device="cuda"
) -> GraphBatch:
    """Pack `graphs` into one `GraphBatch` under `spec`'s budgets, as
    tensors on `device`. Raises if the graphs exceed any budget — a spec
    sized over the full dataset never does."""
    return batch_from_arrays(batch_arrays(graphs, spec), spec, device)


def batch_from_arrays(arrays: dict, spec: BatchSpec, device="cuda",
                      pin: bool = False) -> GraphBatch:
    """The `GraphBatch` of host arrays from `batch_arrays` (or stacks of
    them), as tensors on `device`. `pin`: copy through pinned host memory
    without blocking the host (the copy is ordered on the current
    stream)."""
    device = resolve_device(device)

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if pin and device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return GraphBatch(
        nodes_per_graph=spec.uniform_nodes or None,
        edges_per_graph=spec.uniform_edges or None,
        nodes_per_seg=spec.copy_nodes or None,
        edges_per_seg=spec.copy_edges or None,
    ).with_tensors({k: put(v) for k, v in arrays.items()})


def batch_iterator(
    graphs: Sequence[GraphData],
    spec: BatchSpec,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
    device="cuda",
) -> Iterator:
    """Fixed-count batches: consecutive groups of `spec.num_graphs` (the
    last one short, padded to the spec's shapes), in an order shuffled by
    `rng` when `shuffle`. Yields `GraphBatch`es on `device`, or with
    `device=None` the host arrays of `batch_arrays`."""
    idx = np.arange(len(graphs))
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    bs = spec.num_graphs
    for i in range(0, len(graphs), bs):
        arrays = batch_arrays([graphs[j] for j in idx[i:i + bs]], spec)
        yield arrays if device is None else batch_from_arrays(arrays, spec,
                                                              device)


def packed_batch_iterator(
    graphs: Sequence[GraphData],
    spec: BatchSpec,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
    device="cuda",
) -> Iterator:
    """Greedy packing: fill each batch until a budget (graphs, nodes less
    the parking node, edges, flat encoding entries) would overflow. Covers
    every graph exactly once and never needs more batches than
    `batch_iterator`. Yields like `batch_iterator` (`device=None`: the
    host arrays)."""
    idx = np.arange(len(graphs))
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    caps = {"graphs": spec.num_graphs, "nodes": spec.num_nodes - 1,
            "edges": spec.num_edges, "enc": spec.num_enc_nnz or np.inf}

    def emit(cur):
        arrays = batch_arrays(cur, spec)
        return arrays if device is None else batch_from_arrays(arrays, spec,
                                                               device)

    cur: list = []
    used = dict.fromkeys(caps, 0)
    for j in idx:
        g = graphs[j]
        nnz = (int(np.diff(np.asarray(g.enc_offsets)).sum())
               if g.enc_offsets is not None and spec.num_enc_nnz else 0)
        need = dict(graphs=1, nodes=g.num_nodes, edges=g.num_edges, enc=nnz)
        if cur and any(used[k] + need[k] > caps[k] for k in caps):
            yield emit(cur)
            cur, used = [], dict.fromkeys(caps, 0)
        cur.append(g)
        for k in need:
            used[k] += need[k]
    if cur:
        yield emit(cur)


# fixed coefficients for the row-hash dedup (any odd constants work; the
# hash only routes rows into np.unique — exactness comes from the verify)
_HASH_SEED = np.random.default_rng(0x5CE5).integers(
    1, 2**62, size=4096, dtype=np.int64
) | 1


def _unique_rows(both: np.ndarray):
    """Deduplicate rows of a 2-D integer array -> (unique_rows, inverse).

    Hash rows with a vectorized int64 dot (wrapping multiply-add), unique
    the 1-D hashes, and VERIFY exactly by materializing uniq[inverse] —
    on a 63-bit collision the exact dict walk runs instead, so the result
    is always correct."""
    E, C = both.shape
    h = both.astype(np.int64, copy=False) @ _HASH_SEED[:C]
    _, first_idx, inv = np.unique(h, return_index=True, return_inverse=True)
    uniq = both[first_idx]
    if np.array_equal(uniq[inv], both):
        return uniq, inv
    # hash collision: exact walk
    row_sz = C * both.dtype.itemsize
    buf = both.tobytes()
    seen: dict = {}
    inv = np.empty(E, np.int64)
    first_rows = []
    for e in range(E):
        k = buf[e * row_sz:(e + 1) * row_sz]
        i = seen.get(k)
        if i is None:
            i = len(first_rows)
            seen[k] = i
            first_rows.append(e)
        inv[e] = i
    return both[np.asarray(first_rows, np.int64)], inv


def _batch_flat_encoding(graphs, perms, edge_off, spec: BatchSpec) -> dict:
    """Flat layout: each graph's COO entries stable-sorted by their new
    (receiver-sorted, batch-offset) edge id, concatenated in graph order;
    padding entries carry count 0 on edge E - 1 (in range)."""
    E, K = spec.num_edges, spec.num_enc_nnz
    idx_parts, cnt_parts, edge_parts = [], [], []
    for i, g in enumerate(graphs):
        nnz = np.diff(np.asarray(g.enc_offsets))
        if nnz.size == 0:
            continue
        inv = np.empty_like(perms[i])
        inv[perms[i]] = np.arange(len(perms[i]))
        new_rows = inv[np.repeat(np.arange(len(nnz)), nnz)] + edge_off[i]
        order = np.argsort(new_rows, kind="stable")
        idx_parts.append(np.asarray(g.enc_idx)[order])
        cnt_parts.append(np.asarray(g.enc_cnt)[order])
        edge_parts.append(new_rows[order])
    tot = sum(p.shape[0] for p in idx_parts)
    if tot > K:
        raise ValueError(f"{tot} encoding entries exceed the flat budget {K}")
    fi = np.zeros(K, _ENC_DTYPE)
    fc = np.zeros(K, _ENC_DTYPE)
    fe = np.full(K, E - 1, np.int32)
    if tot:
        fi[:tot] = np.concatenate(idx_parts).astype(_ENC_DTYPE)
        fc[:tot] = np.concatenate(cnt_parts).astype(_ENC_DTYPE)
        fe[:tot] = np.concatenate(edge_parts).astype(np.int32)
    return {"enc_flat_idx": fi, "enc_flat_cnt": fc, "enc_flat_edge": fe}


def _batch_encoding(graphs, perms, edge_off, spec: BatchSpec) -> dict:
    """Width layout: (E, P) rows; dedup layout: the batch's unique rows
    plus the edge -> row map, row weights, sorted-CSR view, bucket
    compaction and host count matrix; flat layout: COO entries."""
    if spec.enc_width == 0:
        return _batch_flat_encoding(graphs, perms, edge_off, spec)
    E, W = spec.num_edges, spec.enc_width
    enc_idx = np.zeros((E, W), _ENC_DTYPE)
    enc_cnt = np.zeros((E, W), _ENC_DTYPE)
    for i, g in enumerate(graphs):
        off = np.asarray(g.enc_offsets)
        nnz = np.diff(off)
        if nnz.size == 0:
            continue
        if int(nnz.max()) > W:
            raise ValueError(f"enc row nnz {int(nnz.max())} exceeds width {W}")
        inv = np.empty_like(perms[i])
        inv[perms[i]] = np.arange(len(perms[i]))
        rows_orig = np.repeat(np.arange(len(nnz)), nnz)
        new_rows = inv[rows_orig] + edge_off[i]
        gidx = np.asarray(g.enc_idx)
        cols = np.arange(len(gidx)) - np.repeat(off[:-1], nnz)
        enc_idx[new_rows, cols] = gidx.astype(_ENC_DTYPE)
        enc_cnt[new_rows, cols] = np.asarray(g.enc_cnt).astype(_ENC_DTYPE)
    if spec.num_enc_rows == 0:
        return {"enc_idx": enc_idx, "enc_cnt": enc_cnt}

    # dedup layout: unique rows + edge -> row map. Padding edges' all-zero
    # rows dedup into one zero row whose weighted sum is exactly 0.
    R = spec.num_enc_rows
    both = np.ascontiguousarray(np.concatenate([enc_idx, enc_cnt], axis=1))
    uniq, inv = _unique_rows(both)
    if len(uniq) > R:
        raise ValueError(f"batch has {len(uniq)} unique rows, budget {R}")
    u_idx = np.zeros((R, W), _ENC_DTYPE)
    u_cnt = np.zeros((R, W), _ENC_DTYPE)
    u_idx[: len(uniq)] = uniq[:, :W]
    u_cnt[: len(uniq)] = uniq[:, W:]
    # real-edge multiplicity per unique row: the weights under which
    # row-level batch-norm statistics equal edge-level ones
    emask = np.zeros(E, bool)
    for i in range(len(graphs)):
        emask[edge_off[i]:edge_off[i] + len(perms[i])] = True
    weight = np.bincount(inv[emask], minlength=R).astype(np.float32)
    # sorted-CSR view for the expansion backward
    perm = np.argsort(inv, kind="stable").astype(np.int32)
    out = {
        "enc_idx": u_idx,
        "enc_cnt": u_cnt,
        "enc_edge_row": inv.astype(np.int32),
        "enc_row_weight": weight,
        "enc_edge_perm": perm,
        "enc_row_sorted": inv[perm].astype(np.int32),
    }
    if spec.num_enc_buckets > 0:
        # bucket compaction: remap ids to the batch's active set; entries
        # with cnt == 0 keep slot 0 (their contribution is 0 regardless)
        B = spec.num_enc_buckets
        act = np.unique(u_idx[u_cnt > 0])
        if len(act) > B:
            raise ValueError(
                f"batch uses {len(act)} distinct buckets, budget {B}"
            )
        bucket_ids = np.zeros(B, np.int32)
        bucket_ids[: len(act)] = act
        remap = np.zeros(int(act[-1]) + 2 if len(act) else 2, _ENC_DTYPE)
        remap[act] = np.arange(len(act), dtype=_ENC_DTYPE)
        out["enc_idx"] = np.where(u_cnt > 0, remap[u_idx], 0).astype(_ENC_DTYPE)
        out["enc_bucket_ids"] = bucket_ids
        # host count matrix C[r, z], guarded by size (a few MB per batch)
        if R * B * 4 <= 16 * 2**20:
            C = np.zeros((R, B), np.float32)
            ci = out["enc_idx"].astype(np.int64)
            np.add.at(
                C,
                (np.repeat(np.arange(R), W), ci.ravel()),
                np.where(u_cnt > 0, u_cnt, 0).astype(np.float32).ravel(),
            )
            out["enc_countmat"] = C
    return out
