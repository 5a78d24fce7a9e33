"""Static-shape batching (counterpart of `escgnn_tpu/data/batching.py`).

Graphs are packed into a fixed `BatchSpec` budget (padded arrays +
validity masks). Edges are re-ordered by receiver inside every graph and
every edge payload (attrs, ESC encoding rows) rides the same
permutation. The host arrays are bit-equal to the JAX batcher's; only
the last step differs: `pad_and_batch` hands them over as tensors on the
requested device.

This package carries the parts of the JAX batcher that the flagship
NestedGIN_eff path runs: `BatchSpec.from_graphs` / `BatchSpec.uniform`
with the `width` and `dedup` encoding layouts. The flat layout, the copy
and k-set levels and named extras wait for the slices that need them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from escgnn_tpu_torch.data.container import GraphBatch, GraphData
from escgnn_tpu_torch.device import resolve_device

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
    pads every graph to an identical (nodes, edges) block.
    """

    num_graphs: int
    num_nodes: int
    num_edges: int
    # ESC encoding: fixed-width rows (enc_width > 0), optionally
    # deduplicated into num_enc_rows unique rows + an edge->row map
    enc_width: int = 0
    y_is_node_level: bool = False
    num_enc_rows: int = 0
    # >0: compact the bucket universe per batch — enc_idx is remapped to
    # [0, num_enc_buckets) and `enc_bucket_ids` maps back to table rows
    num_enc_buckets: int = 0
    max_nodes_per_graph: int = 0
    # uniform layout: node id g*uniform_nodes + i, edge id
    # g*uniform_edges + k
    uniform_nodes: int = 0
    uniform_edges: int = 0

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


def _spec_budgets(graphs, batch_size, enc_layout):
    if not graphs:
        raise ValueError("need at least one graph to size a BatchSpec")
    if enc_layout not in ("width", "dedup"):
        raise NotImplementedError(
            f"enc_layout {enc_layout!r}: only 'width' and 'dedup' are ported"
        )
    bs = int(batch_size)
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
    s = {"nodes": g.num_nodes, "edges": g.num_edges, "enc_w": 0, "enc_rows": 0}
    if g.enc_offsets is not None:
        nnz = np.diff(np.asarray(g.enc_offsets))
        s["enc_w"] = int(nnz.max()) if nnz.size else 0
        s["enc_rows"] = len(np.unique(_graph_row_hashes(g)))
    return s


def _per_graph_maxima(graphs) -> dict:
    stats = [_graph_stats(g) for g in graphs]
    return {k: max(s[k] for s in stats) for k in stats[0]}


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
    kw = dict(enc_width=0, num_enc_rows=0, max_nodes_per_graph=m["nodes"])
    if m["enc_w"]:
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
    """The padded host arrays of one batch, by `GraphBatch` field name
    (bit-equal to the JAX batcher's on the same graphs and spec)."""
    G = len(graphs)
    if not 0 < G <= spec.num_graphs:
        raise ValueError(f"{G} graphs for a {spec.num_graphs}-graph spec")
    if any(g.extras for g in graphs):
        raise NotImplementedError("graph extras are not batched yet")
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
    if graphs[0].enc_offsets is not None and spec.enc_width > 0:
        fields.update(_batch_encoding(graphs, perms, edge_off, spec))
    return fields


def pad_and_batch(
    graphs: Sequence[GraphData], spec: BatchSpec, device="cuda"
) -> GraphBatch:
    """Pack `graphs` into one `GraphBatch` under `spec`'s budgets, as
    tensors on `device`. Raises if the graphs exceed any budget — a spec
    sized over the full dataset never does."""
    device = resolve_device(device)
    fields = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in batch_arrays(graphs, spec).items()
    }
    return GraphBatch(
        nodes_per_graph=spec.uniform_nodes or None,
        edges_per_graph=spec.uniform_edges or None,
        **fields,
    )


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


def _batch_encoding(graphs, perms, edge_off, spec: BatchSpec) -> dict:
    """Width layout: (E, P) rows; dedup layout: the batch's unique rows
    plus the edge -> row map, row weights, sorted-CSR view, bucket
    compaction and host count matrix."""
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
