"""Uniform per-copy block layout for the copy family (counterpart of
`escgnn_tpu/data/uniform_copies.py`).

The copy transforms (`featurize/node_subgraphs.py`,
`featurize/pair_subgraphs.py`) tile each graph into many small subgraph
copies; the batched union is block-diagonal at the copy level (copy c's
edges only touch copy c's nodes). This module re-lays each union graph
so every copy occupies an identical (n_c, e_c) block: copy c's nodes at
rows [c*n_c, (c+1)*n_c), its edges at slots [c*e_c, (c+1)*e_c). Message
passing then runs as per-copy one-hot products (`models/layers.py`
`_dense_local_aggregate`) and node -> copy pooling as a masked reshape
(`ops/segment.py` `pool_copy_blocks`). Padding rows and edges are marked
by the `node_valid` / `edge_valid` extras, which the batcher ANDs into
`node_mask` / `edge_mask`.

Use: `n_c, e_c = copy_block_sizes(graphs)` over the featurized dataset,
`uniformize_copies(g, n_c, e_c)` per graph (or `uniformize_dataset`),
then `BatchSpec.copy_uniform(...)` and the batcher as usual.

The two-size bucketed layout (`bucketize_copy_batch`,
`make_bucket_transform`) works on a host batch: a `GraphBatch` whose
tensors lie on the CPU (`batch_from_arrays(arrays, spec, "cpu")`), and it
returns one, before the batch is stacked and copied to the card. Every
output equals the JAX package's on the same batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from escgnn_tpu_torch.data.container import GraphBatch, GraphData


def _copy_level_key(g: GraphData) -> str:
    ex = g.extras or {}
    if "node_to_subgraph2" in ex:
        return "node_to_subgraph2"
    if "node_to_subgraph" not in ex:
        raise ValueError("not a copy-based featurized graph")
    return "node_to_subgraph"


def _copy_sizes(g: GraphData):
    """(nodes, edges) of each copy of `g`."""
    lvl = np.asarray(g.extras[_copy_level_key(g)])
    cn = np.bincount(lvl)
    ei = np.asarray(g.edge_index)
    ce = (np.bincount(lvl[ei[1]], minlength=len(cn)) if g.num_edges
          else np.zeros(len(cn), np.int64))
    return cn, ce


def copy_block_sizes(graphs, round_nodes: int = 1, round_edges: int = 1):
    """Dataset-wide (n_c, e_c): max nodes / edges of any single copy."""
    n_c = e_c = 1
    for g in graphs:
        lvl = np.asarray(g.extras[_copy_level_key(g)])
        n_c = max(n_c, int(np.bincount(lvl).max()))
        if g.num_edges:
            ei = np.asarray(g.edge_index)
            e_c = max(e_c, int(np.bincount(lvl[ei[1]]).max()))
    rn = max(1, int(round_nodes))
    re = max(1, int(round_edges))
    return -(-n_c // rn) * rn, -(-e_c // re) * re


def uniformize_copies(g: GraphData, n_c: int, e_c: int) -> GraphData:
    """Re-lay `g`'s copy union into uniform (n_c, e_c) blocks per copy."""
    ex = dict(g.extras or {})
    key = _copy_level_key(g)
    lvl = np.asarray(ex[key], np.int64)
    N = g.num_nodes
    if lvl.shape[0] != N or np.any(np.diff(lvl) < 0):
        raise ValueError("copy ids must be per node and non-decreasing")
    sizes = np.bincount(lvl)
    C = sizes.shape[0]
    if sizes.max() > n_c:
        raise ValueError(f"a copy has {int(sizes.max())} nodes > {n_c}")
    starts = np.concatenate([[0], np.cumsum(sizes)])

    # old node id -> new node id (copy block + local offset)
    new_of = lvl * n_c + (np.arange(N) - starts[lvl])
    NN = C * n_c

    def scatter_nodes(a, fill=0):
        a = np.asarray(a)
        out = np.full((NN,) + a.shape[1:], fill, a.dtype)
        out[new_of] = a
        return out

    node_valid = np.zeros(NN, bool)
    node_valid[new_of] = True

    # --- edges: remap endpoints, group per copy, pad each copy to e_c ---
    E = g.num_edges
    ei = np.asarray(g.edge_index)
    if E:
        ecopy = lvl[ei[1]]
        if np.any(ecopy != lvl[ei[0]]):
            raise ValueError("an edge crosses copies")
        s_new, d_new = new_of[ei[0]], new_of[ei[1]]
        perm = np.lexsort((s_new, d_new))  # receiver groups encode the copy
        s_new, d_new, ecopy = s_new[perm], d_new[perm], ecopy[perm]
        e_sizes = np.bincount(ecopy, minlength=C)
    else:
        perm = np.zeros(0, np.int64)
        s_new = d_new = np.zeros(0, np.int64)
        e_sizes = np.zeros(C, np.int64)
    if e_sizes.max(initial=0) > e_c:
        raise ValueError(f"a copy has {int(e_sizes.max())} edges > {e_c}")
    e_starts = np.concatenate([[0], np.cumsum(e_sizes)])
    # slot of edge j (sorted order): its copy's block + position within
    pos = np.arange(len(s_new)) - e_starts[ecopy] if E else np.zeros(0, int)
    slot = (ecopy * e_c + pos).astype(np.int64) if E else np.zeros(0, int)
    EE = C * e_c
    # padding edges park on their copy's trailing node slot: receivers
    # stay non-decreasing within each copy block
    park = np.repeat(np.arange(C, dtype=np.int64), e_c) * n_c + n_c - 1
    src = park.copy()
    dst = park.copy()
    src[slot] = s_new
    dst[slot] = d_new
    edge_valid = np.zeros(EE, bool)
    edge_valid[slot] = True

    def scatter_edges(a):
        a = np.asarray(a)[perm]
        out = np.zeros((EE,) + a.shape[1:], a.dtype)
        out[slot] = a
        return out

    # --- rebuild extras ---
    out_ex: dict = {}
    for k, v in ex.items():
        va = np.asarray(v) if not np.isscalar(v) else v
        if k == key:
            # padding rows carry their copy id
            out_ex[k] = np.repeat(np.arange(C, dtype=lvl.dtype), n_c)
        elif k == "center_idx":
            out_ex[k] = new_of[np.asarray(v, np.int64)]
        elif not np.isscalar(v) and va.ndim >= 1 and va.shape[0] == N:
            out_ex[k] = scatter_nodes(va)
        elif (not np.isscalar(v) and va.ndim >= 1 and E
              and va.shape[0] == E):
            out_ex[k] = scatter_edges(va)
        else:
            out_ex[k] = v
    out_ex["node_valid"] = node_valid
    out_ex["edge_valid"] = edge_valid
    # `num_` keys are skipped by the batcher's extras; read by BatchSpec
    out_ex["num_copy_nodes"] = int(n_c)
    out_ex["num_copy_edges"] = int(e_c)

    return GraphData(
        num_nodes=NN,
        edge_index=np.stack([src, dst]).astype(np.int32),
        x=scatter_nodes(g.x) if g.x is not None else None,
        edge_attr=scatter_edges(g.edge_attr) if g.edge_attr is not None
        else None,
        y=g.y,
        pos=scatter_nodes(g.pos) if g.pos is not None else None,
        extras=out_ex,
    )


def uniformize_dataset(graphs, round_nodes: int = 1, round_edges: int = 1):
    """Uniformize a featurized copy-based dataset in one call."""
    n_c, e_c = copy_block_sizes(graphs, round_nodes, round_edges)
    return [uniformize_copies(g, n_c, e_c) for g in graphs]


# ---------------------------------------------------------------------------
# two-size bucketed block layout
# ---------------------------------------------------------------------------


def choose_bucket_sizes(graphs) -> tuple:
    """(n_s, e_s): the small-bucket block shape minimizing total padded
    edge slots when copies with <= e_s edges pad to (n_s, e_s) and the
    rest to the dataset-wide (n_c, e_c)."""
    n_sizes, e_sizes = [], []
    for g in graphs:
        cn, ce = _copy_sizes(g)
        n_sizes += cn.tolist()
        e_sizes += ce.tolist()
    n_sizes = np.asarray(n_sizes)
    e_sizes = np.asarray(e_sizes)
    e_max = int(e_sizes.max())
    best = (np.inf, e_max, int(n_sizes.max()))
    for t in np.unique(e_sizes):
        small = e_sizes <= t
        if not small.any() or small.all():
            continue
        cost = small.sum() * t + (~small).sum() * e_max
        if cost < best[0]:
            best = (cost, int(t), int(n_sizes[small].max()))
    return best[2], best[1]


def _np(t):
    return None if t is None else t.numpy()


def bucketize_copy_batch(batch: GraphBatch, n_s: int, e_s: int,
                         pad_small: int = 0, pad_large: int = 0,
                         cs_budget: "int | None" = None,
                         cl_budget: "int | None" = None) -> GraphBatch:
    """Re-lay a one-size copy-uniform host batch (tensors on the CPU) into
    the two-size bucketed layout: copies whose real size fits (n_s, e_s)
    move to a leading small region of (n_s, e_s) blocks, the rest to a
    trailing large region of the original (n_c, e_c) blocks. Segment ids
    are renumbered to the new copy order; every node-, edge- and
    copy-aligned array moves by gather. `pad_small` / `pad_large` grow
    the region block counts beyond this batch's needs.

    `cs_budget` / `cl_budget` pin the region block counts instead (the
    pool path: every batch of every pool must have one shape). A batch
    with more small copies than `cs_budget` stays correct by demotion:
    the largest overflow small copies go to the large region (n_s <= n_c,
    e_s <= e_c); overflowing `cl_budget` raises. As in the JAX package,
    a `cs_budget` without a `cl_budget` raises TypeError.

    Returns a new host batch with `seg_regions` set and `nodes_per_seg` /
    `edges_per_seg` cleared. Masks move with their rows and padding edges
    park on their block's trailing slot, as `uniformize_copies` lays
    them, so the result is the same computation."""
    n_c = batch.nodes_per_seg
    e_c = batch.edges_per_seg
    if n_c is None or e_c is None:
        raise ValueError("need a copy-uniform batch")
    if n_s > n_c or e_s > e_c:
        raise ValueError(f"small block {(n_s, e_s)} exceeds {(n_c, e_c)}")
    nm = _np(batch.node_mask)
    em = _np(batch.edge_mask)
    N, E = nm.shape[0], em.shape[0]
    S = N // n_c
    if S * n_c != N or S * e_c != E:
        raise ValueError(f"not a copy-uniform batch: {(N, E, n_c, e_c)}")
    rn = nm.reshape(S, n_c).sum(1)
    re_ = em.reshape(S, e_c).sum(1)
    seg_mask = _np(batch.segment2_mask if batch.segment2_mask is not None
                   else batch.segment_mask)
    if seg_mask.shape[0] != S:
        raise ValueError(f"copy mask {seg_mask.shape} for {S} blocks")
    real = np.flatnonzero(seg_mask)
    small = real[(rn[real] <= n_s) & (re_[real] <= e_s)]
    large = real[(rn[real] > n_s) | (re_[real] > e_s)]
    if cs_budget is not None:
        if len(small) > cs_budget:
            # demote the largest overflow smalls to the large region
            order = np.argsort(re_[small], kind="stable")
            keep, demote = small[order[:cs_budget]], small[order[cs_budget:]]
            small = np.sort(keep)
            large = np.sort(np.concatenate([large, demote]))
        if len(large) > (cl_budget or 0):
            raise ValueError(
                f"cl_budget {cl_budget} < {len(large)} large copies "
                f"(after demotion); size the budgets over all pools")
        cs, cl = int(cs_budget), int(cl_budget)
    else:
        cs = len(small) + pad_small
        cl = len(large) + pad_large
    # new slot of each old real block
    slot = np.full(S, -1, np.int64)
    slot[small] = np.arange(len(small))
    slot[large] = cs + np.arange(len(large))
    NN = cs * n_s + cl * n_c
    EE = cs * e_s + cl * e_c

    def node_offset(s):  # new node row offset of new slot s
        s = np.asarray(s)
        return np.where(s < cs, s * n_s, cs * n_s + (s - cs) * n_c)

    def edge_offset(s):
        s = np.asarray(s)
        return np.where(s < cs, s * e_s, cs * e_s + (s - cs) * e_c)

    # old node row -> new node row (valid rows only)
    old_rows = np.flatnonzero(nm)
    ob = old_rows // n_c
    ol = old_rows % n_c
    if np.any(slot[ob] < 0):
        raise ValueError("a valid node lies in a padding copy")
    new_rows = node_offset(slot[ob]) + ol
    node_map = np.full(N, -1, np.int64)
    node_map[old_rows] = new_rows

    old_e = np.flatnonzero(em)
    eb = old_e // e_c
    el = old_e % e_c
    if np.any(el >= np.where(slot[eb] < cs, e_s, e_c)):
        raise ValueError("valid edges must be block prefixes")
    new_e = edge_offset(slot[eb]) + el

    NG = batch.graph_mask.shape[0]

    def move_nodes(a, fill):
        a = np.asarray(a)
        out = np.full((NN,) + a.shape[1:], fill, a.dtype)
        out[new_rows] = a[old_rows]
        return out

    def move_edges(a, fill):
        a = np.asarray(a)
        out = np.full((EE,) + a.shape[1:], fill, a.dtype)
        out[new_e] = a[old_e]
        return out

    def move_segments(a, fill):
        a = np.asarray(a)
        out = np.full((cs + cl,) + a.shape[1:], fill, a.dtype)
        out[slot[real]] = a[real]
        return out

    # new parking slots: every edge parks on its block's trailing node
    park_small = np.repeat(np.arange(cs), e_s) * n_s + n_s - 1
    park_large = cs * n_s + np.repeat(np.arange(cl), e_c) * n_c + n_c - 1
    senders_old = _np(batch.senders)
    park = np.concatenate([park_small, park_large]).astype(senders_old.dtype)
    senders = park.copy()
    receivers = park.copy()
    senders[new_e] = node_map[senders_old[old_e]]
    receivers[new_e] = node_map[_np(batch.receivers)[old_e]]

    node_local = _np(batch.node_local)
    fields = dict(
        senders=senders,
        receivers=receivers,
        node_mask=move_nodes(nm, False),
        edge_mask=move_edges(em, False),
        graph_mask=_np(batch.graph_mask),
        node_graph=move_nodes(_np(batch.node_graph), NG),
        node_local=move_nodes(node_local, int(node_local.max())),
    )
    for name in ("x", "pos", "edge_attr"):
        v = getattr(batch, name)
        if v is not None:
            mv = move_edges if name == "edge_attr" else move_nodes
            fields[name] = mv(_np(v), 0)
    if batch.y is not None:
        ya = _np(batch.y)
        if ya.shape[0] == N:
            fields["y"] = move_nodes(ya, 0)
        elif ya.shape[0] == S:
            fields["y"] = move_segments(ya, 0)
        else:
            fields["y"] = ya

    def remap_seg_ids(a):
        # old copy ids -> new slots; padding rows -> out of range
        ns = move_nodes(a.astype(np.int64), -1)
        valid = (ns >= 0) & (ns < S)
        valid &= np.where(valid, slot[np.clip(ns, 0, S - 1)], -1) >= 0
        out = np.full(NN, cs + cl, a.dtype)
        out[valid] = slot[ns[valid]]
        return out

    if batch.node_segment is not None:
        fields["node_segment"] = remap_seg_ids(_np(batch.node_segment))
        fields["segment_graph"] = move_segments(_np(batch.segment_graph), NG)
        fields["segment_mask"] = move_segments(_np(batch.segment_mask),
                                               False)
    if batch.node_segment2 is not None:
        parent = _np(batch.segment2_parent)
        fields["node_segment2"] = remap_seg_ids(_np(batch.node_segment2))
        fields["segment2_parent"] = move_segments(parent, int(parent.max()))
        fields["segment2_mask"] = move_segments(_np(batch.segment2_mask),
                                                False)
    if batch.center_idx is not None:
        ci = _np(batch.center_idx)
        out = np.full((cs + cl,) + ci.shape[1:], NN - 1, ci.dtype)
        vals = node_map[ci[real]]
        vals[vals < 0] = NN - 1
        out[slot[real]] = vals
        fields["center_idx"] = out
    if batch.node_original is not None:
        orig = _np(batch.node_original)
        fields["node_original"] = move_nodes(orig, int(orig.max()))
    extras = None
    if batch.extras:
        extras = {}
        for k, v in batch.extras.items():
            va = _np(v)
            if va.ndim >= 1 and va.shape[0] == N:
                extras[k] = move_nodes(va, 0)
            elif va.ndim >= 1 and va.shape[0] == E:
                extras[k] = move_edges(va, 0)
            elif va.ndim >= 1 and va.shape[0] == S:
                extras[k] = move_segments(va, 0)
            else:
                extras[k] = va
        extras = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in extras.items()}
    return dataclasses.replace(
        batch,
        **{k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in fields.items()},
        extras=extras,
        nodes_per_seg=None,
        edges_per_seg=None,
        seg_regions=((cs, n_s, e_s), (cl, n_c, e_c)),
    )


def make_bucket_transform(pre_uniform_graphs, batch_size: int):
    """The bucketed-layout batch transform of pooled training
    (`--copy_layout bucketed`): (n_s, e_s) chosen over the featurized
    (pre-uniformize) dataset and the region budgets pinned at the
    worst-case batch composition, the top-`batch_size` per-graph small
    and large copy counts, so every shuffled batch of every pool has one
    shape (overflow smalls would demote; with worst-case budgets they
    never do).

    Returns (transform, regions); transform: host copy-uniform
    `GraphBatch` -> host bucketed `GraphBatch`."""
    n_s, e_s = choose_bucket_sizes(pre_uniform_graphs)
    smalls, larges = [], []
    for g in pre_uniform_graphs:
        cn, ce = _copy_sizes(g)
        sm = (cn <= n_s) & (ce <= e_s)
        smalls.append(int(sm.sum()))
        larges.append(int((~sm).sum()))
    bs = int(batch_size)
    cs_b = _round_up(sum(sorted(smalls, reverse=True)[:bs]) + 1, 8)
    cl_b = _round_up(sum(sorted(larges, reverse=True)[:bs]) + 1, 8)

    def transform(batch: GraphBatch) -> GraphBatch:
        return bucketize_copy_batch(batch, n_s, e_s, cs_budget=cs_b,
                                    cl_budget=cl_b)

    return transform, ((cs_b, n_s, e_s), (cl_b,))


def _round_up(v: int, m: int) -> int:
    return int(-(-int(v) // m) * m)
