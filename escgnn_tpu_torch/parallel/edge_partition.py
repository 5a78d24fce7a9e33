"""Edge-partitioned training (counterpart of
`escgnn_tpu/parallel/edge_partition.py`).

JAX annotates shardings and lets GSPMD place the collectives. Here the
partition is explicit: each rank holds its slice of the batch's edges and
runs `NestedGINEff` under `edge_shard_axis` (and `data_axis` on the 2-D
mesh), whose psums (`parallel/mesh.py`) make every rank's forward the
single-device one and whose loss shares make the summed gradients the
single-device gradients (`parallel/data_parallel.py`).

Which rank holds what (`_shardings`):
  * edge-aligned fields (`EDGE_FIELDS`) are split in contiguous slices
    over the edge axes: the model axis under ep, data x model under
    dp_ep (slice i * Dm + j on rank (i, j), JAX's P((data, model)));
  * on the dedup layout the unique rows (`enc_idx`, `enc_cnt`, the
    compaction and the count matrix) are replicated, and each rank
    rebuilds from its slice of `enc_edge_row` its rows' multiplicities
    (`enc_row_weight`, so the z MLP's BatchNorm summed over the edge axes
    is the one over every edge) and the sorted-CSR view
    (`enc_edge_perm` / `enc_row_sorted`), the input of K1, the expansion
    backward's kernel, on the rank's own edges. JAX drops that view and
    falls back to XLA's scatter transpose;
  * on the flat layout the K COO entries stay whole on every rank (JAX
    replicates them too), each rank's copy rebased to its edge slice:
    entries of other ranks' edges get count 0 and edge 0;
  * under ep the node and graph fields are replicated; under dp_ep they
    are split over the data axis (graphs are row-contiguous in the
    uniform layout, so data shard i holds whole graphs with their edges)
    and the indices are rebased to the shard.
The edge count must split evenly over the edge axes.
"""

from __future__ import annotations

import torch

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.parallel.data_parallel import (
    check_backend,
    make_sharded_step,
    row_share,
)
from escgnn_tpu_torch.parallel.mesh import axis_size, check_axes
from escgnn_tpu_torch.train.loop import make_pool_train_step

EDGE_FIELDS = ("senders", "receivers", "edge_mask", "edge_attr",
               "enc_idx", "enc_cnt", "enc_edge_row")
NODE_FIELDS = ("x", "pos", "node_mask", "node_graph", "node_local", "y")
GRAPH_FIELDS = ("graph_mask",)
# rebuilt by each rank from its edge slice (dedup layout)
LOCAL_FIELDS = ("enc_row_weight", "enc_edge_perm", "enc_row_sorted")
# the flat layout's COO entries, whole on every rank, rebased to its slice
FLAT_FIELDS = ("enc_flat_idx", "enc_flat_cnt", "enc_flat_edge")
# the fields a sharded NestedGINEff batch may carry besides those above
_REPLICATED = ("enc_bucket_ids", "enc_countmat")


def _coordinate(mesh, axis: str) -> int:
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def _spec_for(name: str, dedup: bool, split_rows: bool) -> str:
    if (name in LOCAL_FIELDS and dedup) or name in FLAT_FIELDS:
        return "local"
    if name in EDGE_FIELDS and not (dedup and name in ("enc_idx", "enc_cnt")):
        return "edges"
    if split_rows and (name in NODE_FIELDS or name in GRAPH_FIELDS):
        return "rows"
    return "replicated"


def _shardings(batch: GraphBatch, split_rows: bool) -> dict:
    dedup = batch.enc_edge_row is not None
    return {k: _spec_for(k, dedup, split_rows) for k in batch.tensors()}


def batch_shardings(batch: GraphBatch, mesh, axis: str = "model") -> dict:
    """The 1-D edge partition's placement of each tensor of `batch`, by
    its flat `tensors()` name: "edges" (contiguous slices of its leading
    edge axis over `axis`, JAX's P(axis)), "local" (whole on every rank
    and rebuilt from its edge slice: the dedup multiplicities and sorted
    view, which JAX replicates or drops, and the flat COO entries, which
    JAX replicates) or "replicated" (JAX's P())."""
    check_axes(mesh, (axis,))
    return _shardings(batch, split_rows=False)


def batch_shardings_2d(batch: GraphBatch, mesh, data_axis: str = "data",
                       model_axis: str = "model") -> dict:
    """The 2-D dp x ep placement: as `batch_shardings`, the edge slices
    over data x model (JAX's P((data, model))) and the node- and
    graph-aligned tensors in "rows" slices over `data_axis` (JAX's
    P(data))."""
    check_axes(mesh, (data_axis, model_axis))
    return _shardings(batch, split_rows=True)


def _local_view(edge_row, edge_mask, num_rows: int, like_perm, like_weight):
    """(row multiplicities, perm, sorted rows) of one edge slice, along
    its last axis (a stacked pool's slices at once)."""
    rows = edge_row.long()
    weight = torch.zeros(rows.shape[:-1] + (num_rows,),
                         dtype=torch.float32, device=rows.device)
    # an atomic sum may stay: 0/1 mask counts, exact in f32 in any order
    weight.scatter_add_(-1, rows, edge_mask.to(torch.float32))
    perm = torch.argsort(rows, dim=-1, stable=True)
    rows_sorted = torch.gather(rows, -1, perm)
    return (weight.to(like_weight.dtype), perm.to(like_perm.dtype),
            rows_sorted.to(like_perm.dtype))


def _shard(batch: GraphBatch, data: tuple, model: tuple,
           stacked: bool) -> GraphBatch:
    """This rank's shard: `data` = (i, Dd), `model` = (j, Dm); `stacked`
    batches carry a leading pool axis."""
    (i, Dd), (j, Dm) = data, model
    lead = 1 if stacked else 0
    t = batch.tensors()
    E = t["edge_mask"].shape[lead]
    N = t["node_mask"].shape[lead]
    G = t["graph_mask"].shape[lead]
    shards = Dd * Dm
    if E % shards:
        raise ValueError(f"{E} edges do not split evenly over {shards} "
                         f"edge shards")
    split_rows = Dd > 1
    if split_rows:
        if batch.nodes_per_graph is None or N % Dd or G % Dd:
            raise ValueError(
                f"dp_ep splits graphs over {Dd} data shards: it needs the "
                f"uniform block layout with graphs ({G}) and nodes ({N}) "
                f"divisible by {Dd}")
        if batch.extras:
            raise ValueError("dp_ep does not split a batch's extras")
    unknown = [k for k in t if k not in EDGE_FIELDS + NODE_FIELDS
               + GRAPH_FIELDS + LOCAL_FIELDS + FLAT_FIELDS + _REPLICATED
               and not k.startswith("extras.")]
    if unknown:
        raise ValueError(f"edge partition: no layout for {unknown}")
    e_len, n_len, g_len = E // shards, N // Dd, G // Dd
    e0 = (i * Dm + j) * e_len
    n0, g0 = i * n_len, i * g_len

    def cut(v, start, length):
        return v.narrow(lead, start, length)

    specs = _shardings(batch, split_rows)
    out = {}
    for k, v in t.items():
        spec = specs[k]
        if spec == "edges":
            v = cut(v, e0, e_len)
            if split_rows and k in ("senders", "receivers"):
                v = v - n0
        elif spec == "rows":
            if k == "y" and v.shape[lead] != N:
                v = cut(v, g0, g_len)
            elif k == "graph_mask":
                v = cut(v, g0, g_len)
            else:
                v = cut(v, n0, n_len)
            if k == "node_graph":
                v = v - g0
        out[k] = v
    if batch.enc_flat_edge is not None:
        edge = t["enc_flat_edge"]
        mine = (edge >= e0) & (edge < e0 + e_len)
        out["enc_flat_edge"] = torch.where(mine, edge - e0,
                                           torch.zeros_like(edge))
        out["enc_flat_cnt"] = torch.where(
            mine, t["enc_flat_cnt"], torch.zeros_like(t["enc_flat_cnt"]))
    if batch.enc_edge_row is not None:
        R = t["enc_idx"].shape[lead]
        out["enc_row_weight"], out["enc_edge_perm"], out["enc_row_sorted"] = (
            _local_view(out["enc_edge_row"], out["edge_mask"], R,
                        t["enc_edge_perm"], t["enc_row_weight"]))
    return batch.with_tensors(out)


def shard_batch_by_edges(batch: GraphBatch, mesh, axis: str = "model",
                         device=None) -> GraphBatch:
    """This rank's 1-D edge shard of a batch (on `device` when given)."""
    out = _shard(batch, (0, 1), (_coordinate(mesh, axis), axis_size(axis)),
                 stacked=False)
    return out if device is None else out.to(device)


def shard_batch_2d(batch: GraphBatch, mesh, data_axis: str = "data",
                   model_axis: str = "model", device=None) -> GraphBatch:
    """This rank's 2-D dp x ep shard of a batch."""
    out = _shard(batch,
                 (_coordinate(mesh, data_axis), axis_size(data_axis)),
                 (_coordinate(mesh, model_axis), axis_size(model_axis)),
                 stacked=False)
    return out if device is None else out.to(device)


def shard_pool_by_edges(stacked_pool: GraphBatch, mesh,
                        axis: str = "model") -> GraphBatch:
    """This rank's 1-D edge shard of every batch of a [B, ...]-stacked
    pool, where the pool lies (the edge axis is axis 1)."""
    return _shard(stacked_pool, (0, 1),
                  (_coordinate(mesh, axis), axis_size(axis)), stacked=True)


def shard_pool_2d(stacked_pool: GraphBatch, mesh, data_axis: str = "data",
                  model_axis: str = "model") -> GraphBatch:
    """This rank's 2-D dp x ep shard of every batch of a stacked pool."""
    return _shard(stacked_pool,
                  (_coordinate(mesh, data_axis), axis_size(data_axis)),
                  (_coordinate(mesh, model_axis), axis_size(model_axis)),
                  stacked=True)


def _sharded_model(model, **axes):
    if not hasattr(model, "sharded_view"):
        raise ValueError(f"{type(model).__name__} has no edge-partitioned "
                         f"forward: the edge partition runs NestedGINEff "
                         f"(use --mesh dp for other models)")
    return model.sharded_view(**axes)


def make_ep_train_step(model, opt, loss_fn, axis: str = "model"):
    """`step(shard) -> loss`: the edge-partitioned step on this rank's
    edge shard (`shard_batch_by_edges`): every rank computes the global
    loss and differentiates it / D; the summed gradients are the
    single-device ones up to the order of the sums."""
    sharded = _sharded_model(model, edge_shard_axis=axis)
    D = axis_size(axis)
    return make_sharded_step(sharded, opt,
                             lambda out, b: loss_fn(out, b) / D,
                             grad_axis=axis)


def make_dp_ep_train_step(model, opt, loss_fn, data_axis: str = "data",
                          model_axis: str = "model"):
    """`step(shard) -> loss`: the 2-D step on this rank's
    `shard_batch_2d` shard: its data shard's part of the global masked
    mean (`row_share`) / Dm; the gradients summed over both axes are the
    single-device step's on the whole batch."""
    sharded = _sharded_model(model, edge_shard_axis=model_axis,
                             data_axis=data_axis)
    Dm = axis_size(model_axis)
    return make_sharded_step(
        sharded, opt,
        lambda out, b: row_share(loss_fn(out, b), out, b, data_axis) / Dm,
        grad_axis=(data_axis, model_axis))


def make_ep_pool_train_step(model, opt, loss_fn, pool_like: GraphBatch,
                            axis: str = "model", decode=None):
    """`epoch(shard_pool, order) -> losses`: the whole-epoch ep step over
    this rank's `shard_pool_by_edges` pool, every rank in the same order
    (the single-device schedule); a CUDA graph on NCCL
    (`parallel.data_parallel.check_backend`). `decode`: a compressed
    pool's decoder."""
    check_backend(pool_like.graph_mask.device)
    step = make_ep_train_step(model, opt, loss_fn, axis)
    return make_pool_train_step(model, opt, loss_fn, pool_like, decode=decode,
                                step_fn=step)


def make_dp_ep_pool_train_step(model, opt, loss_fn, pool_like: GraphBatch,
                               data_axis: str = "data",
                               model_axis: str = "model", decode=None):
    """`epoch(shard_pool, order) -> losses`: the whole-epoch 2-D step over
    this rank's `shard_pool_2d` pool (the single-device schedule)."""
    check_backend(pool_like.graph_mask.device)
    step = make_dp_ep_train_step(model, opt, loss_fn, data_axis, model_axis)
    return make_pool_train_step(model, opt, loss_fn, pool_like, decode=decode,
                                step_fn=step)
