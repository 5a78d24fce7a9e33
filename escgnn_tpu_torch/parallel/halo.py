"""Node+edge-partitioned message passing with a halo exchange
(counterpart of `escgnn_tpu/parallel/halo.py`).

Partition (host side, `plan_halo_sharding`, a numpy copy of the JAX
planner that gives bit-equal plans): nodes in contiguous ranges of N / D
per rank; edges by the range of their receiver, which the batcher's
receiver-sorted layout makes one contiguous slice per rank, padded to a
common `E_shard`. Every edge's output is local, so the aggregation is a
local segment sum; only senders can be remote. Each rank publishes the
rows other ranks reference (its boundary set), one all_gather ships the
(D, B_max, F) block, and each rank takes its halo rows from it
(`halo_exchange`). The all_gather's backward reduce-scatters the
cotangents, so the gradients need no collective written by hand beyond
the parameter sum of `parallel/data_parallel.py`.

`build_halo_batch` lays a width-layout batch out as per-rank shards (a
leading device axis); rank d trains on entry d (`halo_shard`), with
`NestedGINEff` under `halo_axis`.

The toy GINE stack of JAX's halo module runs on the same plan: this
rank's plan arrays (`shard_plan`), one aggregation (`halo_gine_aggregate`,
`make_halo_gine_forward`) and a whole training step of `num_layers`
layers h <- relu((h + agg(h)) @ w_i + b_i) with replicated {w_i, b_i},
a masked global L2 loss, summed gradients and an SGD update
(`make_halo_train_step`). Where JAX's functions take the whole arrays
sharded over the mesh, these take this rank's shard: rank d's node rows
d * N/D ... (d + 1) * N/D and its entry of the plan's leading axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.ops.segment import gather_rows, segment_sum, sorted_views
from escgnn_tpu_torch.parallel.data_parallel import (
    check_backend,
    make_sharded_step,
    row_share,
)
from escgnn_tpu_torch.parallel.mesh import (
    all_gather,
    axis_index,
    axis_size,
    check_axes,
    psum,
)
from escgnn_tpu_torch.train.loop import l1_node_loss, make_pool_train_step

PLAN_FIELDS = ("senders", "receivers", "edge_mask", "edge_perm",
               "boundary_send", "halo_src")


@dataclasses.dataclass
class HaloPlan:
    """Host-built sharding plan; arrays carry a leading device axis D."""

    num_devices: int
    nodes_per_shard: int  # N / D
    # (D, E_shard) local edge arrays: receivers in [0, nodes_per_shard),
    # senders in [0, nodes_per_shard + halo_max); ids >= nodes_per_shard
    # index the halo block
    senders: np.ndarray
    receivers: np.ndarray
    edge_mask: np.ndarray
    edge_perm: np.ndarray  # (D, E_shard) global edge id feeding each slot
    # (D, B_max) local ids of owned rows other devices reference
    boundary_send: np.ndarray
    # (D, H_max) positions into the flattened (D * B_max) boundary block
    halo_src: np.ndarray

    @property
    def edge_shard(self) -> int:
        return self.senders.shape[1]


def plan_halo_sharding(batch: GraphBatch, num_devices: int,
                       edge_budget: int = 0, boundary_budget: int = 0,
                       halo_budget: int = 0) -> HaloPlan:
    """Partition a padded batch's edges by receiver range (host side).
    The budgets raise E_shard / B_max / H_max to at least their value, so
    a pool of batches planned with shared budgets has one shape."""
    N = batch.num_nodes
    D = num_devices
    if N % D:
        raise ValueError(f"{N} nodes do not split over {D} devices")
    nps = N // D
    senders = np.asarray(batch.senders)
    receivers = np.asarray(batch.receivers)
    emask = np.asarray(batch.edge_mask)

    owner_e = receivers // nps  # receivers sorted => shards are contiguous
    counts = np.bincount(owner_e, minlength=D)
    E_shard = int(-(-int(counts.max()) // 8) * 8)
    E_shard = max(E_shard, int(edge_budget))

    s_l = np.zeros((D, E_shard), np.int32)
    r_l = np.zeros((D, E_shard), np.int32)
    m_l = np.zeros((D, E_shard), bool)
    perm = np.zeros((D, E_shard), np.int32)
    halo_global: list = []
    starts = np.searchsorted(owner_e, np.arange(D))
    ends = np.searchsorted(owner_e, np.arange(D) + 1)
    for d in range(D):
        sl = slice(int(starts[d]), int(ends[d]))
        k = ends[d] - starts[d]
        sd, rd, md = senders[sl], receivers[sl], emask[sl]
        lo = d * nps
        remote = (sd < lo) | (sd >= lo + nps)
        halo_ids = np.unique(sd[remote & md])
        local_of = {int(g): nps + i for i, g in enumerate(halo_ids)}
        s_loc = np.where(remote, 0, sd - lo)
        for i in np.flatnonzero(remote):
            s_loc[i] = local_of.get(int(sd[i]), nps)  # masked -> 0th halo
        s_l[d, :k] = s_loc
        r_l[d, :k] = rd - lo
        m_l[d, :k] = md
        perm[d, :k] = np.arange(starts[d], ends[d])
        # padding edge slots receive the shard's last row, masked
        r_l[d, k:] = nps - 1
        halo_global.append(halo_ids)

    H_max = max((len(h) for h in halo_global), default=0)
    H_max = max(int(-(-H_max // 8) * 8), 8, int(halo_budget))
    # boundary sets: rows owned by d that other devices request
    boundary: list = []
    for d in range(D):
        boundary.append(np.unique(np.concatenate(
            [h[(h >= d * nps) & (h < (d + 1) * nps)] for h in halo_global]
            or [np.zeros(0, np.int64)])))
    B_max = max((len(b) for b in boundary), default=0)
    B_max = max(int(-(-B_max // 8) * 8), 8, int(boundary_budget))
    b_send = np.zeros((D, B_max), np.int32)
    pos_of: dict = {}
    for d in range(D):
        b_send[d, :len(boundary[d])] = boundary[d] - d * nps
        for i, g in enumerate(boundary[d]):
            pos_of[int(g)] = d * B_max + i
    halo_src = np.zeros((D, H_max), np.int32)
    for d in range(D):
        for i, g in enumerate(halo_global[d]):
            halo_src[d, i] = pos_of[int(g)]

    return HaloPlan(num_devices=D, nodes_per_shard=nps, senders=s_l,
                    receivers=r_l, edge_mask=m_l, edge_perm=perm,
                    boundary_send=b_send, halo_src=halo_src)


def scatter_edge_payload(plan: HaloPlan, payload: np.ndarray) -> np.ndarray:
    """Re-lay a global (E, ...) edge payload into the plan's (D, E_shard,
    ...) shards (host side; padding slots get zeros)."""
    out = np.zeros((plan.num_devices, plan.edge_shard) + payload.shape[1:],
                   payload.dtype)
    valid = plan.edge_mask
    out[valid] = payload[plan.edge_perm[valid]]
    return out


def halo_exchange(x_local, boundary_send, halo_src, axis):
    """The remote sender rows of this rank: publish its boundary rows,
    all_gather the (D, B_max, F) block over `axis`, take this rank's halo
    rows from it. Returns (H_max, F)."""
    boundary = gather_rows(x_local, boundary_send)
    block = all_gather(boundary, axis)
    return gather_rows(block.reshape(-1, x_local.shape[-1]), halo_src)


def shard_plan(plan: HaloPlan, mesh, axis: str = "model",
               device="cuda") -> dict:
    """This rank's entry of the plan's arrays (`PLAN_FIELDS`), as tensors
    on `device`; rank d takes index d of the leading axis. The plan
    itself stays on the host."""
    check_axes(mesh, (axis,))
    device = resolve_device(device)
    d = axis_index(axis)
    return {k: torch.from_numpy(np.ascontiguousarray(getattr(plan, k)[d]))
            .to(device) for k in PLAN_FIELDS}


def halo_gine_aggregate(x_local, edge_emb_local, plan_dev: dict, axis,
                        edge_mask_local=None):
    """One GINE message aggregation under the halo plan, on this rank:
    out[v] = sum over its local edges (u -> v) of relu(x_ext[u] + e_uv),
    x_ext = [own rows | halo rows]. The halo all_gather is the only
    collective; the sum is local."""
    halo = halo_exchange(x_local, plan_dev["boundary_send"],
                         plan_dev["halo_src"], axis)
    x_ext = torch.cat([x_local, halo], dim=0)
    msg = torch.relu(gather_rows(x_ext, plan_dev["senders"])
                     + edge_emb_local)
    mask = plan_dev["edge_mask"]
    if edge_mask_local is not None:
        mask = mask & edge_mask_local
    return segment_sum(msg, plan_dev["receivers"], x_local.shape[0], mask)


def make_halo_gine_forward(mesh, axis: str = "model"):
    """`fwd(x_local, edge_emb_local, plan_dev) -> (N/D, F)`: the halo
    aggregation on this rank's node rows, its (E_shard, F) edge payload
    (`scatter_edge_payload`, entry d) and its `shard_plan`."""
    check_axes(mesh, (axis,))

    def fwd(x_local, edge_emb_local, plan_dev):
        return halo_gine_aggregate(x_local, edge_emb_local, plan_dev, axis)

    return fwd


def make_halo_train_step(mesh, num_layers: int, lr: float = 1e-2,
                         axis: str = "model"):
    """`step(params, x, edge_emb, y, node_mask, plan_dev) -> (new_params,
    loss)`: one node+edge-partitioned SGD step of the toy GINE stack on
    this rank's shard. `params` {'w_i': (F, F), 'b_i': (F,)} is
    replicated (the same on every rank, as after `weights.halo_params`).
    Each rank differentiates its rows' part of the masked global L2 mean
    (the node count summed over `axis`, outside the gradient); the
    gradients and the loss are summed over `axis`, so every rank takes
    the single-device step. The backward of the halo all_gather
    reduce-scatters the remote rows' cotangents."""
    check_axes(mesh, (axis,))
    names = [f"{p}_{i}" for i in range(num_layers) for p in ("w", "b")]

    def step(params: dict, x, edge_emb, y, node_mask, plan_dev):
        if sorted(params) != sorted(names):
            raise ValueError(f"params {sorted(params)}: want {names}")
        p = {k: params[k].detach().requires_grad_(True) for k in names}
        cnt = psum(node_mask.sum().to(torch.float32), axis).clamp_min(1.0)
        h = x
        with sorted_views():
            for i in range(num_layers):
                agg = halo_gine_aggregate(h, edge_emb, plan_dev, axis)
                h = torch.relu((h + agg) @ p[f"w_{i}"] + p[f"b_{i}"])
            err = torch.where(node_mask[:, None], h - y,
                              torch.zeros((), dtype=h.dtype, device=h.device))
            loss_local = (err * err).sum() / cnt
            grads = torch.autograd.grad(loss_local, [p[k] for k in names])
        new = {k: (p[k] - lr * psum(g, axis)).detach()
               for k, g in zip(names, grads)}
        return new, psum(loss_local.detach(), axis)

    return step


def build_halo_batch(batch: GraphBatch, plan: HaloPlan) -> GraphBatch:
    """Re-lay a padded width-layout host batch into per-rank halo shards
    (a leading device axis D on every tensor): node-aligned tensors as
    (D, N/D, ...) ranges; edge-aligned ones from the plan (senders,
    receivers, edge_mask) or re-laid by `scatter_edge_payload` (edge_attr,
    enc_idx, enc_cnt); graph-aligned ones (graph_mask, a graph-level y)
    repeated per rank; the plan's boundary_send / halo_src in `extras`
    for the model's per-conv exchange. `node_graph` keeps global graph
    ids (the graph head pools into the replicated graph slots)."""
    if batch.enc_idx is None or batch.enc_edge_row is not None:
        raise ValueError("halo sharding needs the width encoding layout "
                         "(BatchSpec(..., enc_layout='width')): per-edge "
                         "rows shard exactly")
    D, nps = plan.num_devices, plan.nodes_per_shard
    N = batch.num_nodes

    def host(a):
        return None if a is None else np.asarray(a)

    def node_shard(a):
        a = host(a)
        return None if a is None else a.reshape((D, nps) + a.shape[1:])

    def edge_shard(a):
        a = host(a)
        return None if a is None else scatter_edge_payload(plan, a)

    def graph_rep(a):
        a = host(a)
        return None if a is None else np.ascontiguousarray(
            np.broadcast_to(a, (D,) + a.shape))

    y = None
    if batch.y is not None:
        y = (node_shard(batch.y) if host(batch.y).shape[0] == N
             else graph_rep(batch.y))
    arrays = dict(
        x=node_shard(batch.x), y=y, pos=node_shard(batch.pos),
        node_mask=node_shard(batch.node_mask),
        node_graph=node_shard(batch.node_graph),
        senders=plan.senders, receivers=plan.receivers,
        edge_mask=plan.edge_mask, edge_attr=edge_shard(batch.edge_attr),
        enc_idx=edge_shard(batch.enc_idx), enc_cnt=edge_shard(batch.enc_cnt),
        graph_mask=graph_rep(batch.graph_mask),
    )
    tensors = {k: torch.from_numpy(np.array(v))
               for k, v in arrays.items() if v is not None}
    tensors["extras.halo_boundary_send"] = torch.from_numpy(plan.boundary_send)
    tensors["extras.halo_src"] = torch.from_numpy(plan.halo_src)
    return GraphBatch().with_tensors(tensors)


def halo_shard(halo_batch: GraphBatch, d: int, stacked: bool = False
               ) -> GraphBatch:
    """Rank d's entry of a halo batch (axis 0), or of every batch of a
    stack of halo batches (`stacked`: axis 1)."""
    return halo_batch.with_tensors(
        {k: (v[:, d] if stacked else v[d])
         for k, v in halo_batch.tensors().items()})


def make_halo_nested_train_step(model, opt, axis: str = "model",
                                graph_loss_fn=None, node_loss_fn=l1_node_loss):
    """`step(halo_shard) -> loss`: `model` (NestedGINEff) trained under
    receiver-range node+edge sharding, on this rank's entry of a
    `build_halo_batch` batch. Graph-level heads (`graph_loss_fn` given,
    the model built with `graph_pred`): the pooled rows, and so the loss,
    are whole on every rank, which differentiates it / D. Node-level
    heads: each rank differentiates its rows' part of the masked mean
    `node_loss_fn` (`row_share`). The summed gradients are the
    single-device step's on the whole batch."""
    sharded = model.sharded_view(halo_axis=axis)
    if graph_loss_fn is not None:
        D = axis_size(axis)

        def share(out, b):
            return graph_loss_fn(out, b) / D
    else:
        def share(out, b):
            return row_share(node_loss_fn(out, b), out, b, axis)

    return make_sharded_step(sharded, opt, share, grad_axis=axis)


def make_halo_pool_train_step(model, opt, pool_like: GraphBatch,
                              axis: str = "model", graph_loss_fn=None,
                              node_loss_fn=l1_node_loss):
    """`epoch(shard_pool, order) -> losses`: the halo step over a stack of
    this rank's halo shards (`halo_shard(..., stacked=True)` of stacked
    halo batches planned with shared budgets), one step per index of
    `order`; a CUDA graph on NCCL
    (`parallel.data_parallel.check_backend`)."""
    check_backend(pool_like.graph_mask.device)
    step = make_halo_nested_train_step(model, opt, axis, graph_loss_fn,
                                       node_loss_fn)
    return make_pool_train_step(model, opt, None, pool_like, step_fn=step)
