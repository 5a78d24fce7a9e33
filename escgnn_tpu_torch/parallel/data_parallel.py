"""Data-parallel training and the sharded train step every parallel mode
shares (counterpart of `escgnn_tpu/parallel/data_parallel.py`).

One rank per device. The gradient rule, exact by construction:
  * every collective inside the forward is an autograd one
    (`parallel.mesh.psum` / `all_gather`), whose backward sums the
    cotangents over the same ranks;
  * each rank differentiates its own share of the loss, the shares over
    the group summing to the global loss: under dp a rank's own mean
    loss / D (JAX's `pmean`); under ep and halo, where every rank
    computes the same global loss, that loss / D; rows split over an
    axis (dp_ep's node and graph rows, halo's node rows) give each rank
    its rows' part of the masked mean (`row_share`);
  * after backward every parameter gradient is summed over the group,
    then the optimizer steps identically on every rank.
Under dp the BatchNorm running statistics are then averaged over the data
group, so the replicas stay equal (batch statistics stay per replica, as
in JAX's dp).

`make_dp_pool_train_step` is the driver-facing dp epoch: each step takes
one row of a (steps, D) order matrix and rank d trains on batch
`order[step, d]` of its pool. A pool on a CUDA device is stepped by a
CUDA graph (`train/loop.py`), which holds NCCL's collectives; gloo's
cannot be captured, so such a pool under gloo raises (`check_backend`).
A pool on the CPU is stepped eagerly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.models.layers import set_use_running_average
from escgnn_tpu_torch.ops.segment import sorted_views
from escgnn_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    replicate,
)
from escgnn_tpu_torch.train.loop import make_pool_train_step, model_generators

_STAT_NAMES = ("running_mean", "running_var")


def allreduce_grads_(model: torch.nn.Module, axis) -> None:
    """Sum every parameter gradient over the ranks of `axis`, in place,
    as one flat collective."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    dist.all_reduce(flat, group=axis_group(axis))
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


@torch.no_grad()
def average_bn_stats_(model: torch.nn.Module, axis) -> None:
    """Average the BatchNorm running statistics over the ranks of `axis`."""
    stats = [b for k, b in model.named_buffers()
             if k.rsplit(".", 1)[-1] in _STAT_NAMES]
    if not stats:
        return
    flat = torch.cat([b.reshape(-1) for b in stats])
    dist.all_reduce(flat, group=axis_group(axis))
    flat /= axis_size(axis)
    off = 0
    for b in stats:
        b.copy_(flat[off:off + b.numel()].view_as(b))
        off += b.numel()


def _sum_over(t: torch.Tensor, axis) -> torch.Tensor:
    """A detached sum over the ranks of `axis` (no gradient flows)."""
    t = t.detach().clone()
    dist.all_reduce(t, group=axis_group(axis))
    return t


def row_share(loss: torch.Tensor, out: torch.Tensor, batch: GraphBatch,
              axis) -> torch.Tensor:
    """This rank's part of a masked-mean loss over rows split over `axis`:
    `loss` (this rank's masked mean, its sum over max(count, 1) of its
    rows) times its real rows over the group's. Over the group the parts
    sum to the mean over every rank's rows. The rows are graphs when `out`
    has one per graph, else nodes."""
    mask = (batch.graph_mask if out.shape[0] == batch.num_graphs
            else batch.node_mask)
    local = mask.to(torch.float32).sum()
    total = _sum_over(local, axis)
    return loss * local.clamp_min(1.0) / total.clamp_min(1.0)


def make_sharded_step(model: torch.nn.Module, opt, share_fn, grad_axis,
                      bn_axis=None):
    """`step(batch) -> loss`: one train step of a parallel mode.
    `share_fn(out, batch)` is this rank's share of the loss; the
    gradients are summed over `grad_axis` before the optimizer step, the
    BatchNorm running statistics averaged over `bn_axis` after it (dp).
    Returns the global loss, the shares summed over `grad_axis`."""

    def step(batch: GraphBatch) -> torch.Tensor:
        model.train()
        set_use_running_average(model, False)
        opt.zero_grad(set_to_none=True)
        with sorted_views():
            share = share_fn(model(batch), batch)
            share.backward()
        allreduce_grads_(model, grad_axis)
        opt.step()
        if bn_axis is not None:
            average_bn_stats_(model, bn_axis)
        return _sum_over(share, grad_axis)

    return step


def make_dp_train_step(model: torch.nn.Module, opt, loss_fn, mesh,
                       axis: str = "data"):
    """`step(batch) -> loss`: the dp step on this rank's batch; the loss
    returned is the mean over the replicas (JAX's `pmean`)."""
    D = mesh.size(mesh.mesh_dim_names.index(axis))
    return make_sharded_step(model, opt,
                             lambda out, b: loss_fn(out, b) / D,
                             grad_axis=axis, bn_axis=axis)


def check_backend(device) -> None:
    """A parallel pool step on a CUDA device is captured into a CUDA
    graph, which can hold NCCL's collectives but not gloo's: under any
    other backend it raises, and never turns eager on its own."""
    if torch.device(device).type == "cuda" and dist.get_backend() != "nccl":
        raise ValueError(f"a parallel pool step on a CUDA device is a CUDA "
                         f"graph and needs NCCL; the group's backend is "
                         f"{dist.get_backend()}")


def seed_rank_generators(model: torch.nn.Module, seed: int, rank: int):
    """Reseed the model's generators (dropout) from (seed, rank), so every
    replica draws its own masks (JAX folds the axis index into the key)."""
    for i, g in enumerate(model_generators(model)):
        g.manual_seed(int(np.random.SeedSequence([seed, rank, i])
                          .generate_state(1)[0]))


class _OrderColumn:
    """A pool step fed one column of a (steps, D) order matrix: this
    rank's."""

    def __init__(self, inner, column: int, width: int):
        self.inner, self.column, self.width = inner, column, width

    def __call__(self, pool: GraphBatch, order) -> torch.Tensor:
        order = np.asarray(order)
        if order.ndim != 2 or order.shape[1] != self.width:
            raise ValueError(f"the dp order must be (steps, {self.width}), "
                             f"got {order.shape}")
        return self.inner(pool, order[:, self.column])


def make_dp_pool_train_step(model: torch.nn.Module, opt, loss_fn, mesh,
                            pool_like: GraphBatch, axis: str = "data",
                            decode=None, seed: int = 0):
    """`epoch(pool, order) -> losses`: the whole-epoch dp step. `order` is
    (steps, D) pool indices; rank d trains step i on `pool[order[i, d]]`
    (its own pool: the replicated train pools, or its process's shard),
    so the effective batch is D batches with mean-of-means weighting.
    `losses` (steps,) are the replica means. `decode` is a compressed
    pool's decoder."""
    check_backend(pool_like.graph_mask.device)
    d = axis_index(axis)
    seed_rank_generators(model, seed, d)
    step = make_dp_train_step(model, opt, loss_fn, mesh, axis)
    inner = make_pool_train_step(model, opt, loss_fn, pool_like,
                                 decode=decode, step_fn=step)
    return _OrderColumn(inner, d, mesh.size(mesh.mesh_dim_names.index(axis)))


def replicate_state(model: torch.nn.Module, opt, mesh) -> None:
    """Broadcast the parameters, buffers (the BatchNorm statistics) and
    optimizer state from rank 0 to every rank, in place."""
    tensors = list(model.parameters()) + list(model.buffers())
    for state in opt.state.values():
        tensors += [v for v in state.values() if isinstance(v, torch.Tensor)]
    replicate(tensors, mesh)
