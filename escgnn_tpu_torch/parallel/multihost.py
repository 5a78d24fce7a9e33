"""Multi-process training (counterpart of `escgnn_tpu/parallel/multihost.py`).

JAX connects the processes of a slice with `jax.distributed.initialize`
and every process sees the global device list. Here every process is one
rank with one device: `init_multihost` joins the process group (the
coordinator's address given, or the environment `torchrun` sets), the
mesh is the world (`parallel.mesh.make_mesh`), and each rank keeps its
own rows (`process_shard`) on its own device. With no coordinator and no
such environment nothing is initialized and the run is one process, as
in JAX. `make_global_mesh` is the mesh over every process's device and
`host_local_to_global` places each process's rows into it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.parallel.mesh import (
    backend_for,
    check_axes,
    make_mesh,
)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device="cuda") -> tuple:
    """Join the multi-process group; returns (process_count,
    process_index). Without a coordinator, a process count above 1, or
    the `torchrun` environment (`WORLD_SIZE` > 1), nothing is initialized
    and (1, 0) comes back: a one-process run is unchanged. Otherwise the
    group is `tcp://<coordinator>` with `num_processes` ranks, this one
    `process_id` (both read from `WORLD_SIZE` / `RANK` when not given),
    NCCL on a CUDA device and gloo on the CPU."""
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    explicit = coordinator_address is not None or (
        num_processes is not None and num_processes > 1)
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    if not explicit and env_world <= 1:
        return 1, 0
    if coordinator_address is None:
        init_method = "env://"
    else:
        init_method = f"tcp://{coordinator_address}"
    world = num_processes if num_processes is not None else env_world
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    dist.init_process_group(backend_for(device), init_method=init_method,
                            world_size=world, rank=rank)
    return dist.get_world_size(), dist.get_rank()


def process_shard(items: Sequence, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> list:
    """This process's strided shard of a dataset (the DistributedSampler
    role); the identity for one process."""
    initialized = dist.is_initialized()
    pc = process_count if process_count is not None else (
        dist.get_world_size() if initialized else 1)
    pi = process_index if process_index is not None else (
        dist.get_rank() if initialized else 0)
    return list(items[pi::pc])


def make_global_mesh(axis_names: Sequence[str] = ("data",),
                     shape: Optional[Sequence[int]] = None, device="cuda"):
    """The mesh over every process's device (the world, one device per
    rank), `shape` factoring it over `axis_names` (by default all ranks on
    the first axis); with one process it is `parallel.mesh.make_mesh`.
    Every process must call it with the same arguments."""
    return make_mesh(None, axis_names, shape, device=device)


def host_local_to_global(tree, mesh, spec, device="cuda"):
    """Each process's local data placed into the global layout of `mesh`:
    every leaf of `tree` (a tensor, a numpy array, a `GraphBatch`, or a
    dict / list / tuple of them) is this process's part of a global
    array split along its leading axis over the mesh axes `spec` names
    (an axis name, a tuple of names, or None: replicated), as in JAX.
    JAX assembles one global array across the processes; here a rank
    holds one device, whose addressable part of that array is exactly
    its local rows, so each leaf comes back as a tensor on this rank's
    `device` (the identity on the values, as JAX's single-process
    device_put is). The ranks of the split axes hold consecutive row
    blocks in rank order; the collectives that read the global array
    (`parallel.mesh.psum`, `all_gather`) combine them."""
    check_axes(mesh, () if spec is None else (
        (spec,) if isinstance(spec, str) else tuple(spec)))
    device = resolve_device(device)

    def put(x):
        if isinstance(x, GraphBatch):
            return x.to(device)
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        return t.to(device)

    return put(tree)
