"""Multi-process training (counterpart of `escgnn_tpu/parallel/multihost.py`).

JAX connects the processes of a slice with `jax.distributed.initialize`
and every process sees the global device list. Here every process is one
rank with one device: `init_multihost` joins the process group (the
coordinator's address given, or the environment `torchrun` sets), the
mesh is the world (`parallel.mesh.make_mesh`), and each rank keeps its
own rows (`process_shard`) on its own device. With no coordinator and no
such environment nothing is initialized and the run is one process, as
in JAX.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch.distributed as dist

from escgnn_tpu_torch.parallel.mesh import backend_for


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

