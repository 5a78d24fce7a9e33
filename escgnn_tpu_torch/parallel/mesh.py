"""Device meshes over `torch.distributed` (counterpart of
`escgnn_tpu/parallel/mesh.py`).

JAX runs one process over many devices (`jax.sharding.Mesh`). Here a
mesh of D devices is a world of D ranks, one device each: `make_mesh`
lays a `DeviceMesh` over the whole world with the axis names the JAX
package uses ("data", "model", or both), each axis its own process group.
The backend is NCCL on CUDA devices and gloo on the CPU; a plain process
(no `torchrun`, no `--multihost`) is a world of one rank.

The models name the axes their rows are split over (`NestedGINEffConfig`
`edge_shard_axis`, `halo_axis`, `data_axis`); `axis_group` resolves a
name, or a tuple of names, on the mesh made last, and `psum` /
`all_gather` are the autograd collectives the models call (their
backwards are an all-reduce sum and a reduce-scatter, so each rank's
gradient is its share, see `parallel/data_parallel.py`).
"""

from __future__ import annotations

import os
import socket
import warnings
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from escgnn_tpu_torch.data.container import GraphBatch
# batches of one shape stacked along a new leading (device or pool) axis:
# JAX's `parallel.mesh.stack_batches`, the function the pools stack with
from escgnn_tpu_torch.data.prefetch import stack_batches  # noqa: F401
from escgnn_tpu_torch.device import resolve_device

# the mesh `axis_group` resolves names on (the last `make_mesh`)
_MESH = None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device) -> torch.device:
    """This rank's device: a CUDA device without an index becomes
    `cuda:<LOCAL_RANK>` under `torchrun`, `cuda:0` otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def is_main_rank() -> bool:
    """True outside a process group and on its rank 0: the one rank that
    writes a run's log and checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def backend_for(device) -> str:
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def init_world(device, backend: Optional[str] = None) -> int:
    """Join the process group if this process has none yet: from the
    environment `torchrun` sets (`WORLD_SIZE`, `RANK`, `MASTER_ADDR`), else
    as a world of one rank on a free localhost port. `backend` defaults
    to NCCL on a CUDA device, gloo on the CPU. Returns the world size."""
    if not dist.is_initialized():
        backend = backend or backend_for(device)
        if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                world_size=1, rank=0)
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, device="cuda"):
    """A `DeviceMesh` over the world (joined by `init_world` if needed).
    `n_devices` must be the world size, or 0 / None for all ranks: a
    rank is one device. `shape` factors it over several axes (such as
    (2, 4) for a data x model mesh); by default every rank lies on the
    first axis. On NCCL each axis's communicator is created and warmed by
    one collective here, before any step is captured into a CUDA graph.
    The mesh becomes the one `axis_group` resolves names on."""
    from torch.distributed.device_mesh import init_device_mesh

    global _MESH
    device = resolve_device(device)
    world = init_world(device)
    if n_devices and n_devices != world:
        raise ValueError(f"--mesh_devices {n_devices}: a mesh is the world of "
                         f"{world} rank(s), one device each (0 = all)")
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(v) for v in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} for axes {axis_names}")
    if _prod(shape) != world:
        raise ValueError(f"mesh shape {shape} does not cover the world of "
                         f"{world} rank(s)")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = init_device_mesh(device.type, shape, mesh_dim_names=axis_names)
    if dist.get_backend() == "nccl":
        for name in axis_names:
            dist.all_reduce(torch.zeros(1, device=device),
                            group=mesh.get_group(name))
        torch.cuda.synchronize(device)
    _MESH = mesh
    return mesh


def _prod(shape) -> int:
    n = 1
    for v in shape:
        n *= v
    return n


def current_mesh():
    if _MESH is None:
        raise RuntimeError("no mesh: call parallel.mesh.make_mesh first")
    return _MESH


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_group(axis):
    """The process group of one axis of the current mesh, or of several
    (a tuple of names) together: all of the mesh's axes give the world."""
    mesh = current_mesh()
    names = _axes(axis)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if sorted(names) == sorted(mesh.mesh_dim_names):
        return dist.group.WORLD
    raise ValueError(f"axes {names}: a group of several axes must span the "
                     f"mesh {mesh.mesh_dim_names}")


def check_axes(mesh, axes) -> None:
    """Raise unless every name in `axes` is an axis of `mesh`."""
    missing = [a for a in axes if a not in (mesh.mesh_dim_names or ())]
    if missing:
        raise ValueError(f"axes {missing} are not axes of the mesh "
                         f"{mesh.mesh_dim_names}")


def axis_size(axis) -> int:
    return dist.get_world_size(axis_group(axis))


def axis_index(axis: str) -> int:
    """This rank's coordinate on one axis of the current mesh."""
    mesh = current_mesh()
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def psum(t: torch.Tensor, axis) -> torch.Tensor:
    """Sum of `t` over the ranks of `axis`, differentiable: its backward
    sums the cotangents over the same ranks (`_AllReduce.backward`)."""
    import torch.distributed.nn.functional as F

    with warnings.catch_warnings():
        # torch marks the autograd collectives deprecated in favour of
        # functional ones, whose backward this package does not use
        warnings.simplefilter("ignore", FutureWarning)
        return F.all_reduce(t, group=axis_group(axis))


def all_gather(t: torch.Tensor, axis) -> torch.Tensor:
    """(D, ...) stack of `t` from every rank of `axis`, in rank order,
    differentiable: its backward reduce-scatters the cotangents."""
    import torch.distributed.nn.functional as F

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return torch.stack(F.all_gather(t, group=axis_group(axis)))


def shard_stacked(batch: GraphBatch, mesh, axis: str = "data",
                  device="cuda") -> GraphBatch:
    """This rank's entry of a [D, ...]-stacked batch (D the size of
    `axis`), on `device`."""
    d = mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]
    return batch.with_tensors(
        {k: v[d] for k, v in batch.tensors().items()}).to(device)


@torch.no_grad()
def replicate(tensors, mesh, src: int = 0) -> None:
    """Broadcast tensors in place from global rank `src` to every rank of
    the mesh; a CPU tensor under NCCL goes through the rank's device."""
    device = None
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    for t in tensors:
        if device is not None and t.device.type != "cuda":
            buf = t.to(device)
            dist.broadcast(buf, src)
            t.copy_(buf.cpu())
        else:
            dist.broadcast(t, src)
