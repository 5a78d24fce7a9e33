"""The parallel modes on `torch.distributed`, one rank per device
(counterpart of `escgnn_tpu/parallel/`): `mesh` (meshes, the autograd
collectives), `data_parallel` (dp and the gradient rule every mode
shares), `edge_partition` (ep and dp_ep), `halo` (node+edge shards with a
boundary exchange) and `multihost` (the process group of several
processes)."""

from escgnn_tpu_torch.parallel.data_parallel import (
    make_dp_train_step,
    replicate_state,
)
from escgnn_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard_stacked,
)

__all__ = ["make_mesh", "shard_stacked", "replicate", "make_dp_train_step",
           "replicate_state"]
