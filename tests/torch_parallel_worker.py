"""One rank of the parallel-mode checks of `test_torch_port_parallel.py`:

    python tests/torch_parallel_worker.py <rank> <world> <in.pt> <out_dir>

Joins a gloo group of `world` ranks on localhost (rank 0 binds a free
port itself and publishes it in `<out_dir>/port`, where the other ranks
read it, so no other process can take the port between its choice and
its bind), runs every case
of `<in.pt>` (made by the test from numpy seeds, the weights carried from
a flax init) through the port's parallel modes on CPU tensors and writes
this rank's results to `<out_dir>/rank<rank>.pt`. Imports the port only,
never JAX.
"""

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from escgnn_tpu_torch.models.layers import GINEConv  # noqa: E402
from escgnn_tpu_torch.models.nested_gin_eff import (  # noqa: E402
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.parallel import data_parallel as dpm  # noqa: E402
from escgnn_tpu_torch.parallel import edge_partition as ep  # noqa: E402
from escgnn_tpu_torch.parallel import halo  # noqa: E402
from escgnn_tpu_torch.parallel.mesh import (  # noqa: E402
    all_gather,
    axis_index,
    make_mesh,
    shard_stacked,
)
from escgnn_tpu_torch.parallel.multihost import (  # noqa: E402
    host_local_to_global,
    init_multihost,
    make_global_mesh,
    process_shard,
)
from escgnn_tpu_torch.weights import halo_params  # noqa: E402
from escgnn_tpu_torch.train.loop import (  # noqa: E402
    l1_graph_loss,
    l1_node_loss,
)


def _model(inp, key="model"):
    cfg = NestedGINEffConfig(**inp[key + "_cfg"])
    m = NestedGINEff(cfg, in_dim=inp["in_dim"], device="cpu")
    m.load_state_dict(inp[key + "_state"])
    return m


def _grads(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _sgd(model, lr):
    return torch.optim.SGD(model.parameters(), lr=lr)


class _PassThrough(torch.nn.Module):
    """An MLP stand-in: GINEConv's output is then x + the aggregation."""

    def forward(self, x, mask=None, axis=None):
        return x


def _store(rank: int, world: int, out_dir: str):
    """The group's TCP store, on a port rank 0 binds and publishes in
    `<out_dir>/port`."""
    path = os.path.join(out_dir, "port")
    if rank == 0:
        store = dist.TCPStore("localhost", 0, world, True,
                              wait_for_workers=False)
        with open(path + ".tmp", "w") as f:
            f.write(str(store.port))
        os.replace(path + ".tmp", path)
        return store
    deadline = time.time() + 120
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"rank 0 published no port in {path}")
        time.sleep(0.05)
    with open(path) as f:
        return dist.TCPStore("localhost", int(f.read()), world, False)


def run(rank: int, world: int, inp: dict, out_dir: str) -> dict:
    out = {}
    dist.init_process_group("gloo", store=_store(rank, world, out_dir),
                            world_size=world, rank=rank)
    # multihost: an initialized group is joined, not joined again
    out["multihost"] = init_multihost()
    out["shard"] = process_shard(list(range(7)))
    lr = inp["lr"]
    mesh = make_global_mesh(("data",), device="cpu")
    rows = host_local_to_global(
        {"rows": inp["global_rows"][rank::world]}, mesh, "data",
        device="cpu")["rows"]
    out["global_mesh"] = (tuple(mesh.mesh_dim_names), mesh.size())
    out["global_rows"] = all_gather(rows, "data")

    # --- dp: one step on this rank's batch, then a pool epoch ---
    mesh = make_mesh(0, ("data",), device="cpu")
    model = _model(inp)
    if rank:  # replicate_state must put rank 0's weights back
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    opt = _sgd(model, lr)
    dpm.replicate_state(model, opt, mesh)
    batch = shard_stacked(inp["dp_stacked"], mesh, "data", device="cpu")
    loss = dpm.make_dp_train_step(model, opt, l1_node_loss, mesh)(batch)
    out["dp_step"] = dict(loss=float(loss), grads=_grads(model),
                          state=_state(model))
    model = _model(inp)
    opt = _sgd(model, lr)
    pool = inp["dp_pool"]
    step = dpm.make_dp_pool_train_step(model, opt, l1_node_loss, mesh, pool)
    losses = step(pool, inp["dp_order"])
    out["dp_pool"] = dict(losses=losses.tolist(), state=_state(model))
    try:
        step(pool, np.asarray(inp["dp_order"])[:, :1])
    except ValueError as e:
        out["dp_bad_order"] = str(e)

    # --- ep: one step on the width and on the dedup layout, a pool epoch
    mesh = make_mesh(0, ("model",), device="cpu")
    for name in ("width", "dedup"):
        model = _model(inp)
        opt = _sgd(model, lr)
        shard = ep.shard_batch_by_edges(inp[f"ep_{name}"], mesh, "model")
        loss = ep.make_ep_train_step(model, opt, l1_node_loss)(shard)
        out[f"ep_{name}"] = dict(loss=float(loss), grads=_grads(model),
                                 state=_state(model), shard=shard.tensors())
    model = _model(inp)
    opt = _sgd(model, lr)
    pool = ep.shard_pool_by_edges(inp["ep_pool"], mesh)
    losses = ep.make_ep_pool_train_step(model, opt, l1_node_loss, pool)(
        pool, inp["ep_order"])
    out["ep_pool"] = dict(losses=losses.tolist(), state=_state(model))
    model = _model(inp)
    opt = _sgd(model, lr)
    shard = ep.shard_batch_by_edges(inp["ep_flat"], mesh, "model")
    loss = ep.make_ep_train_step(model, opt, l1_node_loss)(shard)
    out["ep_flat"] = dict(loss=float(loss), grads=_grads(model),
                          state=_state(model), shard=shard.tensors())

    # --- halo: GINEConv's exchange and aggregation, then model steps ---
    plan = inp["halo_plan"]
    d = axis_index("model")
    nps = plan.nodes_per_shard
    x = inp["halo_x"][d * nps:(d + 1) * nps]
    emb = torch.from_numpy(halo.scatter_edge_payload(
        plan, inp["halo_edge_emb"].numpy())[d])
    conv = GINEConv(x.shape[1], _PassThrough(), generator=torch.Generator())
    local = {k: torch.from_numpy(getattr(plan, k)[d])
             for k in ("senders", "receivers", "edge_mask", "boundary_send",
                       "halo_src")}
    with torch.no_grad():
        out["halo_agg"] = conv(
            x, local["senders"], local["receivers"], emb, local["edge_mask"],
            halo=("model", local["boundary_send"], local["halo_src"]))
    try:
        dpm.check_backend(torch.device("cuda"))
    except ValueError as e:
        out["graphed_gloo"] = str(e)
    # the toy GINE stack: its aggregation and one training step
    toy = inp["toy"]
    plan_dev = halo.shard_plan(plan, mesh, "model", device="cpu")
    rows = slice(d * nps, (d + 1) * nps)
    toy_emb = torch.from_numpy(halo.scatter_edge_payload(
        plan, toy["edge_emb"])[d])
    out["toy_agg"] = halo.make_halo_gine_forward(mesh, "model")(
        torch.from_numpy(toy["x"][rows]), toy_emb, plan_dev)
    step = halo.make_halo_train_step(mesh, toy["num_layers"], lr)
    params, losses = halo_params(toy["params"], "cpu"), []
    for _ in range(2):
        params, loss = step(params, torch.from_numpy(toy["x"][rows]),
                            toy_emb, torch.from_numpy(toy["y"][rows]),
                            torch.from_numpy(toy["node_mask"][rows]),
                            plan_dev)
        losses.append(float(loss))
    out["toy_step"] = dict(losses=losses, params=params)
    for name, key, gl in (("halo_node", "model", None),
                          ("halo_graph", "graph", l1_graph_loss)):
        model = _model(inp, key)
        opt = _sgd(model, lr)
        shard = halo.halo_shard(inp[f"{name}_batch"], d)
        loss = halo.make_halo_nested_train_step(
            model, opt, "model", graph_loss_fn=gl)(shard)
        out[name] = dict(loss=float(loss), state=_state(model))

    # --- dp_ep: graphs over 2 data shards, edges over data x model ---
    mesh = make_mesh(0, ("data", "model"), (world, 1), device="cpu")
    model = _model(inp)
    opt = _sgd(model, lr)
    shard = ep.shard_batch_2d(inp["ep_dedup"], mesh)
    loss = ep.make_dp_ep_train_step(model, opt, l1_node_loss)(shard)
    out["dp_ep"] = dict(loss=float(loss), grads=_grads(model),
                        state=_state(model))
    out["dp_ep_rows"] = int(shard.x.shape[0])
    dist.barrier()
    dist.destroy_process_group()
    return out


def main():
    rank, world = (int(v) for v in sys.argv[1:3])
    torch.set_num_threads(1)
    inp = torch.load(sys.argv[3], weights_only=False)
    out = run(rank, world, inp, sys.argv[4])
    torch.save(out, os.path.join(sys.argv[4], f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
