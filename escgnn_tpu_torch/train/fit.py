"""The twins' epoch loops.

`fit`: the regression loop, which the JAX drivers `run_zinc.py`,
`run_zinc_cycle.py`, `run_qm9.py` and `run_graphcount.py` each write
out. Per epoch: one pool step over a device-resident train pool (pool
`(epoch - 1) % k` of `stacked_batch_pools`, its batches in an order drawn
from `np.random.default_rng(seed)`), or with `--reshuffle_membership`
eager steps over batches re-formed by the prefetch thread; the exact BN
refresh under `--bn_eval running`; val MAE; the plateau scheduler; test
MAE at each new best val MAE; one log line in the JAX drivers' format.
With `--compress_pools` the pools and eval stacks are stored losslessly
downcast (`data/compress.py`), decoded inside the steps. With a mesh
(`make_run_mesh`, `--mesh dp|ep|dp_ep|halo`) the epoch is that mode's
pool step (`parallel/`) on this rank's pool or shard; evaluation runs the
plain model on the whole val and test stacks on every rank.

`fit_classifier` and `accuracy`: the classification loop of `run_csl.py`
and `run_exp.py` (a fixed train split, its batches in a fresh order each
epoch, no scheduler) and their accuracy eval.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from escgnn_tpu_torch.data.prefetch import (
    _host_batches,
    pool_size,
    prefetched_batches,
    stack_batches,
    stack_split,
    stack_split_compressed,
    stacked_batch_pools,
)
from escgnn_tpu_torch.data.batching import batch_iterator
from escgnn_tpu_torch.train.loop import (
    PlateauScheduler,
    ce_graph_loss,
    get_learning_rate,
    make_pool_eval_step,
    make_pool_refresh_step,
    make_pool_train_step,
    set_learning_rate,
    train_step,
)
from escgnn_tpu_torch.parallel.mesh import is_main_rank
from escgnn_tpu_torch.utils.rundir import log_line

POOL_BYTES = 4 * 2**30  # the stacked train pools' budget on the card
COMPRESSED_POOL_BYTES = 10 * 2**30  # the same, counted compressed


def make_run_mesh(args, device):
    """The mesh of `--mesh` (`--mesh_devices` the world size or 0,
    `--mesh_dp` the data axis of dp_ep), or None for `--mesh none`;
    prints the JAX drivers' mesh line."""
    from escgnn_tpu_torch.parallel.mesh import init_world, make_mesh

    if args.mesh == "none":
        return None
    n_dev = init_world(device)
    if args.mesh == "dp_ep":
        if n_dev % args.mesh_dp:
            raise ValueError(f"--mesh_dp {args.mesh_dp} does not divide the "
                             f"{n_dev} rank(s)")
        mesh = make_mesh(args.mesh_devices, ("data", "model"),
                         (args.mesh_dp, n_dev // args.mesh_dp), device)
        print(f"mesh: dp_ep over {args.mesh_dp}x{n_dev // args.mesh_dp} "
              f"devices (graphs over data, edges over data x model)")
        return mesh
    mesh = make_mesh(args.mesh_devices,
                     ("data",) if args.mesh == "dp" else ("model",),
                     device=device)
    if args.mesh == "dp":
        print(f"mesh: dp over {n_dev} devices "
              f"(effective batch {n_dev * args.batch_size})")
    elif args.mesh == "halo":
        print(f"mesh: halo over {n_dev} devices (receiver-range node+edge "
              f"shards, boundary all_gather per conv)")
    else:
        print(f"mesh: ep over {n_dev} devices "
              f"(edge arrays sharded, batch {args.batch_size})")
    return mesh


def halo_spec(graphs, batch_size: int, n_dev: int):
    """The halo mode's batches: the width encoding layout (per-edge rows
    shard exactly), the node budget rounded up to a multiple of the
    world."""
    import dataclasses

    from escgnn_tpu_torch.data.batching import BatchSpec

    spec = BatchSpec.from_graphs(graphs, batch_size, enc_layout="width")
    if spec.num_nodes % n_dev:
        spec = dataclasses.replace(
            spec, num_nodes=spec.num_nodes + n_dev - spec.num_nodes % n_dev)
    return spec


def _agree_min(n: int, device) -> int:
    """The least of every rank's `n` (their train shards may differ)."""
    import torch.distributed as dist

    t = torch.tensor([n], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def _epoch_runner(args, model, opt, loss_fn, splits, spec, device, mesh,
                  node_level: bool, batch_transform):
    """`run(epoch, data_rng) -> losses`: one epoch of the run's mode."""
    from escgnn_tpu_torch.parallel import data_parallel as dp
    from escgnn_tpu_torch.parallel import edge_partition as ep

    mode = "none" if mesh is None else args.mesh
    compress = getattr(args, "compress_pools", False)
    if args.reshuffle_membership:
        if mode != "none":
            raise ValueError("--mesh trains on device-resident pools: no "
                             "--reshuffle_membership")

        def run(epoch, data_rng):
            return torch.stack([
                train_step(model, opt, b, loss_fn)
                for b in prefetched_batches(splits["train"], spec,
                                            shuffle=True, rng=data_rng,
                                            device=device)])
        return run
    if mode != "none":
        dp.replicate_state(model, opt, mesh)
    if mode == "halo":
        return _halo_runner(model, opt, loss_fn, splits, spec, device, mesh,
                            node_level)
    pools, n, decode = stacked_batch_pools(
        splits["train"], spec, k=args.membership_pools, seed=args.seed,
        compress=compress,
        max_total_bytes=COMPRESSED_POOL_BYTES if compress else POOL_BYTES,
        device=device, batch_transform=batch_transform)
    decode = decode if compress else None
    if mode == "dp":
        D = mesh.size()
        n = _agree_min(n, device)
        if n < D:
            raise ValueError(f"need >= {D} train batches for --mesh dp, "
                             f"have {n}")
        step = dp.make_dp_pool_train_step(model, opt, loss_fn, mesh,
                                          pools[0], decode=decode,
                                          seed=args.seed)

        def run(epoch, data_rng):
            perm = data_rng.permutation(n)
            steps = n // D
            return step(pools[(epoch - 1) % len(pools)],
                        perm[:steps * D].reshape(steps, D))
        return run
    if mode == "ep":
        pools = [ep.shard_pool_by_edges(p, mesh) for p in pools]
        step = ep.make_ep_pool_train_step(model, opt, loss_fn, pools[0],
                                          decode=decode)
    elif mode == "dp_ep":
        pools = [ep.shard_pool_2d(p, mesh) for p in pools]
        step = ep.make_dp_ep_pool_train_step(model, opt, loss_fn, pools[0],
                                             decode=decode)
    else:
        step = make_pool_train_step(model, opt, loss_fn, pools[0],
                                    decode=decode)

    def run(epoch, data_rng):
        # single-device, ep and dp_ep share the schedule
        return step(pools[(epoch - 1) % len(pools)],
                    data_rng.permutation(n))
    return run


def _halo_runner(model, opt, loss_fn, splits, spec, device, mesh,
                 node_level: bool):
    """The halo epoch: the train split's batches in order, each planned
    with budgets shared by all (one shape, one captured step), this
    rank's shards stacked on its device, walked in a fresh order."""
    from escgnn_tpu_torch.parallel.halo import (
        build_halo_batch,
        halo_shard,
        make_halo_pool_train_step,
        plan_halo_sharding,
    )
    from escgnn_tpu_torch.parallel.mesh import axis_index

    D = mesh.size()
    host = _host_batches(splits["train"], spec)
    plans = [plan_halo_sharding(b, D) for b in host]
    eb = max(p.edge_shard for p in plans)
    bb = max(p.boundary_send.shape[1] for p in plans)
    hb = max(p.halo_src.shape[1] for p in plans)
    stacked = stack_batches([
        build_halo_batch(b, plan_halo_sharding(b, D, eb, bb, hb))
        for b in host])
    print(f"halo pool: {len(host)} batches, E_shard {eb}, boundary {bb}, "
          f"halo {hb}")
    pool = halo_shard(stacked, axis_index("model"), stacked=True).to(device)
    step = make_halo_pool_train_step(
        model, opt, pool, "model",
        graph_loss_fn=None if node_level else loss_fn, node_loss_fn=loss_fn)

    def run(epoch, data_rng):
        return step(pool, data_rng.permutation(len(host)))
    return run


def fit(args, model, opt, loss_fn, splits: dict, spec, device, *,
        node_level: bool, scale: float, log_path: str, on_best=None,
        segment_level: bool = False, batch_transform=None,
        mesh=None) -> dict:
    """Train `model` for `args.epochs` epochs on `splits["train"]` and
    evaluate on "val" / "test" (MAE over nodes when `node_level`, else
    over graphs, times `scale`; over copy rows against `extras['y_seg']`
    with the running statistics when `segment_level`, as the JAX
    `run_zinc_cycle.py` scores its copy models). `batch_transform` (the
    bucketed copy layout) applies to every pooled and stacked batch.
    `mesh` (`make_run_mesh`) trains in `args.mesh`'s parallel mode.
    Reads `args.lr_decay_factor`, `patience`, `epochs`, `seed`,
    `batch_size`, `membership_pools`, `reshuffle_membership`, `bn_eval`
    and, where the driver has them, `compress_pools` and `mesh`. In a
    process group only rank 0
    writes the log and calls `on_best`. `on_best(epoch)` runs after the
    test MAE of each new best epoch. Returns the best val and test MAE
    and one record per epoch (loss, val MAE, test MAE or None, seconds,
    train seconds, steps, the steps' losses). On the card it prints the
    process's peak device memory at the end."""
    sched = PlateauScheduler(factor=args.lr_decay_factor,
                             patience=args.patience)
    run_epoch = _epoch_runner(args, model, opt, loss_fn, splits, spec,
                              device, mesh, node_level, batch_transform)
    refresh_graphs = splits["train"][: 8 * args.batch_size]
    if getattr(args, "compress_pools", False):
        from escgnn_tpu_torch.data.compress import pool_nbytes

        val_stack, eval_decode = stack_split_compressed(
            splits["val"], spec, device, batch_transform)
        test_stack, _ = stack_split_compressed(splits["test"], spec, device,
                                               batch_transform)
        refresh_stack, _ = stack_split_compressed(refresh_graphs, spec,
                                                  device, batch_transform)
        tot = pool_nbytes(val_stack) + pool_nbytes(test_stack)
        print(f"compressed eval stacks: {tot / 2**30:.2f} GB on the device")
    else:
        eval_decode = None
        val_stack = stack_split(splits["val"], spec, device, batch_transform)
        test_stack = stack_split(splits["test"], spec, device,
                                 batch_transform)
        refresh_stack = stack_split(refresh_graphs, spec, device,
                                    batch_transform)
    eval_pool = make_pool_eval_step(
        model, node_level=node_level,
        bn_mode="running" if segment_level else args.bn_eval,
        segment_level=segment_level, decode=eval_decode)
    refresh_pool = make_pool_refresh_step(model, decode=eval_decode)

    def evaluate(stacked):
        e, c = eval_pool(stacked)
        return float(e) / max(float(c), 1.0) * scale

    data_rng = np.random.default_rng(args.seed)
    best_val = best_test = float("inf")
    epochs = []
    for epoch in range(1, args.epochs + 1):
        t_ep = time.time()
        ep_losses = run_epoch(epoch, data_rng)
        loss = float(ep_losses.mean())  # the epoch's one wait
        train_s = time.time() - t_ep
        if args.bn_eval == "running":
            # re-estimate BN running statistics on frozen params
            refresh_pool(refresh_stack)
            if mesh is not None and args.mesh == "dp":
                # ranks on their own train shards (--multihost) refresh
                # from other graphs: every rank evaluates, and steps the
                # scheduler, with the same statistics
                from escgnn_tpu_torch.parallel.data_parallel import (
                    average_bn_stats_,
                )

                average_bn_stats_(model, "data")
        val_mae = evaluate(val_stack)
        lr = get_learning_rate(opt)
        new_lr = sched.step(val_mae, lr)
        if new_lr != lr:
            set_learning_rate(opt, new_lr)
        line = (f"epoch {epoch:03d} lr {lr:.6f} loss {loss:.5f} "
                f"val MAE {val_mae:.5f}")
        test_mae = None
        if val_mae < best_val:
            best_val = val_mae
            best_test = test_mae = evaluate(test_stack)
            line += f" test MAE {best_test:.5f} *"
            if on_best is not None and is_main_rank():
                on_best(epoch)
        seconds = time.time() - t_ep
        line += f" ({seconds:.1f}s)"
        if is_main_rank():
            log_line(log_path, line)
        else:
            print(line, flush=True)
        epochs.append(dict(epoch=epoch, lr=lr, loss=loss, val_mae=val_mae,
                           test_mae=test_mae, seconds=seconds,
                           train_seconds=train_s, steps=len(ep_losses),
                           step_losses=ep_losses.tolist()))
    if device.type == "cuda":
        # what the card must hold for this run (rows sharing one card)
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_reserved(device) / 2**30:.2f} GiB "
              f"reserved, {torch.cuda.max_memory_allocated(device) / 2**30:.2f}"
              f" GiB allocated", flush=True)
    return dict(best_val=best_val, best_test=best_test, epochs=epochs)


def fit_classifier(model, opt, graphs, spec, epochs: int,
                   rng: np.random.Generator, device) -> tuple[list, int]:
    """`epochs` epochs of cross-entropy training on the fixed split
    `graphs`: its batches padded and stacked once on `device`, each epoch
    one pool step over them in the order `rng.permutation` draws (the
    JAX drivers' `materialized_batches` walked in that order). Returns
    the per-epoch mean losses, read once at the end, and the steps per
    epoch."""
    stacked = stack_split(graphs, spec, device)
    steps = pool_size(stacked)
    pool_step = make_pool_train_step(model, opt, ce_graph_loss, stacked)
    means = [pool_step(stacked, rng.permutation(steps)).mean()
             for _ in range(epochs)]
    return (torch.stack(means).tolist() if means else []), steps


def accuracy(acc_step, graphs, spec, device) -> float:
    """Accuracy of `acc_step` (`train.loop.make_accuracy_step`) over
    `graphs`, batch by batch, the counts read once per batch."""
    ok = tot = 0.0
    for b in batch_iterator(graphs, spec, device=device):
        c, t = acc_step(b)
        ok += float(c)
        tot += float(t)
    return ok / max(tot, 1.0)
