"""The twins' epoch loops.

`fit`: the regression loop, which the JAX drivers `run_zinc.py`,
`run_zinc_cycle.py`, `run_qm9.py` and `run_graphcount.py` each write
out. Per epoch: one pool step over a device-resident train pool (pool
`(epoch - 1) % k` of `stacked_batch_pools`, its batches in an order drawn
from `np.random.default_rng(seed)`), or with `--reshuffle_membership`
eager steps over batches re-formed by the prefetch thread; the exact BN
refresh under `--bn_eval running`; val MAE; the plateau scheduler; test
MAE at each new best val MAE; one log line in the JAX drivers' format.

`fit_classifier` and `accuracy`: the classification loop of `run_csl.py`
and `run_exp.py` (a fixed train split, its batches in a fresh order each
epoch, no scheduler) and their accuracy eval.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from escgnn_tpu_torch.data.prefetch import (
    pool_size,
    prefetched_batches,
    stack_split,
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
from escgnn_tpu_torch.utils.rundir import log_line

POOL_BYTES = 4 * 2**30  # the stacked train pools' budget on the card


def fit(args, model, opt, loss_fn, splits: dict, spec, device, *,
        node_level: bool, scale: float, log_path: str, on_best=None,
        segment_level: bool = False, batch_transform=None) -> dict:
    """Train `model` for `args.epochs` epochs on `splits["train"]` and
    evaluate on "val" / "test" (MAE over nodes when `node_level`, else
    over graphs, times `scale`; over copy rows against `extras['y_seg']`
    with the running statistics when `segment_level`, as the JAX
    `run_zinc_cycle.py` scores its copy models). `batch_transform` (the
    bucketed copy layout) applies to every pooled and stacked batch.
    Reads `args.lr_decay_factor`,
    `patience`, `epochs`, `seed`, `batch_size`, `membership_pools`,
    `reshuffle_membership` and `bn_eval`. `on_best(epoch)` runs after the
    test MAE of each new best epoch. Returns the best val and test MAE
    and one record per epoch (loss, val MAE, test MAE or None, seconds,
    train seconds, steps)."""
    sched = PlateauScheduler(factor=args.lr_decay_factor,
                             patience=args.patience)
    if not args.reshuffle_membership:
        pools, num_train_batches = stacked_batch_pools(
            splits["train"], spec, k=args.membership_pools, seed=args.seed,
            max_total_bytes=POOL_BYTES, device=device,
            batch_transform=batch_transform)
        pool_train_step = make_pool_train_step(model, opt, loss_fn, pools[0])
    val_stack = stack_split(splits["val"], spec, device, batch_transform)
    test_stack = stack_split(splits["test"], spec, device, batch_transform)
    refresh_stack = stack_split(splits["train"][: 8 * args.batch_size], spec,
                                device, batch_transform)
    eval_pool = make_pool_eval_step(
        model, node_level=node_level,
        bn_mode="running" if segment_level else args.bn_eval,
        segment_level=segment_level)
    refresh_pool = make_pool_refresh_step(model)

    def evaluate(stacked):
        e, c = eval_pool(stacked)
        return float(e) / max(float(c), 1.0) * scale

    data_rng = np.random.default_rng(args.seed)
    best_val = best_test = float("inf")
    epochs = []
    for epoch in range(1, args.epochs + 1):
        t_ep = time.time()
        if args.reshuffle_membership:
            ep_losses = torch.stack([
                train_step(model, opt, b, loss_fn)
                for b in prefetched_batches(splits["train"], spec,
                                            shuffle=True, rng=data_rng,
                                            device=device)])
        else:
            pool = pools[(epoch - 1) % len(pools)]
            ep_losses = pool_train_step(
                pool, data_rng.permutation(num_train_batches))
        loss = float(ep_losses.mean())  # the epoch's one wait
        train_s = time.time() - t_ep
        if args.bn_eval == "running":
            # re-estimate BN running statistics on frozen params
            refresh_pool(refresh_stack)
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
            if on_best is not None:
                on_best(epoch)
        seconds = time.time() - t_ep
        line += f" ({seconds:.1f}s)"
        log_line(log_path, line)
        epochs.append(dict(epoch=epoch, lr=lr, loss=loss, val_mae=val_mae,
                           test_mae=test_mae, seconds=seconds,
                           train_seconds=train_s, steps=len(ep_losses)))
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
