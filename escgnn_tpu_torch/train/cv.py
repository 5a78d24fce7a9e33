"""k-fold cross-validation for TU-style graph classification (counterpart
of `escgnn_tpu/train/cv.py`).

  * `k_fold`: the JAX package's stratified k-fold (a seeded per-class
    shuffle, then round-robin fold ids; val fold i = test fold i - 1),
    the same indices from the same seed.
  * `cross_validation_with_val_set`: per fold a model with fresh weights
    (`fold_model`, drawn from `torch.Generator().manual_seed(seed +
    fold)`, as JAX inits each fold from `jax.random.key(seed + fold)`)
    and a fresh Adam with coupled L2 weight decay; the learning rate
    times `lr_decay_factor` every `lr_decay_step_size` epochs; the val
    loss and test accuracy of every epoch. The result is the test
    accuracy at each fold's best-val-loss epoch, mean and std over folds.

An epoch is one pool step over the fold's train split stacked on the
device, its batches in an order drawn from `np.random.default_rng(seed +
fold)` (JAX: one jitted step per batch, in the same order); on a CUDA
device a train step captured into a CUDA graph and replayed. The val
loss and test accuracy run eagerly with the running BatchNorm
statistics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.data.prefetch import pool_entry, pool_size, stack_split
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.train.loop import (
    adam_with_plateau,
    ce_graph_loss,
    make_accuracy_step,
    make_pool_train_step,
    running_statistics,
    set_learning_rate,
)


def k_fold(
    labels: np.ndarray, folds: int, seed: int = 12345
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Stratified k-fold; returns [(train_idx, test_idx, val_idx)] with
    val fold i = test fold i-1 (reference `kernel/train_eval.py:225-240`)."""
    labels = np.asarray(labels).reshape(-1)
    rng = np.random.default_rng(seed)
    fold_of = np.empty(len(labels), np.int64)
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        fold_of[idx] = np.arange(len(idx)) % folds
    splits = []
    for i in range(folds):
        test = np.flatnonzero(fold_of == i)
        val = np.flatnonzero(fold_of == (i - 1) % folds)
        train = np.flatnonzero((fold_of != i) & (fold_of != (i - 1) % folds))
        splits.append((train, test, val))
    return splits


@dataclasses.dataclass
class CVResult:
    """JAX's four numbers, and each fold's per-epoch val loss and test
    accuracy (folds x epochs)."""

    val_loss: float
    test_acc_mean: float
    test_acc_std: float
    durations: list
    val_losses: Optional[np.ndarray] = None
    test_accs: Optional[np.ndarray] = None


def fold_model(model_factory: Callable[[torch.Generator], torch.nn.Module],
               seed: int) -> torch.nn.Module:
    """A fold's model with fresh weights: `model_factory(generator)`, the
    generator seeded with the fold's `seed`."""
    return model_factory(torch.Generator().manual_seed(seed))


@torch.no_grad()
def _val_loss(model, stacked) -> tuple[float, float]:
    """(sum of the per-graph CE, real graphs) over a stacked split, with
    the running statistics."""
    sums, counts = [], []
    with running_statistics(model):
        for i in range(pool_size(stacked)):
            b = pool_entry(stacked, i)
            n = b.graph_mask.sum()
            sums.append(ce_graph_loss(model(b), b) * n)
            counts.append(n)
    sums = torch.stack(sums).double().cpu().numpy()
    counts = torch.stack(counts).double().cpu().numpy()
    return float(sums.sum()), float(counts.sum())


def _test_acc(acc_step, stacked) -> float:
    hits = [acc_step(pool_entry(stacked, i))
            for i in range(pool_size(stacked))]
    c = float(torch.stack([h[0] for h in hits]).sum())
    m = float(torch.stack([h[1] for h in hits]).sum())
    return c / max(m, 1.0)


def cross_validation_with_val_set(
    graphs: Sequence[GraphData],
    model_factory: Callable[[torch.Generator], torch.nn.Module],
    *,
    folds: int = 10,
    epochs: int = 100,
    batch_size: int = 128,
    lr: float = 1e-2,
    lr_decay_factor: float = 0.5,
    lr_decay_step_size: int = 50,
    weight_decay: float = 0.0,
    seed: int = 0,
    logger: Optional[Callable[[str], None]] = None,
    device="cuda",
) -> CVResult:
    """Stratified k-fold CV with the val split the previous test fold.
    `model_factory(generator)` builds a model on `device` whose weights
    it draws from `generator`."""
    if folds < 3:
        raise ValueError(
            f"folds={folds}: the val split is the previous test fold "
            "(reference kernel/train_eval.py k_fold), so at least 3 "
            "folds are needed for a non-empty train split"
        )
    device = resolve_device(device)
    labels = np.asarray([int(np.asarray(g.y).reshape(-1)[0]) for g in graphs])
    spec = BatchSpec.from_graphs(list(graphs), batch_size=batch_size)

    all_val, all_acc, durations = [], [], []
    for fold, (tr, te, va) in enumerate(k_fold(labels, folds)):
        t0 = time.perf_counter()
        model = fold_model(model_factory, seed + fold)
        opt = adam_with_plateau(model.parameters(), lr,
                                capturable=device.type == "cuda",
                                weight_decay=weight_decay)
        train = stack_split([graphs[i] for i in tr], spec, device)
        val = stack_split([graphs[i] for i in va], spec, device)
        test = stack_split([graphs[i] for i in te], spec, device)
        pool_step = make_pool_train_step(model, opt, ce_graph_loss, train)
        acc_step = make_accuracy_step(model)
        np_rng = np.random.default_rng(seed + fold)
        cur_val, cur_acc = [], []
        cur_lr = lr
        for epoch in range(1, epochs + 1):
            pool_step(train, np_rng.permutation(pool_size(train)))
            tot, cnt = _val_loss(model, val)
            cur_val.append(tot / max(cnt, 1.0))
            cur_acc.append(_test_acc(acc_step, test))
            if epoch % lr_decay_step_size == 0:
                cur_lr *= lr_decay_factor
                set_learning_rate(opt, cur_lr)
        all_val.append(cur_val)
        all_acc.append(cur_acc)
        durations.append(time.perf_counter() - t0)
        best = int(np.argmin(cur_val))
        if logger:
            logger(f"Fold {fold}: best val_loss {cur_val[best]:.4f}, "
                   f"test_acc {cur_acc[best]:.4f}")

    val = np.asarray(all_val)  # (folds, epochs)
    acc = np.asarray(all_acc)
    accs = acc[np.arange(folds), np.argmin(val, axis=1)]
    return CVResult(
        val_loss=float(val.min(axis=1).mean()),
        test_acc_mean=float(accs.mean()),
        test_acc_std=float(accs.std()),
        durations=durations,
        val_losses=val,
        test_accs=acc,
    )
