"""CSL 10-class isomorphism benchmark on PyTorch (the twin of the
repository's `run_csl.py`):

    python -m escgnn_tpu_torch.run_csl [--folds 10] [--device cuda]

NestedGIN_eff classifies Circular Skip Link graphs into their 10 skip
lengths under stratified k-fold cross-validation: 1-WL models score 10%
(chance), the ESC structural encoding should reach ~100%. Each fold
trains a fresh model (weights drawn from `seed + fold`) on the width
layout with cross-entropy; each epoch is one pool step over the fold's
train batches, stacked once on the device, in the JAX driver's order (on
a CUDA device one CUDA-graphed train step, captured once per fold). Flags
and printed lines are the JAX driver's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.csl import generate_csl
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.featurize.escgnn import EscConfig
from escgnn_tpu_torch.featurize.transform import featurize_many
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.train.fit import accuracy, fit_classifier
from escgnn_tpu_torch.train.loop import adam_with_plateau, make_accuracy_step

# the JAX driver's featurizer processes (it has no flag for them)
FEATURIZE_WORKERS = 2


def k_fold_indices(labels: np.ndarray, k: int, seed: int):
    """Stratified k folds (reference `run_csl.py` uses sklearn's
    StratifiedKFold; same contract)."""
    rng = np.random.default_rng(seed)
    folds = [[] for _ in range(k)]
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        for i, g in enumerate(idx):
            folds[i % k].append(g)
    return [np.asarray(f) for f in folds]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m escgnn_tpu_torch.run_csl")
    p.add_argument("--h", type=int, default=3)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--folds", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs only when named")
    return p


def build_data(args):
    """(featurized graphs, labels, width-layout spec)."""
    raw = generate_csl(seed=args.seed)
    labels = np.asarray([int(g.y[0]) for g in raw])
    ecfg = EscConfig(h=args.h, use_rd=True, self_loop=True)
    t0 = time.time()
    feats = featurize_many(raw, ecfg, num_workers=FEATURIZE_WORKERS)
    print(f"featurize: {time.time() - t0:.1f}s")
    return feats, labels, BatchSpec.from_graphs(feats,
                                                batch_size=args.batch_size)


def model_config(args) -> NestedGINEffConfig:
    return NestedGINEffConfig(
        hidden=args.hidden, num_layers=args.layers, graph_pred=True,
        pool="add", use_x_embedding_jk=False, out_dim=10,
    )


def run_fold(args, feats, folds, fi: int, spec, device) -> dict:
    """Train a fresh model on every fold but `fi` and test it on fold
    `fi`: {"acc", "losses" (per epoch), "steps" (per epoch)}."""
    train_idx = np.concatenate(
        [folds[j] for j in range(len(folds)) if j != fi])
    train = [feats[i] for i in train_idx]
    test = [feats[i] for i in folds[fi]]
    model = NestedGINEff(model_config(args), device=device,
                         generator=torch.Generator().manual_seed(
                             args.seed + fi))
    opt = adam_with_plateau(model.parameters(), args.lr,
                            capturable=device.type == "cuda")
    losses, steps = fit_classifier(
        model, opt, train, spec, args.epochs,
        np.random.default_rng(args.seed + fi), device)
    acc = accuracy(make_accuracy_step(model), test, spec, device)
    return dict(acc=acc, losses=losses, steps=steps)


def main(argv=None) -> dict:
    """Cross-validate; returns the per-fold results and the mean and std
    of the accuracy."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    feats, labels, spec = build_data(args)
    folds = k_fold_indices(labels, args.folds, args.seed)
    results = []
    for fi in range(args.folds):
        results.append(run_fold(args, feats, folds, fi, spec, device))
        print(f"fold {fi}: acc {results[-1]['acc']:.3f}")
    accs = [r["acc"] for r in results]
    print(f"CSL {args.folds}-fold acc: {np.mean(accs):.4f} +- "
          f"{np.std(accs):.4f}")
    return dict(folds=results, mean=float(np.mean(accs)),
                std=float(np.std(accs)), spec=spec)


if __name__ == "__main__":
    main()
