"""EXP / CEXP expressiveness benchmark on PyTorch (the twin of the
repository's `run_exp.py`):

    python -m escgnn_tpu_torch.run_exp [--dataset EXP] [--device cuda]

Binary classification of 1-WL-equivalent planar-SAT graph pairs
(`data/EXP/raw/`) over sequential splits, with the reference's extra
"expressivity" and "learning" test subsets: every other pair of the
test block by index ((i // 2) % 2), pairs being adjacent in the list.
Each split trains a fresh model (weights drawn from `seed + split`) on
the width layout with cross-entropy; each epoch is one pool step over
the split's train batches, stacked once on the device, in the JAX
driver's order (on a CUDA device one CUDA-graphed train step, captured
once per split). Flags and printed lines are the JAX driver's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from escgnn_tpu_torch.data.batching import BatchSpec, batch_iterator
from escgnn_tpu_torch.data.planar_sat import load_planar_sat
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.featurize.escgnn import EscConfig
from escgnn_tpu_torch.featurize.transform import featurize_many
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.train.fit import accuracy, fit_classifier
from escgnn_tpu_torch.train.loop import (
    adam_with_plateau,
    make_accuracy_step,
    make_pergraph_correct_step,
)

# the JAX driver's featurizer processes (it has no flag for them)
FEATURIZE_WORKERS = 2


def accuracy_vote(vote_step, graphs, spec, nb_trials: int, device) -> float:
    """Majority-vote eval (reference `run_exp.py:255-265`): per-graph
    success counts over `nb_trials` forward passes, correct when
    > nb_trials // 2. One trial (the reference default) is plain
    accuracy."""
    ok = tot = 0.0
    for b in batch_iterator(graphs, spec, device=device):
        succ = None
        for _ in range(nb_trials):
            correct, mask = vote_step(b)
            c = correct.cpu().numpy().astype(np.int32)
            succ = c if succ is None else succ + c
        mask = mask.cpu().numpy()
        voted = (succ > nb_trials // 2) & mask
        ok += float(voted.sum())
        tot += float(mask.sum())
    return ok / max(tot, 1.0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m escgnn_tpu_torch.run_exp")
    p.add_argument("--dataset", default="EXP", choices=["EXP", "CEXP"])
    p.add_argument("--h", type=int, default=3)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--splits", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_graphs", type=int, default=None)
    p.add_argument("--nb_trials", type=int, default=1,
                   help="majority-vote eval trials (reference "
                   "run_exp.py:257 'Support majority vote, but single "
                   "trial is default')")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs only when named")
    return p


def model_config(args) -> NestedGINEffConfig:
    return NestedGINEffConfig(
        hidden=args.hidden, num_layers=args.layers, graph_pred=True,
        pool="add", use_x_embedding_jk=False,
        node_embed_vocab=8,  # EXP x is a small category id
        out_dim=2,
    )


def run_split(args, feats, si: int, spec, device) -> dict:
    """Train a fresh model with test block `si` held out: {"accs" (test,
    expressivity, learning), "losses" (per epoch), "steps"}."""
    n = len(feats)
    lo, hi = si * n // args.splits, (si + 1) * n // args.splits
    test = feats[lo:hi]
    train = feats[:lo] + feats[hi:]
    if not train:
        raise ValueError("--splits 1 leaves an empty train set (test = the "
                         "whole dataset); use >= 2 splits")
    expr = [g for i, g in enumerate(test) if (i // 2) % 2 == 0]
    learn = [g for i, g in enumerate(test) if (i // 2) % 2 == 1]
    model = NestedGINEff(model_config(args), device=device,
                         generator=torch.Generator().manual_seed(
                             args.seed + si))
    opt = adam_with_plateau(model.parameters(), args.lr,
                            capturable=device.type == "cuda")
    losses, steps = fit_classifier(
        model, opt, train, spec, args.epochs,
        np.random.default_rng(args.seed + si), device)
    if args.nb_trials > 1:
        vote_step = make_pergraph_correct_step(model)

        def acc_fn(graphs):
            return accuracy_vote(vote_step, graphs, spec, args.nb_trials,
                                 device)
    else:
        acc_step = make_accuracy_step(model)

        def acc_fn(graphs):
            return accuracy(acc_step, graphs, spec, device)
    return dict(accs=(acc_fn(test), acc_fn(expr), acc_fn(learn)),
                losses=losses, steps=steps)


def main(argv=None) -> dict:
    """Train and test over the sequential splits; returns the per-split
    results and the mean test, expressivity and learning accuracy."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    raw = load_planar_sat(args.dataset)
    if args.max_graphs:
        raw = raw[: args.max_graphs]
    ecfg = EscConfig(h=args.h, use_rd=True, self_loop=True)
    t0 = time.time()
    feats = featurize_many(raw, ecfg, num_workers=FEATURIZE_WORKERS)
    print(f"featurize {len(feats)} graphs: {time.time() - t0:.1f}s")
    spec = BatchSpec.from_graphs(feats, batch_size=args.batch_size)
    print("spec:", spec)

    results = []
    for si in range(args.splits):
        results.append(run_split(args, feats, si, spec, device))
        accs = results[-1]["accs"]
        print(f"split {si}: test {accs[0]:.3f} expressivity {accs[1]:.3f} "
              f"learning {accs[2]:.3f}")
    r = np.asarray([res["accs"] for res in results])
    print(f"{args.dataset}: test {r[:, 0].mean():.4f} "
          f"expressivity {r[:, 1].mean():.4f} learning {r[:, 2].mean():.4f}")
    return dict(splits=results, test=float(r[:, 0].mean()),
                expressivity=float(r[:, 1].mean()),
                learning=float(r[:, 2].mean()), spec=spec, feats=feats)


if __name__ == "__main__":
    main()
