"""ZINC per-node cycle-count regression on PyTorch (the twin of the
repository's `run_zinc_cycle.py`):

    python -m escgnn_tpu_torch.run_zinc_cycle [--target 0] [--device cuda]

The ZINC NestedGIN_eff (node/edge type embeddings, ELU) with the graph
pooling removed, lin1/lin2 applied per node, trained with L1 on the
per-node count of 3..6-cycles (`--target` 0..3) of synthetic ZINC
molecules, standardized by the train+val statistics of the raw graphs.
`--model NGNN|I2GNN` runs the copy models with a per-node head: one copy
row per original node, its target in `extras['y_seg']`, on the
`--copy_layout` uniform, bucketed or ragged copy batches. Flags,
defaults, batches and log lines are the JAX driver's.

An epoch is one pool step (`train/loop.py`): on a CUDA device one train
step captured into a CUDA graph and replayed over a device-resident
stacked batch pool. The CPU runs only with `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.counting import count_cycles_per_node
from escgnn_tpu_torch.data.molecules import synthetic_zinc
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.featurize.escgnn import EscConfig
from escgnn_tpu_torch.featurize.transform import featurize_many
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.train.copies import (
    COPY_MODELS,
    copy_layout_spec,
    copy_model,
    featurize_copies,
)
from escgnn_tpu_torch.train.fit import fit
from escgnn_tpu_torch.train.loop import (
    adam_with_plateau,
    l1_node_loss,
    l1_segment_loss,
)
from escgnn_tpu_torch.utils.rundir import start_run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m escgnn_tpu_torch.run_zinc_cycle")
    p.add_argument("--target", type=int, default=0, help="0..3 -> 3..6-cycles")
    p.add_argument("--model", default="NestedGIN_eff",
                   choices=["NestedGIN_eff", "NGNN", "I2GNN", "GNN"],
                   help="NGNN / I2GNN run on the copy transforms with a "
                   "per-node head; GNN raises (not ported)")
    p.add_argument("--h", type=int, default=3)
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--lr_decay_factor", type=float, default=0.5)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_graphs", type=int, default=1000)
    p.add_argument("--copy_layout", default="uniform",
                   choices=["ragged", "uniform", "bucketed"],
                   help="NGNN/I2GNN batch layout: uniform per-copy "
                   "blocks, two-size bucketed blocks, or the ragged union")
    p.add_argument("--num_workers", type=int, default=2,
                   help="featurizer processes (forked; each sets one "
                   "OpenMP thread)")
    p.add_argument("--res_dir", default=None)
    p.add_argument("--membership_pools", type=int, default=4,
                   help="membership-shuffled train batch pools on the card, "
                   "cycled across epochs")
    p.add_argument("--reshuffle_membership", action="store_true",
                   help="re-form train batches every epoch (prefetched, "
                   "eager steps)")
    p.add_argument("--bn_eval", default="running",
                   choices=["batch", "running"],
                   help="eval-time BN statistics (see train.loop.eval_step)")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs only when named")
    return p


def check_ported(args) -> None:
    """Raise NotImplementedError, naming its ROADMAP queue, for a flag
    whose module the port does not have yet."""
    if args.model == "GNN":
        raise NotImplementedError(
            "--model GNN: models/baselines.py is ROADMAP queue 8.7")


def build_splits(args) -> tuple[dict, float, float]:
    """The featurized 80/10/10 splits with standardized per-node targets,
    and the target's mean and std (train+val of the raw graphs, ddof 1).
    The copy models' targets ride in `extras['y_seg']`, one row per copy
    (original node), with `y` cleared."""
    raw = synthetic_zinc(num_graphs=args.num_graphs, seed=args.seed)
    for g in raw:
        g.y = count_cycles_per_node(g.num_nodes, g.edge_index).astype(
            np.float32)
    n_tr, n_val = int(0.8 * len(raw)), int(0.1 * len(raw))
    ys = np.concatenate([g.y[:, args.target] for g in raw[: n_tr + n_val]])
    mean, std = float(ys.mean()), float(ys.std(ddof=1))
    std = max(std, 1e-8)
    for g in raw:
        g.y = ((g.y[:, args.target] - mean) / std)[:, None].astype(np.float32)
    if args.model in COPY_MODELS:
        feats = featurize_copies(raw, args.model, args.h)
        for g, r in zip(feats, raw):
            g.extras["y_seg"] = np.asarray(r.y, np.float32)
            g.y = None
    else:
        ecfg = EscConfig(h=args.h, use_rd=True, self_loop=True)
        feats = featurize_many(raw, ecfg, num_workers=args.num_workers)
    splits = {
        "train": feats[:n_tr],
        "val": feats[n_tr:n_tr + n_val],
        "test": feats[n_tr + n_val:],
    }
    return splits, mean, std


def model_config(args) -> NestedGINEffConfig:
    return NestedGINEffConfig(
        hidden=args.hidden, num_layers=args.layers, dropout=0.0, act="elu",
        graph_pred=False, use_x_embedding_jk=False, head_order="dropout_act",
        node_embed_vocab=100, edge_embed_vocab=100, out_dim=1,
    )


def build_model(args, device):
    """The twin's model, its weights drawn from `args.seed`."""
    gen = torch.Generator().manual_seed(args.seed)
    if args.model in COPY_MODELS:
        return copy_model(args.model, args, device, gen, node_level=True)
    return NestedGINEff(model_config(args), device=device, generator=gen)


def loss_fn(args):
    """L1 over the per-node rows: the copy rows against `y_seg` for the
    copy models."""
    return l1_segment_loss if args.model in COPY_MODELS else l1_node_loss


def main(argv=None) -> dict:
    """Train and evaluate; returns the run's numbers (best val/test MAE
    and one record per epoch) for callers such as the smoke run."""
    args = build_parser().parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    res_dir = start_run(args, "escgnn_tpu_torch.run_zinc_cycle", "zinc_cycle",
                        __file__, argv)
    t0 = time.time()
    splits, mean, std = build_splits(args)
    data_seconds = time.time() - t0
    print(f"data: {data_seconds:.1f}s mean={mean:.3f} std={std:.3f}")

    batch_transform = None  # set by --copy_layout bucketed
    seg_level = args.model in COPY_MODELS
    if seg_level:
        splits, spec, batch_transform = copy_layout_spec(
            splits, args.batch_size, args.copy_layout,
            args.reshuffle_membership)
    else:
        # uniform per-graph blocks + deduplicated ESC rows, the flagship
        # layout
        all_graphs = [g for s in splits.values() for g in s]
        spec = BatchSpec.uniform(all_graphs, args.batch_size,
                                 enc_layout="dedup")
    print("spec:", spec)

    model = build_model(args, device)
    opt = adam_with_plateau(model.parameters(), args.lr,
                            grad_clip=args.grad_clip,
                            capturable=device.type == "cuda")
    res = fit(args, model, opt, loss_fn(args), splits, spec, device,
              node_level=True, scale=std,
              log_path=os.path.join(res_dir, "log.txt"),
              segment_level=seg_level, batch_transform=batch_transform)
    print(f"best val {res['best_val']:.5f} test {res['best_test']:.5f}")
    return dict(res, mean=mean, std=std, res_dir=res_dir, spec=spec,
                data_seconds=data_seconds, batch_transform=batch_transform)


if __name__ == "__main__":
    main()
