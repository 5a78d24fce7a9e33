"""ZINC graph-regression driver on PyTorch (the twin of the repository's
`run_zinc.py`):

    python -m escgnn_tpu_torch.run_zinc [--epochs 100] [--device cuda]

NestedGIN_eff with node/edge type embeddings (or the copy models NGNN
and I2GNN with `--model`, on `--copy_layout` uniform, bucketed or ragged
copy batches, or `--model GNN`, the plain RGCN baseline on the ragged
width batches of the ESC-featurized graphs, as the JAX driver builds
them), L1 loss on mean/std normalized targets, Adam with a
plateau learning rate, MAE x std reporting. It reads the real ZINC
subset when its pickle is under --data_dir, else trains on deterministic
synthetic molecules. Flags, defaults, cache keys, batches and log lines
are the JAX driver's.

An epoch is one pool step (`train/loop.py`): on a CUDA device one train
step captured into a CUDA graph and replayed over a device-resident
stacked batch pool, in an order drawn from the run's seed. The CPU runs
only with `--device cpu`; without a card the default raises.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.molecules import zinc_splits
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.featurize.cache import cached_featurize
from escgnn_tpu_torch.featurize.escgnn import EscConfig
from escgnn_tpu_torch.featurize.transform import featurize_many
from escgnn_tpu_torch.models.baselines import RGCNBaseline, RGCNBaselineConfig
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.train.copies import (
    COPY_MODELS,
    cache_tag,
    copy_layout_spec,
    copy_model,
    featurize_copies,
)
from escgnn_tpu_torch.train.fit import fit
from escgnn_tpu_torch.train.loop import adam_with_plateau, l1_graph_loss
from escgnn_tpu_torch.utils.rundir import start_run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m escgnn_tpu_torch.run_zinc")
    p.add_argument("--h", type=int, default=3)
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--lr_decay_factor", type=float, default=0.5)
    p.add_argument("--model", default="NestedGIN_eff",
                   choices=["NestedGIN_eff", "NGNN", "I2GNN", "GNN"],
                   help="NGNN / I2GNN run on the copy transforms instead "
                   "of the ESC encoding; GNN is the plain RGCN baseline")
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_graphs", type=int, default=2000)
    p.add_argument("--copy_layout", default="uniform",
                   choices=["ragged", "uniform", "bucketed"],
                   help="NGNN/I2GNN batch layout: uniform per-copy "
                   "blocks, two-size bucketed blocks, or the ragged union")
    p.add_argument("--num_workers", type=int, default=2,
                   help="featurizer processes (forked; each sets one "
                   "OpenMP thread)")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--res_dir", default=None)
    p.add_argument("--membership_pools", type=int, default=4,
                   help="membership-shuffled train batch pools on the card, "
                   "cycled across epochs")
    p.add_argument("--compress_pools", action="store_true",
                   help="losslessly downcast pools (raises: not ported)")
    p.add_argument("--reshuffle_membership", action="store_true",
                   help="re-form train batches every epoch (prefetched, "
                   "eager steps)")
    p.add_argument("--bn_eval", default="running",
                   choices=["batch", "running"],
                   help="eval-time BN statistics (see train.loop.eval_step)")
    p.add_argument("--mesh", default="none",
                   choices=["none", "dp", "ep", "halo", "dp_ep"],
                   help="multi-device modes (raise: not ported)")
    p.add_argument("--mesh_devices", type=int, default=0)
    p.add_argument("--mesh_dp", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs only when named")
    return p


def check_ported(args) -> None:
    """Raise NotImplementedError, naming its ROADMAP queue, for a flag
    whose module the port does not have yet."""
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the parallel modes are ROADMAP queue 10")
    if args.compress_pools:
        raise NotImplementedError(
            "--compress_pools: data/compress.py is ROADMAP queue 9")


def zinc_model_config(args) -> NestedGINEffConfig:
    return NestedGINEffConfig(
        hidden=args.hidden, num_layers=args.layers, dropout=0.0, act="elu",
        graph_pred=True, pool="add", use_x_embedding_jk=False,
        head_order="dropout_act", node_embed_vocab=100, edge_embed_vocab=100,
        out_dim=1,
    )


def build_model(args, device):
    """The twin's model, its weights drawn from `args.seed`."""
    gen = torch.Generator().manual_seed(args.seed)
    if args.model in COPY_MODELS:
        return copy_model(args.model, args, device, gen)
    if args.model == "GNN":
        return RGCNBaseline(RGCNBaselineConfig(num_layers=args.layers),
                            device=device, generator=gen)
    return NestedGINEff(zinc_model_config(args), device=device,
                        generator=gen)


def main(argv=None) -> dict:
    """Train and evaluate; returns the run's numbers (best val/test MAE
    and one record per epoch) for callers such as the smoke run."""
    args = build_parser().parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    res_dir = start_run(args, "escgnn_tpu_torch.run_zinc", "zinc", __file__,
                        argv)

    t0 = time.time()
    raw_splits, is_real = zinc_splits(args.data_dir,
                                      num_graphs=args.num_graphs,
                                      seed=args.seed)
    print("dataset:", "ZINC (real artifact)" if is_real else "ZINC (synthetic)")
    if args.model in COPY_MODELS:
        key_tag = cache_tag(args.model, args.h)

        def transform(graphs):
            return featurize_copies(graphs, args.model, args.h)
    else:
        ecfg = EscConfig(h=args.h, use_rd=True, self_loop=True)
        key_tag = ecfg.cache_key()

        def transform(graphs):
            return featurize_many(graphs, ecfg, num_workers=args.num_workers)
    splits = {}
    t_feat = time.time()
    for name, graphs in raw_splits.items():
        splits[name] = cached_featurize(
            os.path.join(args.data_dir, "zinc_real" if is_real
                         else "zinc_synth"),
            (f"{name}_{key_tag}" if is_real else
             f"{name}_n{args.num_graphs}_s{args.seed}_{key_tag}"),
            lambda graphs=graphs: transform(graphs),
        )
    featurize_seconds = time.time() - t_feat
    # normalize targets by train+val statistics (reference run_zinc.py)
    ys = np.concatenate([g.y for s in ("train", "val") for g in splits[s]])
    mean, std = float(ys.mean()), float(ys.std(ddof=1))
    for s in splits.values():
        for g in s:
            g.y = ((g.y - mean) / std).astype(np.float32)
    data_seconds = time.time() - t0
    print(f"data: {data_seconds:.1f}s mean={mean:.3f} std={std:.3f}")

    batch_transform = None  # set by --copy_layout bucketed
    if args.model in COPY_MODELS:
        splits, spec, batch_transform = copy_layout_spec(
            splits, args.batch_size, args.copy_layout,
            args.reshuffle_membership)
    elif args.model == "GNN":
        # the ragged union with the width encoding (the RGCN reads none
        # of it; the JAX driver batches it all the same)
        spec = BatchSpec.from_graphs(
            [g for s in splits.values() for g in s], args.batch_size)
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
    res = fit(args, model, opt, l1_graph_loss, splits, spec, device,
              node_level=False, scale=std,
              log_path=os.path.join(res_dir, "log.txt"),
              batch_transform=batch_transform)
    print(f"best val {res['best_val']:.5f} test {res['best_test']:.5f}")
    return dict(res, mean=mean, std=std, res_dir=res_dir, spec=spec,
                data_seconds=data_seconds, featurize_seconds=featurize_seconds,
                batch_transform=batch_transform)


if __name__ == "__main__":
    main()
