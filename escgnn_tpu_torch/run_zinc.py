"""ZINC graph-regression driver on PyTorch (the twin of the repository's
`run_zinc.py`):

    python -m escgnn_tpu_torch.run_zinc [--epochs 100] [--device cuda]

NestedGIN_eff with node/edge type embeddings, L1 loss on mean/std
normalized targets, Adam with a plateau learning rate, MAE x std
reporting. It reads the real ZINC subset when its pickle is under
--data_dir, else trains on deterministic synthetic molecules. Flags,
defaults, cache keys, batches and log lines are the JAX driver's.

An epoch is one pool step (`train/loop.py`): on a CUDA device one train
step captured into a CUDA graph and replayed over a device-resident
stacked batch pool, in an order drawn from the run's seed. The CPU runs
only with `--device cpu`; without a card the default raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.molecules import zinc_splits
from escgnn_tpu_torch.data.prefetch import (
    prefetched_batches,
    stack_split,
    stacked_batch_pools,
)
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.featurize.cache import cached_featurize
from escgnn_tpu_torch.featurize.escgnn import EscConfig
from escgnn_tpu_torch.featurize.transform import featurize_many
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.train.loop import (
    PlateauScheduler,
    adam_with_plateau,
    get_learning_rate,
    l1_graph_loss,
    make_pool_eval_step,
    make_pool_refresh_step,
    make_pool_train_step,
    set_learning_rate,
    train_step,
)
from escgnn_tpu_torch.utils.rundir import backup_run

POOL_BYTES = 4 * 2**30  # the stacked train pools' budget on the card


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
                   help="only NestedGIN_eff is ported; the others raise")
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_graphs", type=int, default=2000)
    p.add_argument("--copy_layout", default="uniform",
                   choices=["ragged", "uniform", "bucketed"],
                   help="NGNN/I2GNN batch layout (bucketed raises)")
    p.add_argument("--num_workers", type=int, default=2,
                   help="featurizer processes (spawned)")
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
    if args.model in ("NGNN", "I2GNN"):
        raise NotImplementedError(
            f"--model {args.model}: the copy family is ROADMAP queue 8.4")
    if args.model == "GNN":
        raise NotImplementedError(
            "--model GNN: models/baselines.py is ROADMAP queue 8.7")
    if args.copy_layout == "bucketed":
        raise NotImplementedError(
            "--copy_layout bucketed: data/uniform_copies.py is ROADMAP "
            "queue 8.4")
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


def _log(res_dir: str, line: str) -> None:
    print(line, flush=True)
    with open(os.path.join(res_dir, "log.txt"), "a") as f:
        f.write(line + "\n")


def main(argv=None) -> dict:
    """Train and evaluate; returns the run's numbers (best val/test MAE
    and one record per epoch) for callers such as the smoke run."""
    args = build_parser().parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    res_dir = args.res_dir or os.path.join(
        "results", "zinc_" + time.strftime("%Y%m%d%H%M%S"))
    os.makedirs(res_dir, exist_ok=True)
    with open(os.path.join(res_dir, "config.json"), "w") as f:
        json.dump(vars(args), f, indent=2)
    backup_run(res_dir, os.path.abspath(__file__), argv=[
        "-m", "escgnn_tpu_torch.run_zinc",
        *(sys.argv[1:] if argv is None else argv)])

    t0 = time.time()
    raw_splits, is_real = zinc_splits(args.data_dir,
                                      num_graphs=args.num_graphs,
                                      seed=args.seed)
    print("dataset:", "ZINC (real artifact)" if is_real else "ZINC (synthetic)")
    ecfg = EscConfig(h=args.h, use_rd=True, self_loop=True)
    key_tag = ecfg.cache_key()
    splits = {}
    for name, graphs in raw_splits.items():
        splits[name] = cached_featurize(
            os.path.join(args.data_dir, "zinc_real" if is_real
                         else "zinc_synth"),
            (f"{name}_{key_tag}" if is_real else
             f"{name}_n{args.num_graphs}_s{args.seed}_{key_tag}"),
            lambda graphs=graphs: featurize_many(
                graphs, ecfg, num_workers=args.num_workers),
        )
    # normalize targets by train+val statistics (reference run_zinc.py)
    ys = np.concatenate([g.y for s in ("train", "val") for g in splits[s]])
    mean, std = float(ys.mean()), float(ys.std(ddof=1))
    for s in splits.values():
        for g in s:
            g.y = ((g.y - mean) / std).astype(np.float32)
    data_seconds = time.time() - t0
    print(f"data: {data_seconds:.1f}s mean={mean:.3f} std={std:.3f}")

    all_graphs = [g for s in splits.values() for g in s]
    # uniform per-graph blocks + deduplicated ESC rows, the flagship layout
    spec = BatchSpec.uniform(all_graphs, args.batch_size, enc_layout="dedup")
    print("spec:", spec)

    model = NestedGINEff(zinc_model_config(args), device=device,
                         generator=torch.Generator().manual_seed(args.seed))
    opt = adam_with_plateau(model.parameters(), args.lr,
                            grad_clip=args.grad_clip,
                            capturable=device.type == "cuda")
    sched = PlateauScheduler(factor=args.lr_decay_factor,
                             patience=args.patience)
    if not args.reshuffle_membership:
        pools, num_train_batches = stacked_batch_pools(
            splits["train"], spec, k=args.membership_pools, seed=args.seed,
            max_total_bytes=POOL_BYTES, device=device)
        pool_train_step = make_pool_train_step(model, opt, l1_graph_loss,
                                               pools[0])
    val_stack = stack_split(splits["val"], spec, device)
    test_stack = stack_split(splits["test"], spec, device)
    refresh_stack = stack_split(splits["train"][: 8 * args.batch_size], spec,
                                device)
    eval_pool = make_pool_eval_step(model, node_level=False,
                                    bn_mode=args.bn_eval)
    refresh_pool = make_pool_refresh_step(model)

    def evaluate(stacked):
        e, c = eval_pool(stacked)
        return float(e) / max(float(c), 1.0) * std

    data_rng = np.random.default_rng(args.seed)
    best_val = best_test = float("inf")
    epochs = []
    for epoch in range(1, args.epochs + 1):
        t_ep = time.time()
        if args.reshuffle_membership:
            ep_losses = torch.stack([
                train_step(model, opt, b, l1_graph_loss)
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
        line = f"epoch {epoch:03d} lr {lr:.6f} loss {loss:.5f} val MAE {val_mae:.5f}"
        test_mae = None
        if val_mae < best_val:
            best_val = val_mae
            best_test = test_mae = evaluate(test_stack)
            line += f" test MAE {best_test:.5f} *"
        seconds = time.time() - t_ep
        line += f" ({seconds:.1f}s)"
        _log(res_dir, line)
        epochs.append(dict(epoch=epoch, lr=lr, loss=loss, val_mae=val_mae,
                           test_mae=test_mae, seconds=seconds,
                           train_seconds=train_s, steps=len(ep_losses)))
    print(f"best val {best_val:.5f} test {best_test:.5f}")
    return dict(best_val=best_val, best_test=best_test, epochs=epochs,
                mean=mean, std=std, res_dir=res_dir, spec=spec,
                data_seconds=data_seconds)


if __name__ == "__main__":
    main()
