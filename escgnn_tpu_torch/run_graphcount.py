"""Cycle- and graphlet-counting driver on PyTorch (the twin of the
repository's `run_graphcount.py`):

    python -m escgnn_tpu_torch.run_graphcount --target 0 [--device cuda]

NestedGIN_eff (or PPGN_eff) on random graphs with per-node count
targets, L1 loss on standardized targets, Adam with a plateau learning
rate, best-val checkpoints, MAE x std reporting. The dataset is
regenerated from a seed and its featurization cached on disk under the
JAX driver's cache key; flags, defaults, batches and log lines are the
JAX driver's.

An epoch is one pool step (`train/loop.py`): on a CUDA device one train
step captured into a CUDA graph and replayed over a device-resident
stacked batch pool. The CPU runs only with `--device cpu`.

`--compress_pools` stores the pools losslessly downcast
(`data/compress.py`). `--mesh dp|ep|dp_ep|halo` trains in a parallel mode
of `parallel/` on a world of one rank per device (`torchrun
--nproc_per_node D`, or `--multihost` with `--coordinator host:port
--num_processes P --process_id i`; a plain process is a world of one);
under `--multihost --mesh dp` each process trains on its strided shard
of the train split.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.counting import (
    TARGET_COLUMNS,
    CountingDatasetConfig,
    generate_counting_graphs,
    normalize_targets,
)
from escgnn_tpu_torch.data.prefetch import materialized_batches
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.parallel.mesh import rank_device
from escgnn_tpu_torch.featurize.cache import cached_featurize
from escgnn_tpu_torch.featurize.escgnn import EscConfig
from escgnn_tpu_torch.featurize.transform import featurize_many
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.models.ppgn import PPGN, PPGNConfig
from escgnn_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_model_tree,
    model_tree,
)
from escgnn_tpu_torch.train.fit import fit, halo_spec, make_run_mesh
from escgnn_tpu_torch.train.loop import adam_with_plateau, l1_node_loss
from escgnn_tpu_torch.utils.rundir import log_line, start_run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m escgnn_tpu_torch.run_graphcount")
    p.add_argument("--target", type=int, default=0,
                   help="0..3 -> 3..6-cycles (count_cycle) / 0..4 -> "
                   "tailed-tri, chordal, 4-clique, P4, triangle-rectangle "
                   "(count_graphlet)")
    p.add_argument("--dataset", default="count_cycle",
                   choices=["count_cycle", "count_graphlet"])
    p.add_argument("--h", type=int, default=3)
    p.add_argument("--model", default="NestedGIN_eff",
                   choices=["NestedGIN_eff", "PPGN_eff"])
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--lr_decay_factor", type=float, default=0.9)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--load_ckpt", default=None,
                   help="warm-start params and BN stats from this ckpt dir "
                   "(a previous run's res_dir/ckpt); the optimizer restarts")
    p.add_argument("--data_seed", type=int, default=0)
    p.add_argument("--num_graphs", type=int, default=1500)
    p.add_argument("--num_workers", type=int, default=0,
                   help="featurizer processes (forked; each sets one "
                   "OpenMP thread)")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--res_dir", default=None)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="conv-stack compute dtype (f32 master params)")
    p.add_argument("--analyze", action="store_true",
                   help="per-count-value MAE breakdown after training")
    p.add_argument("--membership_pools", type=int, default=4,
                   help="membership-shuffled train batch pools on the card, "
                   "cycled across epochs")
    p.add_argument("--compress_pools", action="store_true",
                   help="store the device-resident pools losslessly "
                   "downcast (int8/int16), decoded inside the step")
    p.add_argument("--reshuffle_membership", action="store_true",
                   help="re-form train batches every epoch (prefetched, "
                   "eager steps)")
    p.add_argument("--mesh", default="none",
                   choices=["none", "dp", "ep", "halo", "dp_ep"],
                   help="train over the ranks of torch.distributed, one "
                   "device each: 'dp' = data parallel, 'ep' = edge "
                   "partition, 'halo' = receiver-range node+edge shards, "
                   "'dp_ep' = 2-D data x edge mesh (--mesh_dp = data-axis "
                   "size)")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="device count for --mesh: the world size, or 0")
    p.add_argument("--mesh_dp", type=int, default=2,
                   help="data-axis size of the 2-D --mesh dp_ep mesh")
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process training: join the process group "
                   "(--coordinator, or the torchrun environment); under "
                   "--mesh dp each process trains on its strided shard of "
                   "the train split. One process is unchanged.")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 for --multihost")
    p.add_argument("--num_processes", type=int, default=None,
                   help="process count for --multihost")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank for --multihost")
    p.add_argument("--bn_eval", default="running",
                   choices=["batch", "running"],
                   help="eval-time BN statistics: 'running' re-estimates "
                   "them on frozen params before each eval; 'batch' uses "
                   "each eval batch's own")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs only when named")
    return p


def build_datasets(args) -> dict:
    """The featurized splits, through the disk cache (generation, exact
    substructure counting, runs only on a cache miss)."""
    dcfg = CountingDatasetConfig(
        num_graphs=args.num_graphs, seed=args.data_seed,
        task="graphlet" if args.dataset == "count_graphlet" else "cycle")
    ecfg = EscConfig(h=args.h, use_rd=True, self_loop=True)
    raw_cache: dict = {}

    def raw_splits():
        if not raw_cache:
            raw_cache.update(generate_counting_graphs(dcfg))
        return raw_cache

    # y{cols} keys the cache on the target schema
    ycols = TARGET_COLUMNS[dcfg.task]
    return {
        name: cached_featurize(
            os.path.join(args.data_dir, args.dataset),
            f"{name}_n{dcfg.num_graphs}_s{dcfg.seed}_y{ycols}_"
            f"{ecfg.cache_key()}",
            lambda name=name: featurize_many(
                raw_splits()[name], ecfg, num_workers=args.num_workers),
        )
        for name in ("train", "val", "test")
    }


def build_model(args, spec: BatchSpec, in_dim: int, device):
    gen = torch.Generator().manual_seed(args.seed)
    if args.model == "PPGN_eff":
        # the dense provably-powerful net with the ESC encoding in the
        # edge channels (reference run_graphcount.py:207-308)
        return PPGN(PPGNConfig(
            emb_dim=args.hidden, num_rb_layers=args.layers,
            max_nodes=max(spec.max_nodes_per_graph, spec.uniform_nodes),
            node_level=True, use_esc=True,
        ), device=device, generator=gen)
    return NestedGINEff(NestedGINEffConfig(
        hidden=args.hidden, num_layers=args.layers, dropout=0.0,
        graph_pred=False, act="relu", use_x_embedding_jk=True, out_dim=1,
        compute_dtype=args.compute_dtype,
    ), in_dim=in_dim, device=device, generator=gen)


def main(argv=None) -> dict:
    """Train and evaluate; returns the run's numbers (best val/test MAE
    and one record per epoch) for callers such as the smoke run."""
    args = build_parser().parse_args(argv)
    device = rank_device(resolve_device(args.device))
    if args.mesh == "halo" and args.model != "NestedGIN_eff":
        raise ValueError("--mesh halo drives the NestedGIN_eff halo path")
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    res_dir = start_run(args, "escgnn_tpu_torch.run_graphcount",
                        args.dataset, __file__, argv)

    t0 = time.time()
    splits = build_datasets(args)
    splits, mean, std = normalize_targets(splits, args.target)
    data_seconds = time.time() - t0
    print(f"featurization+load: {data_seconds:.1f}s  "
          f"mean={mean:.3f} std={std:.3f}")

    all_graphs = [g for s in splits.values() for g in s]
    proc_count, proc_index = 1, 0
    if args.multihost:
        from escgnn_tpu_torch.parallel.multihost import init_multihost

        proc_count, proc_index = init_multihost(
            args.coordinator, args.num_processes, args.process_id, device)
        print(f"multihost: process {proc_index}/{proc_count}, "
              f"{proc_count} global devices")
    mesh = make_run_mesh(args, device)
    if args.mesh == "halo":
        spec = halo_spec(all_graphs, args.batch_size, mesh.size())
    else:
        # uniform per-graph blocks + deduplicated ESC rows, the flagship
        # layout
        spec = BatchSpec.uniform(all_graphs, args.batch_size,
                                 enc_layout="dedup")
    print(f"batch spec: {spec}")
    if args.mesh == "dp" and proc_count > 1:
        from escgnn_tpu_torch.parallel.multihost import process_shard

        # this process's strided train shard (DistributedSampler role)
        splits["train"] = process_shard(splits["train"], proc_index,
                                        proc_count)

    model = build_model(args, spec, all_graphs[0].x.shape[1], device)
    if args.load_ckpt:
        # warm start from a previous run's best checkpoint (the
        # reference's --load_model); the optimizer restarts fresh
        pre = CheckpointManager(args.load_ckpt)
        restored = pre.restore(template=model_tree(model))
        if restored is None:
            raise FileNotFoundError(
                f"--load_ckpt {args.load_ckpt!r} has no checkpoint")
        load_model_tree(model, restored)
        print(f"warm-started from {args.load_ckpt} "
              f"(step {pre.latest_step()})")
    opt = adam_with_plateau(model.parameters(), args.lr,
                            grad_clip=args.grad_clip,
                            capturable=device.type == "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.2f}M")

    ckpt = CheckpointManager(os.path.join(res_dir, "ckpt"), max_to_keep=3)
    log_path = os.path.join(res_dir, "log.txt")
    res = fit(args, model, opt, l1_node_loss, splits, spec, device,
              node_level=True, scale=std, log_path=log_path,
              on_best=lambda epoch: ckpt.save(epoch, model_tree(model)),
              mesh=mesh)
    best_val, best_test = res["best_val"], res["best_test"]
    print(f"best val MAE {best_val:.5f}  test MAE {best_test:.5f} "
          f"(normalized: {best_test / std:.5f})")

    if args.analyze:
        # per-count-value error breakdown (reference `visualize`,
        # run_graphcount.py:531-581): MAE of the de-normalized prediction
        # grouped by the true count value
        model.eval()
        errs: dict = {}
        with torch.no_grad():
            for b in materialized_batches(splits["test"], spec, device):
                out = model(b)[:, 0].cpu().numpy() * std + mean
                y = b.y[:, 0].cpu().numpy() * std + mean
                m = b.node_mask.cpu().numpy()
                for yt, yp in zip(y[m], out[m]):
                    errs.setdefault(int(round(yt)), []).append(abs(yp - yt))
        print("count  n      MAE")
        for cval in sorted(errs):
            log_line(log_path, f"{cval:5d} {len(errs[cval]):6d} "
                               f"{float(np.mean(errs[cval])):.5f}")
    ckpt.close()
    return dict(res, mean=mean, std=std, res_dir=res_dir, spec=spec,
                data_seconds=data_seconds)


if __name__ == "__main__":
    main()
