"""QM9 target regression on PyTorch (the twin of the repository's
`run_qm9.py`):

    python -m escgnn_tpu_torch.run_qm9 [--target 0] [--device cuda]

NestedGIN_eff with [x ‖ pos] plus an additive node-type embedding, z_emb
concatenated with the continuous bond + normalized-distance edge
features, mean pooling; MSE training loss on train-standardized targets,
MAE evaluation in the reference's units (`QM9_CONVERSION`), shuffled
10/10/80 test/val/train split. `--model NGNN|I2GNN` runs the copy
models on integer atom and bond types (the argmax of the one-hots), on
`--copy_layout` uniform or ragged copy batches. `--model k1_GNN` runs the
k-GNN on the distance-extended graphs; `k12_GNN`, `k13_GNN` and
`k123_GNN` the nested k-GNNs on their node-rooted copies (h-hop, with
resistance distances) with the k-set graphs of each copy attached (all
2-sets and connected 3-sets, Malkin neighbourhoods), all in ragged
batches. Reads the real gdb9.sdf under
`<data_dir>/qm9/raw/` when it is there, else trains on synthetic
QM9-shaped molecules. Flags, defaults, batches and log lines are the JAX
driver's.

An epoch is one pool step (`train/loop.py`): on a CUDA device one train
step captured into a CUDA graph and replayed over a device-resident
stacked batch pool. The CPU runs only with `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.container import GraphBatch, GraphData
from escgnn_tpu_torch.data.qm9 import (
    QM9_CONVERSION,
    append_distance_edge_attr,
    qm9_splits,
)
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.featurize.escgnn import EscConfig
from escgnn_tpu_torch.featurize.kset import attach_kset_graphs
from escgnn_tpu_torch.featurize.node_subgraphs import (
    NodeSubgraphConfig,
    create_node_subgraphs,
)
from escgnn_tpu_torch.featurize.transform import featurize_many
from escgnn_tpu_torch.models.kgnn_models import KGNN, KGNNConfig
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
from escgnn_tpu_torch.train.loop import adam_with_plateau
from escgnn_tpu_torch.utils.rundir import start_run

# the k-GNNs and their k-set levels
KGNN_LEVELS = {"k1_GNN": (), "k12_GNN": (2,), "k13_GNN": (3,),
               "k123_GNN": (2, 3)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m escgnn_tpu_torch.run_qm9")
    p.add_argument("--target", type=int, default=0)
    p.add_argument("--model", default="NestedGIN_eff",
                   choices=["NestedGIN_eff", "NGNN", "I2GNN", *KGNN_LEVELS],
                   help="NGNN / I2GNN run on the copy transforms of the "
                   "typed graphs; k12/k13/k123 are the nested k-GNNs, "
                   "k1_GNN the plain one")
    p.add_argument("--h", type=int, default=3)
    p.add_argument("--layers", type=int, default=5)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--lr_decay_factor", type=float, default=0.7)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_graphs", type=int, default=1000)
    p.add_argument("--copy_layout", default="uniform",
                   choices=["ragged", "uniform"],
                   help="NGNN/I2GNN batch layout")
    p.add_argument("--num_workers", type=int, default=2,
                   help="featurizer processes (forked; each sets one "
                   "OpenMP thread)")
    p.add_argument("--data_dir", default="data")
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


def build_splits(args, timings: Optional[dict] = None
                 ) -> tuple[dict, float, float, bool]:
    """The featurized, distance-extended test/val/train splits (shuffled
    10/10/80) with target `args.target` standardized by the train mean
    and (population) std; returns (splits, mean, std, is_real).
    `timings`, a dict, receives the seconds of the k-set enumeration
    (`kset`) of the nested k-GNNs."""
    raw, is_real = qm9_splits(args.data_dir, num_graphs=args.num_graphs,
                              seed=args.seed)
    print(f"qm9 data: {'real gdb9.sdf' if is_real else 'synthetic'} "
          f"({len(raw)} molecules)")
    if args.model in COPY_MODELS:
        # the copy models embed integer node and bond types
        feats = featurize_copies([_typed(g) for g in raw], args.model,
                                 args.h)
    elif args.model in KGNN_LEVELS:
        feats = [append_distance_edge_attr(g) for g in raw]
        if args.model != "k1_GNN":
            scfg = NodeSubgraphConfig(h=args.h, use_rd=True)
            feats = [create_node_subgraphs(g, scfg) for g in feats]
            t0 = time.time()
            feats = [attach_kset_graphs(g, ks=KGNN_LEVELS[args.model],
                                        malkin=True) for g in feats]
            if timings is not None:
                timings["kset"] = time.time() - t0
    else:
        ecfg = EscConfig(h=args.h, use_rd=True, self_loop=True)
        feats = featurize_many(raw, ecfg, num_workers=args.num_workers,
                               self_loop_fill=1.0)
        feats = [append_distance_edge_attr(g) for g in feats]
    order = np.random.default_rng(args.seed).permutation(len(feats))
    n10 = len(feats) // 10
    splits = {
        "test": [feats[i] for i in order[:n10]],
        "val": [feats[i] for i in order[n10:2 * n10]],
        "train": [feats[i] for i in order[2 * n10:]],
    }
    t = args.target
    ys = np.asarray([g.y[t] for g in splits["train"]])
    mean, std = float(ys.mean()), float(ys.std())
    for s in splits.values():
        for g in s:
            g.y = np.asarray([(g.y[t] - mean) / max(std, 1e-8)], np.float32)
    return splits, mean, std, is_real


def _typed(g: GraphData) -> GraphData:
    """Atom type ids (argmax of the first 5 one-hot columns) and bond type
    ids (argmax of the bond one-hot), one int32 column each."""
    return GraphData(
        num_nodes=g.num_nodes, edge_index=g.edge_index,
        x=np.argmax(g.x[:, :5], axis=1).astype(np.int32)[:, None],
        edge_attr=np.argmax(g.edge_attr, axis=1).astype(np.int32)[:, None],
        pos=g.pos, y=g.y)


def model_config(args) -> NestedGINEffConfig:
    return NestedGINEffConfig(
        hidden=args.hidden, num_layers=args.layers, dropout=0.0, act="relu",
        graph_pred=True, pool="mean", use_x_embedding_jk=False,
        head_order="dropout_act", concat_pos=True, node_add_embed_vocab=5,
        edge_float_attr=True, out_dim=1,
    )


def kgnn_config(args) -> KGNNConfig:
    nested = args.model != "k1_GNN"
    return KGNNConfig(levels=KGNN_LEVELS[args.model], use_rd=nested,
                      use_pos=True, nested=nested, out_dim=1)


def build_model(args, in_dim: int, edge_attr_dim: int, device,
                has_pos: bool = True):
    """The twin's model, its weights drawn from `args.seed`; `has_pos`:
    the k-GNN's batches carry `pos` (the copy transform drops it)."""
    gen = torch.Generator().manual_seed(args.seed)
    if args.model in COPY_MODELS:
        return copy_model(args.model, args, device, gen)
    if args.model in KGNN_LEVELS:
        return KGNN(kgnn_config(args), x_dim=in_dim, edge_dim=edge_attr_dim,
                    has_pos=has_pos, device=device, generator=gen)
    return NestedGINEff(model_config(args), in_dim=in_dim,
                        edge_attr_dim=edge_attr_dim, device=device,
                        generator=gen)


def mse_loss(out: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """The JAX driver's loss: squared error summed over real graphs, over
    their count."""
    err = (out - batch.y) ** 2
    m = batch.graph_mask.to(err.dtype)[:, None]
    return (err * m).sum() / m.sum().clamp_min(1.0)


def main(argv=None) -> dict:
    """Train and evaluate; returns the run's numbers (best val/test MAE in
    converted units and one record per epoch) for callers such as the
    smoke run."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    res_dir = start_run(args, "escgnn_tpu_torch.run_qm9", "qm9", __file__,
                        argv)
    t0 = time.time()
    timings: dict = {}
    splits, mean, std, is_real = build_splits(args, timings)
    data_seconds = time.time() - t0
    print(f"data: {data_seconds:.1f}s mean={mean:.4f} std={std:.4f}")

    if args.model in COPY_MODELS:
        splits, spec, _ = copy_layout_spec(splits, args.batch_size,
                                           args.copy_layout)
    elif args.model in KGNN_LEVELS:
        spec = BatchSpec.from_graphs(
            [g for s in splits.values() for g in s], args.batch_size)
    else:
        # uniform per-graph blocks + deduplicated ESC rows, the flagship
        # layout
        spec = BatchSpec.uniform([g for s in splits.values() for g in s],
                                 args.batch_size, enc_layout="dedup")
    print("spec:", spec)

    g0 = splits["train"][0]
    model = build_model(args, g0.x.shape[1], g0.edge_attr.shape[1], device,
                        has_pos=g0.pos is not None)
    opt = adam_with_plateau(model.parameters(), args.lr,
                            grad_clip=args.grad_clip,
                            capturable=device.type == "cuda")
    conv = float(QM9_CONVERSION[args.target])
    res = fit(args, model, opt, mse_loss, splits, spec, device,
              node_level=False, scale=std * conv,
              log_path=os.path.join(res_dir, "log.txt"))
    print(f"best val {res['best_val']:.5f} test {res['best_test']:.5f}")
    return dict(res, mean=mean, std=std, conversion=conv, is_real=is_real,
                res_dir=res_dir, spec=spec, data_seconds=data_seconds,
                kset_seconds=timings.get("kset", 0.0))


if __name__ == "__main__":
    main()
