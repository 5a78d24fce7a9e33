"""TU-benchmark cross-validation driver on PyTorch (the twin of the
repository's `run_tu.py`):

    python -m escgnn_tpu_torch.run_tu [--dataset MUTAG] [--model BaselineGNN]
        [--nested] [--use_cycle off|class|reg|reg_gc] [--device cuda]

Chooses a TU dataset (real when `<data_dir>/<NAME>/raw` holds its text
files, else the synthetic 2-class set) and a model, and runs stratified
k-fold cross-validation (`train/cv.py`): the test accuracy at each
fold's best-val-loss epoch, mean +- std over folds. `--nested` applies
the NGNN node-copy pre-transform (`featurize/node_subgraphs.py`) and
pools node -> copy -> graph. `--dataset Cora|Citeseer|PubMed` loads one
Planetoid citation graph (`<data_dir>/../Planetoid`, else its synthetic
stand-in) and needs a cycle mode. `--use_cycle` runs the node-level
cycle trainers (`train/cycles.py`) on per-node 3..6-cycle counts of the
raw graphs: `class` (BCE over a node split of the dataset's disjoint
union), `reg` (MSE, `--multi_layer` deep supervision) or `reg_gc` (a
graph split, batched). Flags, defaults, `config.json`, `log.txt` lines
and `result.json` are the JAX driver's, plus `--device`.

The model's input width is read from the prepared graphs (after the
copy transform under `--nested`); each CV fold draws its weights from
`torch.Generator().manual_seed(seed + fold)`, the cycle model from
`--seed`. An epoch is one pool step (`train/loop.py`): on a CUDA device
a train step captured into a CUDA graph and replayed. The CPU runs only
with `--device cpu`; without a card the default raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.models.registry import get_model
from escgnn_tpu_torch.train import cv
from escgnn_tpu_torch.utils.rundir import log_line, start_run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m escgnn_tpu_torch.run_tu")
    p.add_argument("--dataset", default="MUTAG")
    p.add_argument("--data_dir", default="data/TU")
    p.add_argument("--model", default="BaselineGNN")
    p.add_argument("--conv", default="gin0",
                   help="gcn|gcn_dir|sage|gin0|gin|gat|pna (BaselineGNN)")
    p.add_argument("--pool", default="mean")
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--nested", action="store_true",
                   help="NGNN node-copy nesting (NestedGCN scheme)")
    p.add_argument("--use_cycle", default="off",
                   choices=["off", "class", "reg", "reg_gc"],
                   help="node-level cycle trainers instead of k-fold CV")
    p.add_argument("--multi_layer", action="store_true",
                   help="deep-supervision aux heads (reg modes)")
    p.add_argument("--split_ratio", type=float, default=0.3)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--h", type=int, default=2)
    p.add_argument("--folds", type=int, default=10)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--lr_decay_factor", type=float, default=0.5)
    p.add_argument("--lr_decay_step_size", type=int, default=50)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--res_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs only when named")
    return p


def _in_dim(graphs) -> int:
    x = np.asarray(graphs[0].x)
    return int(x.reshape(x.shape[0], -1).shape[1])


def cycle_model(args, out_dim: int, in_dim: int, device):
    """The cycle trainers' node-level BaselineGNN (jumping knowledge,
    no log_softmax), its weights and dropout drawn from `--seed`."""
    return get_model(
        "BaselineGNN", conv=args.conv, hidden=args.hidden,
        num_layers=args.layers, out_dim=out_dim, nested=args.nested,
        classify=False, node_level=True, jk=True,
        multi_layer=args.multi_layer, dropout=args.dropout, in_dim=in_dim,
        device=device, generator=torch.Generator().manual_seed(args.seed),
        rng_seed=args.seed)


def cv_model_factory(args, num_classes: int, in_dim: int, device):
    """`factory(generator)`: the CV model with weights drawn from
    `generator` (and dropout seeded by it)."""

    def factory(generator: torch.Generator):
        common = dict(device=device, generator=generator)
        if args.model == "BaselineGNN":
            return get_model(
                "BaselineGNN", conv=args.conv, hidden=args.hidden,
                num_layers=args.layers, out_dim=num_classes, pool=args.pool,
                nested=args.nested, in_dim=in_dim,
                rng_seed=generator.initial_seed(), **common)
        if args.model == "IDGNN":
            # gin0 maps to gin: ID-GNN has no eps-free variant
            return get_model(
                "IDGNN", conv={"gin0": "gin"}.get(args.conv, args.conv),
                hidden=args.hidden, num_layers=args.layers,
                out_dim=num_classes, pool=args.pool, in_dim=in_dim,
                rng_seed=generator.initial_seed(), **common)
        return get_model(args.model, out_dim=num_classes, **common)

    return factory


def run_cycles(args, graphs, pre, res_dir, device) -> dict:
    """The three cycle trainers on per-node cycle counts of the raw
    graphs; writes `result.json` and returns its numbers."""
    from escgnn_tpu_torch.data.counting import count_cycles_per_node
    from escgnn_tpu_torch.train.cycles import (
        train_val_cycles,
        train_val_cycles_regression,
        train_val_cycles_regression_GC,
    )
    from escgnn_tpu_torch.utils.graph import disjoint_union

    cycles = [count_cycles_per_node(g.num_nodes, g.edge_index).astype(
        np.float32) for g in graphs]
    log_path = os.path.join(res_dir, "log.txt")
    common = dict(
        split_ratio=args.split_ratio, epochs=args.epochs, lr=args.lr,
        lr_decay_factor=args.lr_decay_factor,
        lr_decay_step_size=args.lr_decay_step_size,
        weight_decay=args.weight_decay, seed=args.seed,
        logger=lambda msg: log_line(log_path, msg),
    )
    out_dim = cycles[0].shape[1]
    if args.use_cycle == "reg_gc":
        if pre is not None:
            graphs = [pre(g) for g in graphs]
        model = cycle_model(args, out_dim, _in_dim(graphs), device)
        res = train_val_cycles_regression_GC(
            graphs, cycles, model, batch_size=args.batch_size, **common)
        names = ("test_mse", "test_mae", "test_rmse")
    else:
        union = disjoint_union(graphs)
        if pre is not None:
            union = pre(union)
        model = cycle_model(args, out_dim, _in_dim([union]), device)
        fn = (train_val_cycles if args.use_cycle == "class"
              else train_val_cycles_regression)
        res = fn(union, np.concatenate(cycles), model, **common)
        names = (("test_acc", "test_roc", "test_ap")
                 if args.use_cycle == "class"
                 else ("test_mse", "test_mae", "test_rmse"))
    summary = dict(zip(names, map(float, res.test_metrics)))
    summary["best_val"] = float(res.best_val)
    summary["duration_s"] = res.duration
    log_line(log_path, json.dumps(summary))
    with open(os.path.join(res_dir, "result.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return dict(summary, history=res.history, res_dir=res_dir)


def main(argv=None) -> dict:
    """Run the CV (or a cycle mode); returns the numbers `result.json`
    holds, with the per-fold histories (`val_losses`, `test_accs`) or
    the cycle trainer's per-epoch `history`, and `res_dir`."""
    from escgnn_tpu_torch.data.planetoid import PLANETOID_NAMES, get_planetoid
    from escgnn_tpu_torch.data.tu import get_tu_dataset

    p = build_parser()
    args = p.parse_args(argv)
    if args.dataset in PLANETOID_NAMES and args.use_cycle == "off":
        p.error("Planetoid datasets are single citation graphs; "
                "use a --use_cycle mode (node-split protocol)")
    device = resolve_device(args.device)
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res_dir = start_run(args, "escgnn_tpu_torch.run_tu",
                        f"tu_{args.dataset}", __file__, argv)

    pre = None
    if args.nested:
        from escgnn_tpu_torch.featurize.node_subgraphs import (
            NodeSubgraphConfig,
            create_node_subgraphs,
        )

        ncfg = NodeSubgraphConfig(h=args.h)
        pre = lambda g: create_node_subgraphs(g, ncfg)  # noqa: E731
    t0 = time.time()
    # cycle labels come from the raw graphs (before any copy transform)
    raw_pre = None if args.use_cycle != "off" else pre
    if args.dataset in PLANETOID_NAMES:
        graphs = [get_planetoid(args.dataset, root=os.path.join(
            args.data_dir, "..", "Planetoid"))]
        print(f"dataset {args.dataset}: 1 graph, "
              f"{graphs[0].num_nodes} nodes  ({time.time() - t0:.1f}s)")
    else:
        graphs = get_tu_dataset(args.dataset, root=args.data_dir,
                                pre_transform=raw_pre)
        classes = sorted({int(g.y[0]) for g in graphs})
        print(f"dataset {args.dataset}: {len(graphs)} graphs, "
              f"{len(classes)} classes  ({time.time() - t0:.1f}s)")

    if args.use_cycle != "off":
        return run_cycles(args, graphs, pre, res_dir, device)

    log_path = os.path.join(res_dir, "log.txt")
    res = cv.cross_validation_with_val_set(
        graphs, cv_model_factory(args, len(classes), _in_dim(graphs),
                                 device),
        folds=args.folds, epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr, lr_decay_factor=args.lr_decay_factor,
        lr_decay_step_size=args.lr_decay_step_size,
        weight_decay=args.weight_decay, seed=args.seed,
        logger=lambda msg: log_line(log_path, msg), device=device)
    log_line(log_path, f"Val Loss: {res.val_loss:.4f}, Test Accuracy: "
                       f"{res.test_acc_mean:.3f} +- {res.test_acc_std:.3f}")
    out = {"val_loss": res.val_loss, "test_acc_mean": res.test_acc_mean,
           "test_acc_std": res.test_acc_std, "durations": res.durations}
    with open(os.path.join(res_dir, "result.json"), "w") as f:
        json.dump(out, f, indent=2)
    return dict(out, val_losses=res.val_losses, test_accs=res.test_accs,
                res_dir=res_dir)


if __name__ == "__main__":
    main()
