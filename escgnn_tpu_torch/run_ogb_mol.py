"""OGB graph-property driver on PyTorch (the twin of the repository's
`run_ogb_mol.py`):

    python -m escgnn_tpu_torch.run_ogb_mol [--dataset ogbg-molhiv]
        [--epochs 20] [--device cuda]

The efficient OGB GNN (virtual node, atom/bond encoders, the ESC
structural embedding in every layer, dropout, a graph-pooling choice),
NaN-masked BCE with ROC-AUC or AP (ogbg-ppa: cross-entropy and
accuracy), a checkpoint every `--log_steps` epochs, resuming with
`--continue_from`, an ensemble over every saved checkpoint with
`--ensemble_eval` and the worst test graphs with `--dump_worst`. It reads
an extracted OGB raw directory under `--data_dir` when there is one,
else trains on deterministic synthetic molecules. Flags, defaults, cache
keys, batches and printed lines are the JAX driver's. `--model
NestedPPGN` runs the two-level dense PPGN on node-rooted subgraph copies
(with the original adjacency) in ragged batches, its dense per-copy
budget the largest copy of the data.

The batches are the uniform per-graph blocks with deduplicated ESC rows
(`--layout uniform`, the default) or the ragged union with the width
encoding (`--layout ragged`). An epoch is one pool step over the train
split stacked once on the device, its batches in an order drawn from
`np.random.default_rng(seed)`: on a CUDA device one train step captured
into a CUDA graph and replayed, dropout drawing new masks in each replay
from the model's generator (seeded with `--seed`). Validation and test
logits come from one pass over their stacked splits; the metric is
computed on the host. The CPU runs only with `--device cpu`; without a
card the default raises.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.molecules import ogb_mol_splits, ppa_splits
from escgnn_tpu_torch.data.prefetch import pool_size, stack_split
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.featurize.cache import cached_featurize
from escgnn_tpu_torch.featurize.escgnn import EscConfig
from escgnn_tpu_torch.featurize.node_subgraphs import (
    NodeSubgraphConfig,
    create_node_subgraphs,
)
from escgnn_tpu_torch.featurize.rw import attach_return_prob
from escgnn_tpu_torch.featurize.transform import featurize_many
from escgnn_tpu_torch.models.nested_ppgn import NestedPPGN, NestedPPGNConfig
from escgnn_tpu_torch.models.ogb_gnn import (
    POOLINGS,
    SUBGRAPH_POOLINGS,
    OgbGNN,
    OgbGNNConfig,
)
from escgnn_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_model_tree,
    model_tree,
)
from escgnn_tpu_torch.train.loop import (
    adam_with_plateau,
    bce_graph_loss,
    ce_graph_loss,
    make_pool_logits_step,
    make_pool_train_step,
)
from escgnn_tpu_torch.train.metrics import average_precision, rocauc
from escgnn_tpu_torch.utils.rundir import log_line, start_run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m escgnn_tpu_torch.run_ogb_mol")
    p.add_argument("--dataset", default="ogbg-molhiv")
    p.add_argument("--model", default="GNN",
                   choices=["GNN", "GINEPlus", "NestedPPGN"],
                   help="GNN = the efficient OGB GNN; NestedPPGN = the "
                   "two-level PPGN on node-rooted copies; GINEPlus raises "
                   "(not ported)")
    p.add_argument("--multihop_k", type=int, default=3,
                   help="GINEPlus: number of hop levels K")
    p.add_argument("--h", type=int, default=4)
    p.add_argument("--num_layer", type=int, default=6)
    p.add_argument("--emb_dim", type=int, default=300)
    p.add_argument("--drop_ratio", type=float, default=0.65)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--num_tasks", type=int, default=1)
    p.add_argument("--graph_pooling", default="mean", choices=list(POOLINGS))
    p.add_argument("--subgraph_pooling", default="mean",
                   choices=list(SUBGRAPH_POOLINGS),
                   help="pooling of the copy level of a two-level batch; "
                   "the GNN's ESC batches have none, so it has no effect")
    p.add_argument("--rni", action="store_true",
                   help="random node initialization (h0 += U(-1,1))")
    p.add_argument("--use_rp", type=int, default=None,
                   help="N-step random-walk return probabilities as extra "
                   "node features")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_graphs", type=int, default=1000)
    p.add_argument("--num_workers", type=int, default=2,
                   help="featurizer processes (forked; each sets one "
                   "OpenMP thread)")
    p.add_argument("--log_steps", type=int, default=5)
    p.add_argument("--continue_from", type=int, default=None)
    p.add_argument("--ensemble_eval", action="store_true")
    p.add_argument("--dump_worst", type=int, default=0,
                   help="after training, dump the K worst-loss test graphs "
                   "to worst.json")
    p.add_argument("--layout", default="uniform",
                   choices=["uniform", "ragged"],
                   help="uniform per-graph blocks with deduplicated ESC "
                   "rows, or the ragged union with the width encoding")
    p.add_argument("--synth_label", default="parity",
                   choices=["parity", "tri"],
                   help="synthetic label when no real OGB raw dir exists: "
                   "'tri' = triangle count above the dataset median")
    p.add_argument("--metric", default="rocauc", choices=["rocauc", "ap"])
    p.add_argument("--data_dir", default="data")
    p.add_argument("--res_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs only when named")
    return p


def check_ported(args) -> None:
    """Raise for a flag whose module the port does not have yet, naming
    its ROADMAP queue, or for one that cannot apply."""
    if args.model == "GINEPlus":
        raise NotImplementedError(
            "--model GINEPlus: models/gine_plus.py is ROADMAP queue 8.5")
    if args.dump_worst and args.dataset == "ogbg-ppa":
        raise ValueError("--dump_worst scores a per-task BCE; ogbg-ppa is "
                         "one 37-class label")


def build_splits(args) -> tuple[dict, bool]:
    """The featurized {'train', 'val', 'test'} splits (through the
    feature cache under `<data_dir>/<dataset>`) and whether they are the
    real dataset. Sets `args.num_tasks` to 37 for ogbg-ppa."""
    if args.dataset == "ogbg-ppa":
        raw_splits, is_real = ppa_splits(args.data_dir, args.num_graphs,
                                         args.seed)
        args.num_tasks = 37
    else:
        raw_splits, is_real = ogb_mol_splits(
            args.data_dir, args.dataset, num_graphs=args.num_graphs,
            seed=args.seed, num_tasks=args.num_tasks,
            label_kind=args.synth_label)
        print(f"{args.dataset}: {'real raw dir' if is_real else 'synthetic'}"
              f" ({sum(len(s) for s in raw_splits.values())} graphs)")
    ecfg = EscConfig(h=args.h, use_rd=True, self_loop=True)
    key = f"_rp{args.use_rp}" if args.use_rp else ""
    if args.synth_label != "parity":
        key += f"_lab{args.synth_label}"
    if args.model == "NestedPPGN":
        key += "_nppgn"

    def featurize(graphs):
        if args.model == "NestedPPGN":
            scfg = NodeSubgraphConfig(h=args.h, use_rd=True,
                                      keep_orig_adj=True)
            return [create_node_subgraphs(g, scfg) for g in graphs]
        if args.use_rp:
            graphs = [attach_return_prob(g, args.use_rp) for g in graphs]
        return featurize_many(graphs, ecfg, num_workers=args.num_workers)

    splits = {
        name: cached_featurize(
            os.path.join(args.data_dir, args.dataset.replace("-", "_")),
            f"{name}_n{args.num_graphs}_s{args.seed}_{ecfg.cache_key()}{key}",
            lambda graphs=graphs: featurize(graphs))
        for name, graphs in raw_splits.items()}
    return splits, is_real


def build_spec(args, splits: dict) -> BatchSpec:
    all_graphs = [g for s in splits.values() for g in s]
    if args.layout == "uniform" and args.model == "GNN":
        return BatchSpec.uniform(all_graphs, args.batch_size,
                                 enc_layout="dedup")
    return BatchSpec.from_graphs(all_graphs, args.batch_size)


def model_config(args) -> OgbGNNConfig:
    return OgbGNNConfig(
        num_tasks=args.num_tasks, num_layers=args.num_layer,
        emb_dim=args.emb_dim, dropout=args.drop_ratio, virtual_node=True,
        graph_pooling=args.graph_pooling,
        subgraph_pooling=args.subgraph_pooling, rni=args.rni,
        use_rp=args.use_rp or 0, ppa_encoders=args.dataset == "ogbg-ppa")


def max_copy_nodes(graphs) -> int:
    """The largest node-rooted copy of the data: NestedPPGN's static dense
    budget M."""
    return max([1] + [int(np.bincount(g.extras["node_to_subgraph"]).max())
                      for g in graphs])


def nested_ppgn_config(args, max_sub: int) -> NestedPPGNConfig:
    return NestedPPGNConfig(
        emb_dim=args.emb_dim, num_rb_layers=args.num_layer,
        num_tasks=args.num_tasks, use_rd=True,
        classify=False,  # BCE-with-logits head (OGB multilabel)
        max_nodes_per_subgraph=max_sub)


def build_model(args, device, graphs=None):
    """The twin's model: weights drawn from `args.seed`, dropout's
    generator seeded with it too. NestedPPGN reads its dense budget and
    input widths from `graphs` (every split's featurized graphs)."""
    gen = torch.Generator().manual_seed(args.seed)
    if args.model == "NestedPPGN":
        g0 = graphs[0]
        return NestedPPGN(nested_ppgn_config(args, max_copy_nodes(graphs)),
                          in_dim=g0.x.reshape(g0.num_nodes, -1).shape[1],
                          edge_dim=g0.edge_attr.reshape(
                              g0.num_edges, -1).shape[1],
                          device=device, generator=gen)
    return OgbGNN(model_config(args), device=device, generator=gen,
                  rng_seed=args.seed)


def _accuracy(y: np.ndarray, p: np.ndarray) -> float:
    """ogbg-ppa's metric: argmax of the logits against the class id."""
    return float((p.argmax(-1) == y.reshape(-1)).mean())


def _scores(models, stacked):
    """(labels, logits averaged over `models`) of the real graphs of a
    stacked split, in batch order, as numpy."""
    outs = [make_pool_logits_step(m)(stacked) for m in models]
    logits = np.mean([o[0].float().cpu().numpy() for o in outs], axis=0)
    mask = outs[0][2].cpu().numpy()
    return outs[0][1].cpu().numpy()[mask], logits[mask]


def _worst_graphs(y: np.ndarray, scores: np.ndarray) -> list:
    """Per-graph BCE over its labeled tasks, worst first (the JAX
    driver's eps-clipped numpy BCE); graphs without labels are skipped
    and do not take an index."""
    rows = []
    for yk, sk in zip(y, scores):
        lab = ~np.isnan(yk)
        if not lab.any():
            continue
        p = 1.0 / (1.0 + np.exp(-sk[lab]))
        eps = 1e-7
        bce = float(np.mean(-(yk[lab] * np.log(p + eps)
                              + (1 - yk[lab]) * np.log(1 - p + eps))))
        rows.append({"index": len(rows), "loss": bce,
                     "y": yk[lab].tolist(), "score": sk[lab].tolist()})
    rows.sort(key=lambda r: -r["loss"])
    return rows


def main(argv=None) -> dict:
    """Train and evaluate; returns the run's numbers (best val and test
    metric, one record per epoch, the ensemble metric) for callers such
    as the smoke run."""
    args = build_parser().parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    res_dir = start_run(args, "escgnn_tpu_torch.run_ogb_mol", args.dataset,
                        __file__, argv)
    t0 = time.time()
    splits, is_real = build_splits(args)
    data_seconds = time.time() - t0
    spec = build_spec(args, splits)
    print("spec:", spec)

    is_ppa = args.dataset == "ogbg-ppa"
    if is_ppa:
        args.metric = "acc"
        metric_fn, loss_fn = _accuracy, ce_graph_loss
    else:
        metric_fn = rocauc if args.metric == "rocauc" else average_precision
        loss_fn = bce_graph_loss

    model = build_model(args, device,
                        [g for s in splits.values() for g in s])
    opt = adam_with_plateau(model.parameters(), args.lr,
                            grad_clip=args.grad_clip,
                            capturable=device.type == "cuda")
    ckpt = CheckpointManager(os.path.join(res_dir, "ckpt"))
    start_epoch = 1
    if args.continue_from is not None:
        load_model_tree(model, ckpt.restore(args.continue_from,
                                            template=model_tree(model)))
        start_epoch = args.continue_from + 1
        print(f"resumed from epoch {args.continue_from}")

    train_stack = stack_split(splits["train"], spec, device)
    val_stack = stack_split(splits["val"], spec, device)
    test_stack = stack_split(splits["test"], spec, device)
    steps = pool_size(train_stack)
    pool_step = make_pool_train_step(model, opt, loss_fn, train_stack)

    def evaluate(stacked, models=(model,)):
        return metric_fn(*_scores(models, stacked))

    data_rng = np.random.default_rng(args.seed)
    log_path = os.path.join(res_dir, "log.txt")
    best_val, best_test = -1.0, float("nan")
    epochs = []
    for epoch in range(start_epoch, args.epochs + 1):
        t_ep = time.time()
        loss = float(pool_step(train_stack,
                               data_rng.permutation(steps)).mean())
        train_s = time.time() - t_ep
        val = evaluate(val_stack)
        line = f"epoch {epoch:03d} loss {loss:.5f} val {args.metric} {val:.5f}"
        test = None
        if val > best_val:
            best_val = val
            best_test = test = evaluate(test_stack)
            line += f" test {best_test:.5f} *"
        if epoch % args.log_steps == 0 or epoch == args.epochs:
            # a step saved before (a resumed run) is kept, as the JAX
            # driver's orbax manager keeps it
            if epoch not in ckpt.all_steps():
                ckpt.save(epoch, model_tree(model))
            line += " [ckpt]"
        seconds = time.time() - t_ep
        log_line(log_path, line + f" ({seconds:.1f}s)")
        epochs.append(dict(epoch=epoch, loss=loss, val=val, test=test,
                           seconds=seconds, train_seconds=train_s,
                           steps=steps))

    ensemble = None
    if args.ensemble_eval and ckpt.all_steps():
        members = []
        for s in ckpt.all_steps():
            m = copy.deepcopy(model)
            load_model_tree(m, ckpt.restore(s, template=model_tree(m)))
            members.append(m)
        ensemble = evaluate(test_stack, members)
        print(f"ensemble test {args.metric} over {len(members)} ckpts: "
              f"{ensemble:.5f}")

    worst_path = None
    if args.dump_worst:
        rows = _worst_graphs(*_scores((model,), test_stack))
        worst_path = os.path.join(res_dir, "worst.json")
        with open(worst_path, "w") as f:
            json.dump(rows[:args.dump_worst], f, indent=2)
        print(f"dumped {min(args.dump_worst, len(rows))} worst graphs")

    print(f"best val {best_val:.5f} test {best_test:.5f}")
    return dict(best_val=best_val, best_test=best_test, epochs=epochs,
                ensemble=ensemble, worst_path=worst_path, res_dir=res_dir,
                spec=spec, is_real=is_real, data_seconds=data_seconds,
                metric=args.metric)


if __name__ == "__main__":
    main()
