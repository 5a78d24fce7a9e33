"""GPS config-driven driver on PyTorch (the twin of the repository's
`run_gps.py`):

    python -m escgnn_tpu_torch.run_gps --cfg configs/gps/zinc-GPS.yaml \
        [dotted.key value ...] [--eval_only CKPT_DIR [--dump_attn NPZ]] \
        [--device cuda]

Loads a YAML config (through `config.py`, no PyYAML) with dotted
overrides, dumps the resolved config into `<out_dir>/<time>/config.yaml`,
and for each of `num_runs` seeds builds the dataset with the ESC
pre-transform, the SPD attention bias and the requested positional
encodings (cached under `<dataset.dir>/gps_<name>`, the JAX driver's cache
keys), trains a `GPSModel` with best-val and periodic checkpoints,
auto-resume, a pretrained finetune (`pretrained.dir`, optionally
resetting the head and freezing the rest) and the plateau scheduler, and
aggregates the runs' metrics into `agg.json`. `--eval_only` restores a
checkpoint directory and prints its val and test metric; `--dump_attn`
then writes every dense attention's weights on the first test batch to
an npz under JAX's key names.

Batches are the ragged union with the width encoding
(`BatchSpec.from_graphs`), as in JAX. An epoch is one pool step over the
train split stacked on the device, its batches in an order drawn from
`np.random.default_rng(seed)`: on a CUDA device one train step captured
into a CUDA graph and replayed. Before each eval the BatchNorm running
statistics are re-estimated as the exact average over the first 8
batches of the train split. Regression reports the MAE (times the
target std), classification the accuracy, multilabel AP or ROC-AUC
(`metric: auc`), node classification the macro-F1 over the nodes with a
label (y >= 0: the single-graph splits mask the other nodes to -1), the
sequence task (ogbg-code2) the sub-token F1, and the link task the MRR
over all nodes of each graph (hits@k beside it).

The datasets: zinc, zinc-synthetic, count_cycle / count_graphlet,
qm9-synthetic, ogbg-molhiv / ogbg-molpcba, aqsol, ogbg-ppa, ogbg-code2,
mnist / cifar10, vocsuperpixels / cocosuperpixels, malnet-tiny,
peptides-func / peptides-struct, pattern / cluster,
planetoid-{cora,citeseer,pubmed}, webkb-{cornell,texas,wisconsin},
actor, wikipedia-{chameleon,squirrel}, tu-<NAME>,
pcqm4mv2-{subset,full,inference}, pcqm4mv2contact-* and ogbl-*: each
real when its files lie under `dataset.dir`, else its synthetic
generator. The CPU runs only with `--device cpu`; without a card the
default raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

import numpy as np
import torch

from escgnn_tpu_torch.config import agg_runs, dump_cfg, load_cfg
from escgnn_tpu_torch.data.batching import BatchSpec, batch_iterator
from escgnn_tpu_torch.data.prefetch import (
    pool_entry,
    pool_size,
    stack_split,
    stacked_batch_pools,
)
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.featurize.cache import cached_featurize
from escgnn_tpu_torch.featurize.escgnn import EscConfig
from escgnn_tpu_torch.featurize.posenc import (
    attach_degree,
    attach_lap_pe,
    attach_rwse,
)
from escgnn_tpu_torch.featurize.spd import attach_attn_bias_many
from escgnn_tpu_torch.featurize.transform import featurize_many
from escgnn_tpu_torch.models.gps import DenseGrid, GPSConfig, GPSModel
from escgnn_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_model_tree,
    restore_train_state,
    train_state_tree,
)
from escgnn_tpu_torch.train.loop import (
    PlateauScheduler,
    adam_with_plateau,
    bce_graph_loss,
    ce_graph_loss,
    ce_node_loss,
    eval_step,
    get_learning_rate,
    l1_graph_loss,
    l1_node_loss,
    make_pool_eval_step,
    make_pool_logits_step,
    make_pool_refresh_step,
    make_pool_train_step,
    make_sequence_ce_loss,
    running_statistics,
    set_learning_rate,
)
from escgnn_tpu_torch.train.metrics import (
    average_precision,
    graph_link_mrr,
    link_pair_loss,
    macro_f1,
    rocauc,
)
from escgnn_tpu_torch.utils.rundir import backup_run

HEAD_KEYS = ("head1", "head2")
# the tasks whose labels are never standardized and whose metric is
# higher-is-better
CLASS_TASKS = ("classification", "multilabel", "node_classification",
               "sequence", "link")


def _even_splits(raw):
    n_tr, n_val = int(0.8 * len(raw)), int(0.1 * len(raw))
    return {"train": raw[:n_tr], "val": raw[n_tr:n_tr + n_val],
            "test": raw[n_tr + n_val:]}


def _raw_splits(cfg, seed: int) -> dict:
    d = cfg.dataset
    if d.name == "zinc":
        from escgnn_tpu_torch.data.molecules import zinc_splits

        raw, is_real = zinc_splits(d.dir, num_graphs=d.num_graphs, seed=seed)
        print(f"zinc: real={is_real}")
        return raw
    if d.name == "zinc-synthetic":
        from escgnn_tpu_torch.data.molecules import synthetic_zinc

        return _even_splits(synthetic_zinc(num_graphs=d.num_graphs,
                                           seed=seed))
    if d.name in ("count_cycle", "count_graphlet"):
        from escgnn_tpu_torch.data.counting import (
            CountingDatasetConfig,
            generate_counting_graphs,
        )

        return generate_counting_graphs(CountingDatasetConfig(
            num_graphs=d.num_graphs, seed=seed,
            task="graphlet" if d.name == "count_graphlet" else "cycle"))
    if d.name == "qm9-synthetic":
        from escgnn_tpu_torch.data.qm9 import synthetic_qm9

        return _even_splits(synthetic_qm9(num_graphs=d.num_graphs,
                                          seed=seed))
    if d.name in ("ogbg-molhiv", "ogbg-molpcba"):
        from escgnn_tpu_torch.data.molecules import synthetic_ogb_mol

        return _even_splits(synthetic_ogb_mol(
            num_graphs=d.num_graphs, seed=seed, num_tasks=cfg.model.out_dim,
            nan_frac=0.25 if d.name == "ogbg-molpcba" else 0.0))
    if d.name == "aqsol":
        from escgnn_tpu_torch.data.molecules import aqsol_splits

        raw, is_real = aqsol_splits(d.dir, num_graphs=d.num_graphs, seed=seed)
        print(f"aqsol: real={is_real}")
        return raw
    if d.name in ("mnist", "cifar10"):
        from escgnn_tpu_torch.data.superpixels import superpixel_splits

        raw, is_real = superpixel_splits(d.dir, d.name,
                                         num_graphs=d.num_graphs, seed=seed)
        print(f"{d.name}: real={is_real}")
        return raw
    if d.name in ("vocsuperpixels", "cocosuperpixels"):
        from escgnn_tpu_torch.data.superpixels import voc_coco_splits

        raw, is_real = voc_coco_splits(d.dir, d.name,
                                       num_graphs=d.num_graphs, seed=seed)
        print(f"{d.name}: real={is_real}")
        return raw
    if d.name == "ogbg-ppa":
        from escgnn_tpu_torch.data.molecules import ppa_splits

        return ppa_splits(d.dir, num_graphs=d.num_graphs, seed=seed)[0]
    if d.name == "ogbg-code2":
        from escgnn_tpu_torch.data.code2 import code2_splits

        return code2_splits(d.dir, num_graphs=d.num_graphs, seed=seed)[0]
    if d.name == "malnet-tiny":
        from escgnn_tpu_torch.data.malnet import malnet_splits

        raw, is_real = malnet_splits(d.dir, num_graphs=d.num_graphs,
                                     seed=seed)
        print(f"malnet-tiny: real={is_real}")
        return raw
    if d.name in ("peptides-func", "peptides-struct"):
        from escgnn_tpu_torch.data.peptides import peptide_splits

        raw, is_real = peptide_splits(d.dir, d.name.split("-")[1],
                                      num_graphs=d.num_graphs, seed=seed)
        print(f"{d.name}: real={is_real}")
        return raw
    if d.name.startswith("planetoid-"):
        # one citation graph, three copies with labels -1 outside the split
        from escgnn_tpu_torch.data.hetero import node_split_copies
        from escgnn_tpu_torch.data.planetoid import get_planetoid

        name = d.name.split("-", 1)[1].capitalize()
        if name == "Pubmed":
            name = "PubMed"
        g = get_planetoid(name, root=os.path.join(d.dir, "Planetoid"))
        return node_split_copies(g, seed=seed)
    if (d.name.startswith(("webkb-", "wikipedia-"))
            or d.name == "actor"):
        from escgnn_tpu_torch.data.hetero import (
            get_hetero_graph,
            node_split_copies,
        )

        name = d.name.split("-", 1)[1] if "-" in d.name else d.name
        g, is_real = get_hetero_graph(name,
                                      root=os.path.join(d.dir, "hetero"))
        print(f"{d.name}: real={is_real}")
        return node_split_copies(g, seed=seed)
    if d.name in ("pattern", "cluster"):
        from escgnn_tpu_torch.data.sbm import sbm_splits

        return sbm_splits(d.name, num_graphs=d.num_graphs, seed=seed)
    if d.name.startswith("ogbl-"):
        from escgnn_tpu_torch.data.contact import ogbl_splits

        raw, is_real = ogbl_splits(d.dir, d.name,
                                   num_nodes=max(d.num_graphs, 100),
                                   seed=seed)
        print(f"{d.name}: real={is_real}")
        return raw
    if d.name.startswith("pcqm4mv2contact"):
        from escgnn_tpu_torch.data.contact import contact_splits

        split = d.name.split("-", 1)[1] if "-" in d.name else "shuffle"
        raw, is_real = contact_splits(d.dir, split=split,
                                      num_graphs=d.num_graphs, seed=seed)
        print(f"{d.name}: real={is_real}")
        return raw
    if d.name.startswith("pcqm4mv2-"):
        from escgnn_tpu_torch.data.molecules import pcqm4mv2_splits

        raw, is_real = pcqm4mv2_splits(d.dir, d.name.split("-", 1)[1],
                                       num_graphs=d.num_graphs, seed=seed)
        print(f"{d.name}: real={is_real}")
        return raw
    if d.name.startswith("tu-"):
        # IMDB-*/COLLAB ship no node labels: degree one-hots stand in
        from escgnn_tpu_torch.data.tu import get_tu_dataset

        return _even_splits(get_tu_dataset(d.name[3:],
                                           root=os.path.join(d.dir, "TU")))
    raise ValueError(f"unknown dataset {d.name!r}")


def build_dataset(cfg, seed: int):
    """(splits, mean, std): the featurized splits (ESC pre-transform, SPD
    bias, positional encodings, through the feature cache) with their
    targets standardized as the JAX driver does."""
    d, m = cfg.dataset, cfg.model
    ecfg = EscConfig(h=d.esc.h, use_rd=d.esc.use_rd,
                     self_loop=d.esc.self_loop,
                     max_nodes_per_hop=d.esc.max_nodes_per_hop or None)
    lap = m.use_lap_pe or m.use_signnet or m.use_equivstable_pe
    splits = {}
    for name, graphs in _raw_splits(cfg, seed).items():
        def make(graphs=graphs):
            out = (featurize_many(graphs, ecfg, num_workers=0)
                   if d.esc.enable else list(graphs))
            if d.attn_bias:
                out = attach_attn_bias_many(out)
            if lap:
                out = [attach_lap_pe(g, k=cfg.posenc.lap_pe_k) for g in out]
            if m.use_rwse:
                out = [attach_rwse(g, k=cfg.posenc.rwse_k) for g in out]
            if m.use_degree:
                out = [attach_degree(g) for g in out]
            return out

        key = (f"gps_{d.name}_{name}_n{d.num_graphs}_s{seed}_"
               f"{ecfg.cache_key()}_bias{int(d.attn_bias)}_pe{int(lap)}"
               f"{int(m.use_rwse)}{int(m.use_degree)}")
        splits[name] = cached_featurize(os.path.join(d.dir, "gps_" + d.name),
                                        key, make)
    if d.name in ("count_cycle", "count_graphlet"):
        from escgnn_tpu_torch.data.counting import normalize_targets

        return normalize_targets(splits, d.target)
    if d.task in CLASS_TASKS:
        return splits, 0.0, 1.0
    if d.name == "qm9-synthetic":
        width = len(splits["train"][0].y)
        if not 0 <= d.target < width:
            raise ValueError(f"dataset.target {d.target} out of range for "
                             f"qm9 y width {width}")
        for s in splits.values():
            for g in s:
                g.y = g.y[d.target:d.target + 1]
    ys = np.stack([np.asarray(g.y).reshape(-1)
                   for s in ("train", "val") for g in splits[s]])
    if ys.shape[1] > 1:
        # multi-target regression: per-column standardization, the MAE
        # reported on the standardized targets (scale 1.0)
        mu, sd = ys.mean(axis=0), ys.std(axis=0, ddof=1).clip(1e-8)
        for s in splits.values():
            for g in s:
                g.y = ((np.asarray(g.y).reshape(-1) - mu) / sd).astype(
                    np.float32)
        return splits, float(mu.mean()), 1.0
    # nan-aware: pcqm4mv2-inference has unlabeled (NaN-y) splits
    mean, std = float(np.nanmean(ys)), float(np.nanstd(ys, ddof=1))
    for s in splits.values():
        for g in s:
            g.y = ((g.y - mean) / std).astype(np.float32)
    return splits, mean, std


def _avg_deg_log(graphs) -> float:
    """E[log(1 + deg)] over the training graphs (the PNA scaler
    normalizer)."""
    logs = []
    for g in graphs:
        deg = np.bincount(np.asarray(g.edge_index[1]),
                          minlength=g.num_nodes)[:g.num_nodes]
        logs.append(np.log1p(deg))
    v = float(np.mean(np.concatenate(logs))) if logs else 1.0
    return max(v, 1e-3)


def _gps_config(cfg, splits) -> GPSConfig:
    m = cfg.model
    kw = {}
    for k in ("pna_towers", "avg_deg_log", "bigbird_window",
              "bigbird_global", "bigbird_random"):
        if hasattr(m, k):
            kw[k] = getattr(m, k)
    if kw.get("avg_deg_log", 0.0) == 0.0:
        # 0 = sentinel: derive E[log(1+deg)] from the train split
        if m.local_model == "pna":
            kw["avg_deg_log"] = _avg_deg_log(splits["train"])
        else:
            kw.pop("avg_deg_log", None)
    return GPSConfig(
        dim_h=m.dim_h, num_layers=m.num_layers, num_heads=m.num_heads,
        dropout=m.dropout, attn_dropout=m.attn_dropout,
        local_model=m.local_model, global_model=m.global_model,
        san_gamma=m.san_gamma, performer_features=m.performer_features,
        use_equivstable_pe=m.use_equivstable_pe, use_esc=m.use_esc,
        use_attn_bias=m.use_attn_bias, use_lap_pe=m.use_lap_pe,
        use_signnet=m.use_signnet, use_rwse=m.use_rwse,
        use_degree=m.use_degree, pool=m.pool, out_dim=m.out_dim,
        graph_pred=m.graph_pred, node_vocab=m.node_vocab,
        edge_vocab=m.edge_vocab,
        node_encoder_kind=cfg.dataset.node_encoder,
        edge_encoder_kind=cfg.dataset.edge_encoder,
        head="inductive_edge" if cfg.dataset.task == "link" else "default",
        **kw)


def _width(a, rows: int) -> int:
    return int(np.asarray(a).reshape(rows, -1).shape[1]) if a is not None \
        else 1


def build_model(cfg, splits, seed: int, device) -> GPSModel:
    """The run's model: weights drawn from `seed`, dropout's generator
    seeded with it too; the linear encoders' input widths read from the
    train split's first graph."""
    g0 = splits["train"][0]
    return GPSModel(_gps_config(cfg, splits),
                    node_dim=_width(g0.x, g0.num_nodes),
                    edge_dim=_width(g0.edge_attr, g0.num_edges),
                    lap_k=cfg.posenc.lap_pe_k, rwse_k=cfg.posenc.rwse_k,
                    device=device, generator=torch.Generator().manual_seed(
                        seed), rng_seed=seed)


def _loss_fn(cfg):
    task = cfg.dataset.task
    if task == "classification":
        return ce_graph_loss
    if task == "multilabel":
        return bce_graph_loss
    if task == "node_classification":
        return ce_node_loss
    if task == "link":
        return link_pair_loss
    if task == "sequence":
        from escgnn_tpu_torch.data.code2 import MAX_SEQ_LEN, NUM_VOCAB

        vocab = NUM_VOCAB + 2  # + EOS + UNK
        if cfg.model.out_dim != MAX_SEQ_LEN * vocab:
            raise ValueError(f"sequence task needs model.out_dim = "
                             f"{MAX_SEQ_LEN * vocab} (L * vocab)")
        return make_sequence_ce_loss(MAX_SEQ_LEN, vocab)
    return l1_graph_loss if cfg.model.graph_pred else l1_node_loss


def _metric_name(cfg) -> str:
    task = cfg.dataset.task
    use_auc = task == "multilabel" and cfg.metric == "auc"
    return {"classification": "acc", "multilabel": "AUC" if use_auc else "AP",
            "node_classification": "F1", "sequence": "F1",
            "link": "MRR"}.get(task, "MAE")


@torch.no_grad()
def link_scores(model, stacked, M: int) -> np.ndarray:
    """(B, G, M, M) dot-product scores of each graph's node embeddings,
    over every batch of a stacked split (running statistics)."""
    out = []
    with running_statistics(model):
        for i in range(pool_size(stacked)):
            b = pool_entry(stacked, i)
            dense = DenseGrid(b, M).scatter(model(b))
            out.append(torch.einsum("gmd,gnd->gmn", dense, dense))
    return torch.stack(out).cpu().numpy()


def link_eval(model, stacked, graphs, spec) -> dict:
    """Mean MRR and hits@k over the graphs with positive pairs."""
    scores = link_scores(model, stacked, spec.max_nodes_per_graph)
    NG, agg = spec.num_graphs, {}
    for j, g in enumerate(graphs):
        st = graph_link_mrr(scores[j // NG, j % NG],
                            np.asarray(g.extras["pair_index"]),
                            np.asarray(g.extras["pair_label"]), g.num_nodes)
        for k, v in st.items():
            agg.setdefault(k, []).append(v)
    return {k: float(np.mean(v)) for k, v in agg.items()}


def _class_metric(cfg, logits_pool, stacked) -> float:
    """The split's classification metric from one logits pass over its
    stacked batches (node rows under node_classification)."""
    outs, ys, masks = (t.cpu().numpy() for t in logits_pool(stacked))
    task = cfg.dataset.task
    if task == "node_classification":
        # labels < 0 lie outside the split's nodes and drop out
        m = masks.reshape(-1).astype(bool) & (ys.reshape(-1) >= 0)
        pred = outs.reshape(-1, outs.shape[-1])[m].argmax(-1)
        return macro_f1(ys.reshape(-1)[m].astype(np.int64), pred)
    m = masks.reshape(-1).astype(bool)
    out = outs.reshape(-1, outs.shape[-1])[m]
    y = ys.reshape(-1, ys.shape[-1])[m]
    if task == "classification":
        return float((out.argmax(-1) == y.reshape(-1)).mean())
    if task == "sequence":
        from escgnn_tpu_torch.data.code2 import (
            MAX_SEQ_LEN,
            NUM_VOCAB,
            subtoken_f1,
        )

        pred = out.reshape(-1, MAX_SEQ_LEN, NUM_VOCAB + 2).argmax(-1)
        return subtoken_f1(pred, y.astype(np.int64))
    use_auc = cfg.metric == "auc"
    v = (rocauc if use_auc else average_precision)(y, out)
    if np.isnan(v):
        warnings.warn(f"{_metric_name(cfg)} undefined on this split "
                      "(degenerate labels); reporting NaN")
    return v


def _load_pretrained(cfg, model, seed: int) -> list:
    """Restore the body (and optionally the head) from the pretrained
    checkpoint; returns the parameters to freeze."""
    pre = CheckpointManager(cfg.pretrained.dir)
    if pre.latest_step() is None:
        raise ValueError(f"pretrained.dir {cfg.pretrained.dir!r} has no "
                         f"checkpoint")
    tree = pre.restore()
    fresh = {k: p.detach().clone() for k, p in model.named_parameters()
             if k.split(".")[0] in HEAD_KEYS}
    load_model_tree(model, {"params": tree["params"],
                            "batch_stats": tree["batch_stats"]})
    if cfg.pretrained.reset_prediction_head:
        params = dict(model.named_parameters())
        with torch.no_grad():
            for k, v in fresh.items():
                params[k].copy_(v)
    print(f"[seed {seed}] loaded pretrained params from "
          f"{cfg.pretrained.dir} (reset_head="
          f"{cfg.pretrained.reset_prediction_head})")
    if not cfg.pretrained.freeze_main:
        return []
    return [p for k, p in model.named_parameters()
            if k.split(".")[0] not in HEAD_KEYS]


def run_one(cfg, seed: int, out_dir: str, device) -> dict:
    """Train one seed; returns the JAX driver's numbers (best val / test
    metric times the target std, best epoch, train seconds, hits@k on the
    link task) and `epochs`, one record per epoch."""
    device = resolve_device(device)
    splits, mean, std = build_dataset(cfg, seed)
    all_graphs = [g for s in splits.values() for g in s]
    spec = BatchSpec.from_graphs(all_graphs, batch_size=cfg.train.batch_size)
    model = build_model(cfg, splits, seed, device)
    frozen = _load_pretrained(cfg, model, seed) if cfg.pretrained.dir else []
    opt = adam_with_plateau(model.parameters(), cfg.optim.base_lr,
                            capturable=device.type == "cuda", frozen=frozen)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[seed {seed}] params: {n_params / 1e6:.2f}M")
    sched = PlateauScheduler(factor=cfg.optim.lr_decay_factor,
                             patience=cfg.optim.patience,
                             min_lr=cfg.optim.min_lr)
    ckpt = CheckpointManager(os.path.join(out_dir, f"ckpt_s{seed}"))
    steps_per_epoch = max(1, len(splits["train"]) // cfg.train.batch_size)
    start_epoch, step = 1, 0
    if cfg.train.auto_resume and ckpt.latest_step() is not None:
        step = restore_train_state(ckpt, model, opt)
        start_epoch = step // steps_per_epoch + 1
        print(f"[seed {seed}] auto-resumed at epoch {start_epoch}")

    np_rng = np.random.default_rng(seed)
    [train_stack], n_train_batches, _ = stacked_batch_pools(
        splits["train"], spec, k=1, seed=seed, device=device)
    val_stack = stack_split(splits["val"], spec, device)
    test_stack = stack_split(splits["test"], spec, device)
    refresh_stack = stack_split(splits["train"][:8 * cfg.train.batch_size],
                                spec, device)
    task = cfg.dataset.task
    pool_step = make_pool_train_step(model, opt, _loss_fn(cfg), train_stack)
    eval_pool = make_pool_eval_step(model, node_level=not cfg.model.graph_pred)
    logits_pool = make_pool_logits_step(
        model, node_level=task == "node_classification")
    refresh_pool = make_pool_refresh_step(model)
    higher_better = task in CLASS_TASKS
    metric_name = _metric_name(cfg)
    link_stats = {}

    def evaluate(stacked, graphs, split_name):
        if task == "link":
            link_stats[split_name] = link_eval(model, stacked, graphs, spec)
            return link_stats[split_name].get("mrr", 0.0)
        if task == "regression":
            e, c = eval_pool(stacked)
            return float(e) / max(float(c), 1.0)
        return _class_metric(cfg, logits_pool, stacked)

    def save(force: bool):
        tree = train_state_tree(model, opt, step)
        if force or step not in ckpt.all_steps():
            ckpt.save(step, tree, force=force)

    sign = -1.0 if higher_better else 1.0
    best_val, best_test, best_epoch = float("inf"), float("nan"), -1
    best_link: dict = {}
    epochs = []
    t0 = time.time()
    for epoch in range(start_epoch, cfg.train.epochs + 1):
        t_ep = time.time()
        losses = pool_step(train_stack, np_rng.permutation(n_train_batches))
        loss = float(losses.mean())
        step += n_train_batches
        train_s = time.time() - t_ep
        rec = dict(epoch=epoch, loss=loss, train_seconds=train_s,
                   steps=n_train_batches)
        if epoch % cfg.train.eval_period == 0:
            refresh_pool(refresh_stack)
            val = evaluate(val_stack, splits["val"], "val")
            test = evaluate(test_stack, splits["test"], "test")
            if sign * val < best_val:
                best_val = sign * val
                best_test, best_epoch = test, epoch
                if task == "link":
                    best_link = dict(link_stats.get("test", {}))
                if cfg.train.ckpt_best:
                    save(force=True)
            if cfg.optim.scheduler == "plateau":
                set_learning_rate(opt, sched.step(sign * val,
                                                  get_learning_rate(opt)))
            lr = get_learning_rate(opt)
            print(f"[seed {seed}] epoch {epoch:03d} lr {lr:.6f} loss "
                  f"{loss:.5f} val {metric_name} {val * std:.5f} test "
                  f"{metric_name} {test * std:.5f}", flush=True)
            rec.update(val=val * std, test=test * std, lr=lr)
        if epoch % cfg.train.ckpt_period == 0:
            save(force=False)
        rec["seconds"] = time.time() - t_ep
        epochs.append(rec)
    if best_epoch == -1:
        # no eval epoch ran (epochs < eval_period): the final state
        refresh_pool(refresh_stack)
        best_val = sign * evaluate(val_stack, splits["val"], "val")
        best_test = evaluate(test_stack, splits["test"], "test")
        best_epoch = cfg.train.epochs
        if task == "link":
            best_link = dict(link_stats.get("test", {}))
    key = metric_name.lower()
    out = {f"best_val_{key}": sign * best_val * std,
           f"best_test_{key}": best_test * std,
           "best_epoch": best_epoch, "train_time_s": time.time() - t0}
    for k, v in best_link.items():
        if k != "mrr":
            out[f"best_test_{k}"] = v
    out["epochs"] = epochs
    return out


def run_eval_only(cfg, ckpt_dir: str, device):
    """Restore the latest checkpoint of `ckpt_dir` and print its val and
    test metric as one JSON line; returns (model, splits, spec, the
    printed numbers)."""
    device = resolve_device(device)
    splits, mean, std = build_dataset(cfg, cfg.seed)
    all_graphs = [g for s in splits.values() for g in s]
    spec = BatchSpec.from_graphs(all_graphs, batch_size=cfg.train.batch_size)
    model = build_model(cfg, splits, cfg.seed, device)
    step = restore_train_state(CheckpointManager(ckpt_dir), model)
    if step is None:
        raise ValueError(f"{ckpt_dir!r} has no checkpoint")
    task = cfg.dataset.task
    logits_pool = make_pool_logits_step(
        model, node_level=task == "node_classification")

    def evaluate(graphs):
        if task == "link":
            stats = link_eval(model, stack_split(graphs, spec, device),
                              graphs, spec)
            return stats.get("mrr", 0.0)
        if task != "regression":
            return _class_metric(cfg, logits_pool,
                                 stack_split(graphs, spec, device))
        tot = cnt = 0.0
        for b in batch_iterator(graphs, spec, device=device):
            s, c = eval_step(model, b, node_level=not cfg.model.graph_pred)
            tot += float(s)
            cnt += float(c)
        return tot / max(cnt, 1.0)

    key = _metric_name(cfg).lower()
    res = {f"val_{key}": evaluate(splits["val"]) * std,
           f"test_{key}": evaluate(splits["test"]) * std,
           "ckpt_step": int(step)}
    print(json.dumps(res))
    return model, splits, spec, res


@torch.no_grad()
def dump_attention(model, splits, spec, out_path: str, device) -> dict:
    """Every dense attention's weights (G, heads, M, M) on the first test
    batch, saved to one npz under JAX's keys (`layer<i>/self_attn`)."""
    b = next(batch_iterator(splits["test"], spec, device=device))
    with running_statistics(model):
        _, weights = model(b, return_attention=True)
    out = {k: v.cpu().numpy() for k, v in weights.items()}
    if not out:
        raise SystemExit(
            "no attention weights captured — the config's global model has "
            "no dense attention (try global_model transformer/bigbird)")
    np.savez_compressed(out_path, **out)
    print(f"dumped {len(out)} attention tensors to {out_path}: "
          f"{sorted(out)[:4]}...")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m escgnn_tpu_torch.run_gps")
    p.add_argument("--cfg", default=None, help="YAML config path")
    p.add_argument("--eval_only", default=None, metavar="CKPT_DIR",
                   help="restore the checkpoint dir and only evaluate")
    p.add_argument("--dump_attn", default=None, metavar="NPZ_PATH",
                   help="with --eval_only: also dump per-layer attention "
                        "weights of the first test batch")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs only when named")
    p.add_argument("opts", nargs="*", help="dotted key value overrides")
    return p


def main(argv=None) -> dict:
    """Run the config; returns {'runs', 'agg', 'out_dir'} (each run's
    numbers with its per-epoch records), or with `--eval_only` the
    printed metrics (and `attn`, the dumped weights)."""
    args = build_parser().parse_intermixed_args(argv)
    cfg = load_cfg(args.cfg, args.opts)
    device = resolve_device(args.device)
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.eval_only:
        model, splits, spec, res = run_eval_only(cfg, args.eval_only, device)
        if args.dump_attn:
            res = dict(res, attn=dump_attention(model, splits, spec,
                                                args.dump_attn, device))
        return res
    out_dir = os.path.join(cfg.out_dir, time.strftime("%Y%m%d%H%M%S"))
    dump_cfg(cfg, out_dir)
    backup_run(out_dir, os.path.abspath(__file__), argv=[
        "-m", "escgnn_tpu_torch.run_gps",
        *(sys.argv[1:] if argv is None else argv)])
    results = []
    for run in range(cfg.num_runs):
        results.append(run_one(cfg, cfg.seed + run, out_dir, device))
        summary = {k: v for k, v in results[-1].items() if k != "epochs"}
        print(f"[run {run}] {summary}")
    plain = [{k: v for k, v in r.items() if k != "epochs"} for r in results]
    agg = agg_runs(plain)
    with open(os.path.join(out_dir, "agg.json"), "w") as f:
        json.dump({"runs": plain, "agg": agg}, f, indent=2)
    print("aggregated:", json.dumps(agg))
    return dict(runs=results, agg=agg, out_dir=out_dir)


if __name__ == "__main__":
    main()
