"""Node-level cycle-prediction trainers (counterpart of
`escgnn_tpu/train/cycles.py`, the reference's `kernel/train_eval.py:333-691`):

  * `train_val_cycles`: one graph, a random node split, BCE on binarized
    per-node cycle counts; accuracy / ROC-AUC / average precision, best
    epoch by val AP.
  * `train_val_cycles_regression`: the same node split, MSE regression
    with deep-supervision aux losses at weight 0.1; best epoch by val MAE.
  * `train_val_cycles_regression_GC`: a graph-level split of a
    multi-graph dataset, the train graphs reshuffled and batched anew
    every epoch, aux losses at weight 1 / len(ys).

The targets and their row mask ride in each batch as the extras
`cycle_true` and `cycle_mask`, so a graphed train step (`train/loop.py`
`make_pool_train_step`) copies them into its buffers with the rest of
the batch: the single-graph trainers take one step per epoch on a pool
of one batch (the whole graph), `..._GC` one step per batch of a pool
rebuilt every epoch. Predictions run eagerly with the running BatchNorm
statistics. The metrics are numpy (`train/metrics.py`), equal to
sklearn's on binary columns.

Models must emit one row per original node (`node_level=True` on
`BaselineGNN`); `multi_layer=True` models return `(out, ys)`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from escgnn_tpu_torch.data.batching import (
    BatchSpec,
    batch_arrays,
    batch_from_arrays,
)
from escgnn_tpu_torch.data.container import EXTRAS_PREFIX, GraphData
from escgnn_tpu_torch.data.prefetch import (
    pool_entry,
    pool_size,
    stack_batches,
)
from escgnn_tpu_torch.train.loop import (
    adam_with_plateau,
    make_pool_train_step,
    running_statistics,
    set_learning_rate,
)
from escgnn_tpu_torch.train.metrics import average_precision, rocauc

TRUE, MASK = "cycle_true", "cycle_mask"


def node_split(
    num_nodes: int, split_ratio: float, seed: int = 1234
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random (train, val, test) node index split: `split_ratio` train,
    the rest halved (reference `kernel/train_eval.py:385-389`)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(num_nodes)
    a = int(split_ratio * num_nodes)
    b = int((split_ratio + 1) / 2 * num_nodes)
    return idx[:a], idx[a:b], idx[b:]


def _split_mask(rows: int, part: np.ndarray) -> np.ndarray:
    m = np.zeros(rows, bool)
    m[part] = True
    return m


def _normalize_out(res):
    """Model output -> (out, ys); a plain-tensor model has no aux heads."""
    if isinstance(res, tuple):
        return res
    return res, []


def _row_layout(batch) -> tuple[int, np.ndarray]:
    """(rows, row_mask) of the model's per-original-node output: copy rows
    for node-copy models, node rows otherwise."""
    if batch.node_segment is not None:
        return batch.segment_mask.shape[0], batch.segment_mask.numpy()
    return batch.node_mask.shape[0], batch.node_mask.numpy()


@dataclasses.dataclass
class CycleResult:
    best_val: float
    test_metrics: tuple  # metrics at the best-val epoch
    history: list
    duration: float


def _masked_mse(pred, true, mask):
    d = (pred - true) ** 2
    m = mask.to(d.dtype)[:, None]
    return (d * m).sum() / (m.sum() * d.shape[-1]).clamp_min(1.0)


def _masked_bce(logits, true, mask):
    per = (logits.clamp_min(0) - logits * true
           + torch.log1p(torch.exp(-logits.abs())))
    m = mask.to(per.dtype)[:, None]
    return (per * m).sum() / (m.sum() * per.shape[-1]).clamp_min(1.0)


def make_cycle_loss(kind: str, aux_scale: Optional[Callable] = None):
    """`loss(model_output, batch)` against the batch's `cycle_true` rows
    under its `cycle_mask`: 'bce' or 'mse' over the columns the output
    and the targets share; `aux_scale(len(ys)) -> weight` adds the
    deep-supervision MSE of each aux head (None: no aux loss)."""

    def loss(res, batch):
        out, ys = _normalize_out(res)
        true, mask = batch.extras[TRUE], batch.extras[MASK]
        w = min(out.shape[-1], true.shape[-1])
        fn = _masked_bce if kind == "bce" else _masked_mse
        total = fn(out[:, :w], true[:, :w], mask)
        if aux_scale is not None and ys:
            w_aux = aux_scale(len(ys))
            for a in ys:
                wa = min(a.shape[-1], true.shape[-1])
                total = total + w_aux * _masked_mse(a[:, :wa], true[:, :wa],
                                                    mask)
        return total

    return loss


def _with_targets(batch, true: np.ndarray, mask: np.ndarray):
    """A host batch with the targets and their row mask as extras."""
    t = batch.tensors()
    t[EXTRAS_PREFIX + TRUE] = torch.from_numpy(np.ascontiguousarray(true))
    t[EXTRAS_PREFIX + MASK] = torch.from_numpy(np.ascontiguousarray(mask))
    return batch.with_tensors(t)


@torch.no_grad()
def _predict(model, batch) -> np.ndarray:
    with running_statistics(model):
        out, _ = _normalize_out(model(batch))
    return out.float().cpu().numpy()


def _cls_metrics(true: np.ndarray, logits: np.ndarray):
    """(accuracy, roc_auc, ap) over binarized multi-column labels,
    column-averaged, columns of one class skipped (NaN when none is
    left), as the JAX package computes them with sklearn."""
    pred = (logits > 0).astype(np.int64)
    acc = float(np.mean(true.reshape(-1) == pred.reshape(-1)))
    return acc, rocauc(true, logits), average_precision(true, logits)


def _reg_metrics(true: np.ndarray, pred: np.ndarray):
    """(mse, mae, rmse) — reference `eval_cycle_regression`."""
    d = pred - true
    mse = float(np.mean(d * d))
    return mse, float(np.mean(np.abs(d))), float(np.sqrt(mse))


def _optimizer(model, lr, weight_decay, device):
    return adam_with_plateau(model.parameters(), lr,
                             capturable=device.type == "cuda",
                             weight_decay=weight_decay)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _single_graph_setup(graph, cycles):
    """(host batch of the whole graph, real rows, padded targets)."""
    spec = BatchSpec.from_graphs([graph], batch_size=1)
    batch = batch_from_arrays(batch_arrays([graph], spec), spec, "cpu")
    rows, row_mask = _row_layout(batch)
    cycles = np.asarray(cycles, np.float32)
    n = int(cycles.shape[0])
    if not row_mask[:n].all():
        raise ValueError("cycle labels must cover the real rows")
    true = np.zeros((rows, cycles.shape[1]), np.float32)
    true[:n] = cycles
    return batch, n, true


class _StepDecay:
    """The learning rate times `factor` every `step_size` epochs."""

    def __init__(self, opt, lr, factor, step_size):
        self.opt, self.lr = opt, lr
        self.factor, self.step_size = factor, step_size

    def __call__(self, epoch: int) -> None:
        if self.step_size and epoch % self.step_size == 0:
            self.lr *= self.factor
            set_learning_rate(self.opt, self.lr)


def _single_graph_trainer(graph, cyc, model, kind, aux_scale, *,
                          split_ratio, lr, lr_decay_factor,
                          lr_decay_step_size, weight_decay, seed):
    """((train, val, test) node ids, epoch() -> loss, predict() ->
    logits, decay(epoch)): one graphed step per epoch on the whole graph,
    the train rows masked in."""
    batch, n, true = _single_graph_setup(graph, cyc)
    tr, va, te = node_split(n, split_ratio, seed)
    device = _device(model)
    pool = stack_batches([_with_targets(batch, true, _split_mask(
        true.shape[0], tr))]).to(device)
    opt = _optimizer(model, lr, weight_decay, device)
    step = make_pool_train_step(model, opt, make_cycle_loss(kind, aux_scale),
                                pool)
    decay = _StepDecay(opt, lr, lr_decay_factor, lr_decay_step_size)
    first = pool_entry(pool, 0)
    return ((tr, va, te), lambda: float(step(pool, [0])[0]),
            lambda: _predict(model, first), decay)


def train_val_cycles(
    graph: GraphData,
    cycles: np.ndarray,
    model: torch.nn.Module,
    *,
    split_ratio: float = 0.3,
    epochs: int = 100,
    lr: float = 1e-2,
    lr_decay_factor: float = 0.5,
    lr_decay_step_size: int = 50,
    weight_decay: float = 0.0,
    seed: int = 1234,
    logger: Optional[Callable[[str], None]] = None,
) -> CycleResult:
    """Binary cycle-membership classification on one graph's node split
    (reference `train_val_cycles`, `kernel/train_eval.py:359-444`)."""
    t0 = time.perf_counter()
    cyc = (np.asarray(cycles) != 0).astype(np.float32)
    (tr, va, te), epoch_step, predict, decay = _single_graph_trainer(
        graph, cyc, model, "bce", None, split_ratio=split_ratio, lr=lr,
        lr_decay_factor=lr_decay_factor,
        lr_decay_step_size=lr_decay_step_size, weight_decay=weight_decay,
        seed=seed)
    history, cur_val, cur_test = [], [], []
    for epoch in range(1, epochs + 1):
        loss = epoch_step()
        logits = predict()[:, :cyc.shape[1]]
        cur_val.append(_cls_metrics(cyc[va], logits[va])[2])
        cur_test.append(_cls_metrics(cyc[te], logits[te]))
        history.append({"epoch": epoch, "train_loss": loss,
                        "val_ap": cur_val[-1], "test_ap": cur_test[-1][2]})
        if logger:
            logger(f"epoch {epoch:03d} loss {loss:.4f} "
                   f"val_ap {cur_val[-1]:.4f} test_ap {cur_test[-1][2]:.4f}")
        decay(epoch)
    # best val AP; all-NaN val AP (degenerate split columns) falls back
    # to the last epoch
    vals = np.asarray(cur_val)
    best = (int(np.nanargmax(vals)) if not np.isnan(vals).all()
            else len(vals) - 1)
    return CycleResult(best_val=cur_val[best], test_metrics=cur_test[best],
                       history=history, duration=time.perf_counter() - t0)


def train_val_cycles_regression(
    graph: GraphData,
    cycles: np.ndarray,
    model: torch.nn.Module,
    *,
    split_ratio: float = 0.3,
    epochs: int = 100,
    lr: float = 1e-2,
    lr_decay_factor: float = 0.5,
    lr_decay_step_size: int = 50,
    weight_decay: float = 0.0,
    seed: int = 1234,
    logger: Optional[Callable[[str], None]] = None,
) -> CycleResult:
    """Per-node cycle-count regression on one graph's node split with
    deep-supervision aux losses `/10` (reference
    `train_val_cycles_regression`, `kernel/train_eval.py:446-561`)."""
    t0 = time.perf_counter()
    cyc = np.asarray(cycles, np.float32)
    (tr, va, te), epoch_step, predict, decay = _single_graph_trainer(
        graph, cyc, model, "mse", lambda k: 0.1, split_ratio=split_ratio,
        lr=lr, lr_decay_factor=lr_decay_factor,
        lr_decay_step_size=lr_decay_step_size, weight_decay=weight_decay,
        seed=seed)
    history, cur_val, cur_test = [], [], []
    for epoch in range(1, epochs + 1):
        loss = epoch_step()
        pred = predict()
        w = min(pred.shape[1], cyc.shape[1])
        cur_val.append(_reg_metrics(cyc[va, :w], pred[va, :w])[1])
        cur_test.append(_reg_metrics(cyc[te, :w], pred[te, :w]))
        history.append({"epoch": epoch, "train_loss": loss,
                        "val_mae": cur_val[-1], "test_mae": cur_test[-1][1]})
        if logger:
            logger(f"epoch {epoch:03d} loss {loss:.4f} "
                   f"val_mae {cur_val[-1]:.4f} "
                   f"test_mae {cur_test[-1][1]:.4f}")
        decay(epoch)
    best = int(np.argmin(cur_val))  # best val MAE
    return CycleResult(best_val=cur_val[best], test_metrics=cur_test[best],
                       history=history, duration=time.perf_counter() - t0)


def _chunk_targets(chunk: Sequence[GraphData], cycles, spec, width):
    """Padded (rows, width) targets + row mask for one batch chunk: rows
    are copies for node-copy graphs (contiguous per graph), nodes
    otherwise."""
    nested = bool((chunk[0].extras or {}).get("num_subgraphs", 0))
    rows = spec.num_segments if nested else spec.num_nodes
    t = np.zeros((rows, width), np.float32)
    m = np.zeros(rows, bool)
    off = 0
    for g, c in zip(chunk, cycles):
        k = int((g.extras or {})["num_subgraphs"]) if nested else g.num_nodes
        c = np.asarray(c, np.float32)
        if c.shape[0] != k:
            raise ValueError(f"cycle labels of {c.shape[0]} rows for a "
                             f"graph of {k}")
        t[off:off + k] = c[:, :width]
        m[off:off + k] = True
        off += k
    return t, m


def train_val_cycles_regression_GC(
    graphs: Sequence[GraphData],
    cycles: Sequence[np.ndarray],
    model: torch.nn.Module,
    *,
    split_ratio: float = 0.3,
    epochs: int = 100,
    batch_size: int = 32,
    lr: float = 1e-2,
    lr_decay_factor: float = 0.5,
    lr_decay_step_size: int = 50,
    weight_decay: float = 0.0,
    seed: int = 1234,
    logger: Optional[Callable[[str], None]] = None,
) -> CycleResult:
    """Graph-split cycle regression over a multi-graph dataset with
    batched loaders; aux losses `/ len(ys)` (reference
    `train_val_cycles_regression_GC`, `kernel/train_eval.py:564-691`)."""
    t0 = time.perf_counter()
    rng_np = np.random.default_rng(seed)
    g_idx = rng_np.permutation(len(graphs))
    a = int(split_ratio * len(graphs))
    b = int((split_ratio + 1) / 2 * len(graphs))
    tr, va, te = g_idx[:a], g_idx[a:b], g_idx[b:]

    spec = BatchSpec.from_graphs(list(graphs), batch_size=batch_size)
    if spec.uniform_nodes:
        raise ValueError("dense uniform layout unsupported here")
    width = int(np.asarray(cycles[0]).shape[1])
    device = _device(model)

    def pool_of(ids):
        """(stacked batches of `ids` in order with their targets, the
        host row masks)."""
        batches, masks = [], []
        for i in range(0, len(ids), batch_size):
            chunk_ids = ids[i:i + batch_size]
            chunk = [graphs[j] for j in chunk_ids]
            host = batch_from_arrays(batch_arrays(chunk, spec), spec, "cpu")
            t, m = _chunk_targets(chunk, [cycles[j] for j in chunk_ids],
                                  spec, width)
            batches.append(_with_targets(host, t, m))
            masks.append(m)
        return stack_batches(batches).to(device), masks

    va_pool, te_pool = pool_of(va), pool_of(te)

    def eval_metrics(pool):
        stacked, masks = pool
        preds, trues = [], []
        for i, m in enumerate(masks):
            b = pool_entry(stacked, i)
            out = _predict(model, b)
            w = min(out.shape[1], width)
            preds.append(out[m, :w])
            trues.append(b.extras[TRUE].cpu().numpy()[m, :w])
        return _reg_metrics(np.concatenate(trues), np.concatenate(preds))

    opt = _optimizer(model, lr, weight_decay, device)
    loss_fn = make_cycle_loss("mse", lambda k: 1.0 / k)
    decay = _StepDecay(opt, lr, lr_decay_factor, lr_decay_step_size)
    step = None
    history, cur_val, cur_test = [], [], []
    for epoch in range(1, epochs + 1):
        # the train ids reshuffled and batched anew every epoch
        train_pool, _ = pool_of(rng_np.permutation(tr))
        if step is None:
            step = make_pool_train_step(model, opt, loss_fn, train_pool)
        losses = step(train_pool, range(pool_size(train_pool)))
        loss = float(losses.double().cpu().numpy().sum()) / max(
            len(losses), 1)
        cur_val.append(eval_metrics(va_pool)[1])
        cur_test.append(eval_metrics(te_pool))
        history.append({"epoch": epoch, "train_loss": loss,
                        "val_mae": cur_val[-1], "test_mae": cur_test[-1][1]})
        if logger:
            logger(f"epoch {epoch:03d} loss {loss:.4f} "
                   f"val_mae {cur_val[-1]:.4f} "
                   f"test_mae {cur_test[-1][1]:.4f}")
        decay(epoch)
    best = int(np.argmin(cur_val))
    return CycleResult(best_val=cur_val[best], test_metrics=cur_test[best],
                       history=history, duration=time.perf_counter() - t0)
