"""Training loop building blocks (counterpart of `escgnn_tpu/train/loop.py`).

Adam + L1/CE/BCE losses + ReduceLROnPlateau, as PyTorch that updates the
model in place:
  * `train_step`: forward (BatchNorm in batch-statistics mode),
    backward, one Adam update (with optax's global-norm clip when the
    optimizer has one);
  * `make_pool_train_step`: a whole epoch over a device-resident stacked
    pool (`data/prefetch.py`) in a given order, the counterpart of the
    JAX package's one jitted `lax.scan` per epoch. Each step copies its
    batch into static buffers; on a CUDA device one train step over those
    buffers is captured into a CUDA graph and replayed per batch. A
    compressed pool's decoder (`decode=`, `data/compress.py`) runs inside
    that step, and in the pool eval, refresh and logits steps;
  * `eval_step` and `make_pool_eval_step`: (sum |err|, count) with the
    running BatchNorm statistics (`bn_mode="running"`) or the eval
    batch's own (`bn_mode="batch"`, running statistics left as they
    were), the model in `eval()` either way; on a CUDA device the pool
    eval replays one captured forward per batch (`_GraphedForwardPool`);
  * `make_accuracy_step` and `make_pergraph_correct_step`: classification
    eval with the running statistics, returning device tensors;
  * `make_pool_logits_step`: the logits of every batch of a stacked pool
    (graph or node rows) with the running statistics, for a metric
    computed on the host;
  * `refresh_bn_stats` and `make_pool_refresh_step`: the running
    statistics re-estimated as the exact average of per-batch moments,
    the pool refresh graphed on a CUDA device as the pool eval is.

BatchNorm's statistics mode is set on its own (`models/layers.py`
`set_use_running_average`, `bn_statistics`), apart from `model.training`:
every forward that JAX runs with `deterministic=True` runs here in
`eval()`, whichever statistics its BatchNorm uses. Dropout and random
node initialisation draw only in `train()`, from the generators the
model lists in `model.generators()` (none when it draws nothing); the
graphed pool step registers them with its CUDA graph, so each replay
draws new numbers.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.data.prefetch import pool_entry, pool_size
from escgnn_tpu_torch.models.layers import bn_statistics, set_use_running_average
from escgnn_tpu_torch.ops.segment import sorted_views
from escgnn_tpu_torch.utils import trace


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: keep g when ||g|| < max_norm,
    else scale it to g * max_norm / ||g|| (not `clip_grad_norm_`'s
    max_norm / (||g|| + 1e-6)). The choice is made on the device, so
    nothing waits for the host."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


class ClippedAdam(torch.optim.Adam):
    """torch.optim.Adam (b1 0.9, b2 0.999, eps 1e-8: optax.adam's update)
    whose step first zeroes the gradients of the `frozen` parameters (the
    JAX package's `optax.masked(set_to_zero)` ahead of Adam: a frozen
    parameter's update is exactly 0) and then clips the gradients by
    their global norm (`grad_clip` > 0), as the JAX package's optax chain
    does. `weight_decay` is Adam's coupled L2 (g + wd * p ahead of the
    moments: optax.add_decayed_weights ahead of adam), not AdamW's."""

    def __init__(self, params, lr, grad_clip: float = 0.0,
                 capturable: bool = False, frozen=(),
                 weight_decay: float = 0.0):
        super().__init__(params, lr=lr, capturable=capturable,
                         weight_decay=weight_decay)
        self.grad_clip = float(grad_clip)
        self.frozen = list(frozen)

    # a copy (`copy.deepcopy`, pickle) keeps the clip and the frozen
    # parameters: the base class copies only its own state
    def __getstate__(self):
        return dict(super().__getstate__(), grad_clip=self.grad_clip,
                    frozen=self.frozen)

    @torch.no_grad()
    def step(self, closure=None):
        for p in self.frozen:
            if p.grad is not None:
                p.grad.zero_()
        if self.grad_clip > 0:
            clip_by_global_norm_(
                [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None], self.grad_clip)
        return super().step(closure)


def adam_with_plateau(params, lr: float, grad_clip: float = 0.0,
                      capturable: bool = False, frozen=(),
                      weight_decay: float = 0.0) -> ClippedAdam:
    """Adam whose learning rate the plateau scheduler (or a step decay)
    sets through `set_learning_rate`; `grad_clip` > 0 clips by global
    norm first; `weight_decay` > 0 adds coupled L2.
    `capturable=True` (for `make_pool_train_step` on a CUDA device) keeps
    the optimizer's step count and learning rate in device tensors, so
    the update can be captured into a CUDA graph. `frozen` parameters get
    zero gradients, hence zero updates."""
    params = list(params)
    if capturable:
        lr = torch.tensor(float(lr), dtype=torch.float32,
                          device=params[0].device)
    return ClippedAdam(params, lr, grad_clip=grad_clip,
                       capturable=capturable, frozen=frozen,
                       weight_decay=weight_decay)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """A device-tensor rate is filled in place (a captured step reads the
    same tensor); a float one is replaced."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def get_learning_rate(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


@dataclasses.dataclass
class PlateauScheduler:
    """ReduceLROnPlateau (mode=min) with torch semantics."""

    factor: float = 0.9
    patience: int = 10
    min_lr: float = 1e-5
    best: Optional[float] = None
    num_bad: int = 0

    def step(self, metric: float, lr: float) -> float:
        if self.best is None or metric < self.best:
            self.best = metric
            self.num_bad = 0
            return lr
        self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return max(lr * self.factor, self.min_lr)
        return lr


def l1_segment_loss(out: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Masked L1 over the copy rows against `extras['y_seg']`: the copy
    models' per-node heads, one copy row per original node (the JAX
    `run_zinc_cycle.py` loss)."""
    err = (out - batch.extras["y_seg"]).abs()
    m = batch.segment_mask.to(err.dtype)[:, None]
    return (err * m).sum() / (m.sum() * err.shape[-1]).clamp_min(1.0)


def l1_node_loss(out: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Masked mean-absolute-error over real nodes (node-level tasks)."""
    err = (out - batch.y).abs()
    m = batch.node_mask.to(err.dtype)[:, None]
    return (err * m).sum() / (m.sum() * err.shape[-1]).clamp_min(1.0)


def l1_graph_loss(out: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Masked mean-absolute-error over real graphs."""
    err = (out - batch.y).abs()
    m = batch.graph_mask.to(err.dtype)[:, None]
    return (err * m).sum() / (m.sum() * err.shape[-1]).clamp_min(1.0)


def ce_graph_loss(out: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Masked softmax cross-entropy over real graphs (classification)."""
    labels = batch.y.reshape(-1).long()
    nll = -F.log_softmax(out, dim=-1).gather(1, labels[:, None])[:, 0]
    m = batch.graph_mask.to(nll.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def ce_node_loss(out: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Masked softmax cross-entropy over real nodes; labels < 0 are
    outside the training node split and drop out."""
    labels = batch.y.reshape(-1).long()
    logp = F.log_softmax(out, dim=-1)
    nll = -logp.gather(1, labels.clamp_min(0)[:, None])[:, 0]
    m = batch.node_mask.to(nll.dtype) * (labels >= 0)
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def make_sequence_ce_loss(seq_len: int, vocab: int):
    """Masked mean cross-entropy over `seq_len` token positions: y (G, L)
    int token ids, logits (G, L * vocab) (the ogbg-code2 task shape)."""

    def loss(out: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        G = out.shape[0]
        logp = F.log_softmax(out.reshape(G, seq_len, vocab), dim=-1)
        labels = batch.y.reshape(G, seq_len).long()
        nll = -logp.gather(2, labels[:, :, None])[..., 0]
        m = batch.graph_mask.to(nll.dtype)[:, None]
        return (nll * m).sum() / (m.sum() * seq_len).clamp_min(1.0)

    return loss


def bce_graph_loss(out: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Masked sigmoid BCE over real graphs, NaN labels dropped (the one
    implementation is `train/metrics.py` `masked_bce_with_logits`)."""
    from escgnn_tpu_torch.train.metrics import masked_bce_with_logits

    return masked_bce_with_logits(out, batch)


def train_step(
    model: torch.nn.Module,
    opt: torch.optim.Optimizer,
    batch: GraphBatch,
    loss_fn: Callable[[torch.Tensor, GraphBatch], torch.Tensor],
) -> torch.Tensor:
    """One step: forward in train mode with BatchNorm on batch statistics
    (the running statistics are updated), backward, optimizer update.
    Returns the loss (computed before the update) as a detached tensor,
    without synchronizing. The step's sums share one `sorted_views()`
    scope."""
    model.train()
    set_use_running_average(model, False)
    opt.zero_grad(set_to_none=True)
    with sorted_views():
        loss = loss_fn(model(batch), batch)
        loss.backward()
    opt.step()
    return loss.detach()


# ---------------------------------------------------------------------------
# BatchNorm running statistics
# ---------------------------------------------------------------------------

# keep-fraction of the BatchNorm EMA (MaskedBatchNorm's momentum 0.1:
# new = 0.9 * old + 0.1 * batch). The refresh recovers a batch's own
# moments from one EMA update: batch = (new - 0.9 * old) / 0.1
BN_MOMENTUM = 0.9
_STAT_NAMES = ("running_mean", "running_var")


def _stat_buffers(model: torch.nn.Module) -> dict:
    """Every BatchNorm running statistic of `model` (the buffers
    themselves), by buffer name."""
    return {k: v for k, v in model.named_buffers()
            if k.rsplit(".", 1)[-1] in _STAT_NAMES}


def bn_stats(model: torch.nn.Module) -> dict:
    """A copy of every BatchNorm running statistic, by buffer name."""
    return {k: v.detach().clone() for k, v in _stat_buffers(model).items()}


def load_bn_stats(model: torch.nn.Module, stats: dict) -> None:
    """Write `stats` into the model's buffers in place (a captured step
    keeps reading the same tensors)."""
    bufs = dict(model.named_buffers())
    with torch.no_grad():
        for k, v in stats.items():
            bufs[k].copy_(v)


def recover_batch_moments(new_stats: dict, old_stats: dict) -> dict:
    return {k: (new_stats[k] - BN_MOMENTUM * old_stats[k])
            / (1.0 - BN_MOMENTUM) for k in new_stats}


@contextlib.contextmanager
def _batch_statistics(model: torch.nn.Module):
    """The model in `eval()` (JAX's `deterministic=True`) with BatchNorm
    on each batch's own statistics; the running statistics and the
    model's mode are put back as they were on exit."""
    saved = bn_stats(model)
    was_training = model.training
    model.eval()
    try:
        with bn_statistics(model, use_running_average=False):
            yield
    finally:
        load_bn_stats(model, saved)
        model.train(was_training)


@contextlib.contextmanager
def running_statistics(model: torch.nn.Module):
    """The model in `eval()` with BatchNorm on its running statistics
    (JAX's `deterministic=True, use_running_average=True`)."""
    model.eval()
    with bn_statistics(model, use_running_average=True):
        yield


def make_bn_refresh_step(model: torch.nn.Module):
    """`refresh(base_stats, batch) -> stats`: the running statistics one
    batch-statistics forward (model in `eval()`) over `batch` leaves when
    it starts from `base_stats` (parameters untouched; the model's
    statistics are put back afterwards).

    Why refresh: with trained embedding tables feeding pre-activation BN
    (the z_embedding path), activation scales move faster than the
    momentum-0.1 average follows, and eval with stale running statistics
    can be far off while the train loss is healthy."""

    @torch.no_grad()
    def refresh(base_stats: dict, batch: GraphBatch) -> dict:
        with _batch_statistics(model), sorted_views():
            load_bn_stats(model, base_stats)
            # the batch-statistics forward alone; the statistics' copies
            # around it fall to the enclosing `refresh` span
            with trace.span("refresh.forward"):
                model(batch)
            return bn_stats(model)

    return refresh


def refresh_bn_stats(refresh_step, model: torch.nn.Module, batches) -> None:
    """Set the model's running statistics to the EXACT average of the
    per-batch moments over `batches`: each refresh forward starts from the
    same base statistics, the batch's moments are recovered from the
    momentum update (`recover_batch_moments`) and averaged. A momentum
    walk over K batches would keep 0.9**K of the stale values."""
    base = bn_stats(model)
    acc, n = None, 0
    for b in batches:
        mb = recover_batch_moments(refresh_step(base, b), base)
        acc = mb if acc is None else {k: acc[k] + mb[k] for k in acc}
        n += 1
    if n:
        load_bn_stats(model, {k: v / n for k, v in acc.items()})


def _pool_batches(stacked: GraphBatch, decode=None):
    """The batches of a stacked pool in order, each through `decode` (a
    compressed pool's decoder, `data/compress.py`) when one is given."""
    for i in range(pool_size(stacked)):
        b = pool_entry(stacked, i)
        yield b if decode is None else decode(b)


def make_pool_refresh_step(model: torch.nn.Module, decode=None):
    """`refresh(stacked)`: `refresh_bn_stats` over every batch of a
    stacked pool (each through `decode` when given), forward-only.

    On the CPU it runs eagerly. On a CUDA device one batch's refresh (the
    base statistics copied into the buffers, the batch-statistics
    forward, the batch's recovered moments added into static sums) is a
    `_GraphedForwardPool` replayed per batch; the sums over the batch
    count become the running statistics. The arithmetic and its order are
    the eager path's (0 + x is exact)."""
    step = make_bn_refresh_step(model)
    base: dict = {}  # the base statistics the captured refresh reads

    def body(batch: GraphBatch) -> list:
        bufs = _stat_buffers(model)
        for k, v in bufs.items():
            v.copy_(base[k])
        with sorted_views():
            model(batch if decode is None else decode(batch))
        return list(recover_batch_moments(bufs, base).values())

    graphs = _GraphedForwardPool(model, body, "refresh", _batch_statistics)

    @torch.no_grad()
    def refresh(stacked: GraphBatch) -> None:
        if stacked.graph_mask.device.type == "cpu":
            # the whole refresh: forwards, statistics handling, host
            # enqueueing
            with trace.span("refresh"):
                refresh_bn_stats(step, model, _pool_batches(stacked, decode))
            trace.count("refresh.batches", pool_size(stacked))
            return
        if not base:  # the capture reads them
            base.update(bn_stats(model))
        graph = graphs.find(stacked)
        # the base copies, every replay (span `refresh.forward`) and the
        # average's loads
        with trace.span("refresh"):
            for k, v in _stat_buffers(model).items():
                base[k].copy_(v)
            sums = graph.run(stacked)
            n = pool_size(stacked)
            load_bn_stats(model, {k: v / n for k, v in zip(base, sums)})

    return refresh


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

_BN_MODES = ("running", "batch")


def _eval_statistics(bn_mode: str):
    """The context an eval forward runs in: `running_statistics` or
    `_batch_statistics`."""
    if bn_mode not in _BN_MODES:
        raise ValueError(f"bn_mode {bn_mode!r}: one of {_BN_MODES}")
    return _batch_statistics if bn_mode == "batch" else running_statistics


def _abs_err_sums(out: torch.Tensor, batch: GraphBatch, node_level: bool,
                  segment_level: bool) -> tuple:
    """(sum |out - y|, count) over the real rows `eval_step` names."""
    if segment_level:
        mask, y = batch.segment_mask, batch.extras["y_seg"]
    else:
        mask = batch.node_mask if node_level else batch.graph_mask
        y = batch.y
    err = (out - y).abs() * mask[:, None]
    return err.sum(), mask.sum() * out.shape[-1]


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: GraphBatch,
              node_level: bool = True, bn_mode: str = "running",
              segment_level: bool = False):
    """(sum |err|, count) over real rows, so a caller accumulates an exact
    dataset MAE across fixed-shape batches: node rows when `node_level`,
    else graph rows; copy rows against `extras['y_seg']` when
    `segment_level` (the copy models' per-node heads). `bn_mode="running"`
    normalizes with the running statistics; "batch" with the eval batch's
    own, leaving the running statistics untouched. The model is in
    `eval()` either way."""
    with _eval_statistics(bn_mode)(model), sorted_views(), \
            trace.span("eval.forward"):  # the model call alone
        out = model(batch)
    return _abs_err_sums(out, batch, node_level, segment_level)


def make_pool_eval_step(model: torch.nn.Module, node_level: bool = True,
                        bn_mode: str = "running",
                        segment_level: bool = False, decode=None):
    """`eval_pool(stacked) -> (sum |err|, count)` accumulated on the device
    over every batch of a stacked pool (each through `decode` when
    given), forward-only, as `eval_step` sums each batch.

    On the CPU it runs eagerly. On a CUDA device one batch's eval (decode,
    forward, error sums added into static sums, in batch order as the
    eager chain adds them) is a `_GraphedForwardPool` replayed per batch;
    with `bn_mode="batch"` the running statistics the replays move are
    put back after them."""
    modes = _eval_statistics(bn_mode)

    def body(batch: GraphBatch) -> list:
        if decode is not None:
            batch = decode(batch)
        with sorted_views():
            out = model(batch)
        return list(_abs_err_sums(out, batch, node_level, segment_level))

    graphs = _GraphedForwardPool(model, body, "eval", modes)

    @torch.no_grad()
    def eval_pool(stacked: GraphBatch):
        if stacked.graph_mask.device.type == "cpu":
            total = count = None
            # every batch's forward and error sums, enqueued; no wait
            with trace.span("eval"):
                for b in _pool_batches(stacked, decode):
                    s, c = eval_step(model, b, node_level, bn_mode,
                                     segment_level)
                    total = s if total is None else total + s
                    count = c if count is None else count + c
            trace.count("eval.batches", pool_size(stacked))
            return total, count
        graph = graphs.find(stacked)
        # every replay (span `eval.forward`); no wait
        with trace.span("eval"), modes(model):
            total, count = graph.run(stacked)
            # the next call refills the sums
            return total.clone(), count.clone()

    return eval_pool


def make_accuracy_step(model: torch.nn.Module):
    """`acc_step(batch) -> (num_correct, num_real)`: classification eval
    with the running statistics, as device tensors (the caller reads them
    once per batch)."""

    @torch.no_grad()
    def acc_step(batch: GraphBatch):
        with running_statistics(model), sorted_views():
            pred = model(batch).argmax(dim=-1)
        correct = (pred == batch.y.reshape(-1).long()) & batch.graph_mask
        return correct.sum(), batch.graph_mask.sum()

    return acc_step


def make_pergraph_correct_step(model: torch.nn.Module):
    """`step(batch) -> (correct (G,) bool, graph_mask)`: per-graph
    correctness with the running statistics, the building block of the
    majority-vote eval (device tensors)."""

    @torch.no_grad()
    def step(batch: GraphBatch):
        with running_statistics(model), sorted_views():
            pred = model(batch).argmax(dim=-1)
        return pred == batch.y.reshape(-1).long(), batch.graph_mask

    return step


def make_pool_logits_step(model: torch.nn.Module, node_level: bool = False,
                          decode=None):
    """`logits_pool(stacked) -> (logits (B, G, C), y (B, G, T),
    graph_mask (B, G))` over every batch of a stacked pool, with the
    running statistics, so a classification metric (ROC-AUC, AP,
    accuracy, macro-F1) is computed on the host from one read. With
    `node_level` the rows are nodes: (logits (B, N, C), y (B, N, 1),
    node_mask (B, N)). Each batch goes through `decode` when given, and
    so do y and the mask. Eager and forward-only, like the pool eval."""

    @torch.no_grad()
    def logits_pool(stacked: GraphBatch):
        outs = []
        with running_statistics(model):
            for b in _pool_batches(stacked, decode):
                with sorted_views():
                    outs.append(model(b))
        if decode is not None:
            # y and the mask may be stored compressed too
            stacked = decode(GraphBatch(y=stacked.y,
                                        graph_mask=stacked.graph_mask,
                                        node_mask=stacked.node_mask))
        mask = stacked.node_mask if node_level else stacked.graph_mask
        return torch.stack(outs), stacked.y, mask

    return logits_pool


def model_generators(model: torch.nn.Module) -> list:
    """The generators `model` draws from in `train()` (dropout, random
    node initialisation): `model.generators()`, or none."""
    return list(getattr(model, "generators", list)())


# ---------------------------------------------------------------------------
# the pool step: one epoch over a stacked pool
# ---------------------------------------------------------------------------


def make_pool_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                         loss_fn, pool_like: GraphBatch, decode=None,
                         step_fn=None):
    """`pool_step(pool, order) -> losses`: one train step per index of
    `order` (host integers) on batch `pool[order[i]]` of a stacked pool,
    the counterpart of the JAX package's jitted scan over a pool. `losses`
    is a (len(order),) tensor on the pool's device; reading it is the
    caller's one wait per epoch.

    Each step copies its batch (fields and extras) into static buffers
    shaped like one entry of `pool_like`, in the pool's dtypes; pools of
    other shapes or dtypes are refused. `decode` (a compressed pool's
    decoder, `data/compress.py`) casts the buffers back before the step
    reads them. `step_fn(batch) -> loss` replaces the train step
    (`train_step(model, opt, batch, loss_fn)`): the parallel steps of
    `parallel/` pass theirs.

    On the CPU the steps over those buffers run eagerly. On a CUDA device
    one step, the decode included, is captured into a CUDA graph and
    replayed per batch, the copies device to device; `opt` must then be
    capturable (`adam_with_plateau(..., capturable=True)`), and a capture
    failure raises."""
    if step_fn is None:
        def step_fn(batch):
            return train_step(model, opt, batch, loss_fn)
    if decode is not None:
        inner = step_fn

        def step_fn(batch):
            return inner(decode(batch))

    if pool_like.graph_mask.device.type == "cpu":
        return _EagerPoolStep(step_fn, pool_like)
    return _GraphedPoolStep(model, opt, step_fn, pool_like)


class _PoolBuffers:
    """Static batch buffers shaped like one entry of a stacked pool, in
    its dtypes (a compressed pool's stay compressed)."""

    def __init__(self, pool_like: GraphBatch):
        first = pool_entry(pool_like, 0)
        self.static = first.with_tensors(
            {k: torch.empty_like(v) for k, v in first.tensors().items()})
        self.device = first.graph_mask.device
        self.load(pool_like, 0)

    def load(self, pool: GraphBatch, j: int) -> None:
        src = pool.tensors()
        for k, dst in self.static.tensors().items():
            dst.copy_(src[k][j])

    def steps(self, pool: GraphBatch, order, run) -> None:
        """For the i-th batch j of `order`: load pool entry j into the
        buffers, then `run(i)`. On the card the host runs about four steps
        ahead, so the spans time the enqueueing and its waits on a full
        launch queue (mostly inside a replay's launch), not device work."""
        self.check(pool)
        for i, j in enumerate(order):
            with trace.span("pool_step.load"):  # the batch copies
                self.load(pool, int(j))
            with trace.span("pool_step.run"):  # the step, replayed or eager
                run(i)
        trace.count("pool_step.steps", len(order))
        trace.count("pool_step.copies",
                    len(order) * len(self.static.tensors()))

    def check(self, pool: GraphBatch) -> None:
        want = {k: (tuple(v.shape), v.dtype, v.device)
                for k, v in self.static.tensors().items()}
        got = {k: (tuple(v.shape[1:]), v.dtype, v.device)
               for k, v in pool.tensors().items()}
        if got != want or _layout(pool) != _layout(self.static):
            raise ValueError(
                "the pool's batches differ in shape, type or device from the "
                "step's buffers; one pool step serves only pools of one shape")


def _layout(batch: GraphBatch) -> tuple:
    """The static block layout of a batch: its uniform per-graph and
    per-copy block sizes and bucketed copy regions."""
    return (batch.nodes_per_graph, batch.edges_per_graph,
            batch.nodes_per_seg, batch.edges_per_seg, batch.seg_regions)


class _EagerPoolStep(_PoolBuffers):
    """The pool step without a CUDA graph: eager steps over the buffers."""

    def __init__(self, step_fn, pool_like: GraphBatch):
        super().__init__(pool_like)
        self.step_fn = step_fn

    def __call__(self, pool: GraphBatch, order) -> torch.Tensor:
        with trace.span("pool_step"):  # the whole call
            losses = []
            self.steps(pool, order,
                       lambda i: losses.append(self.step_fn(self.static)))
            return torch.stack(losses)


class _GraphedPoolStep(_PoolBuffers):
    """One train step captured into a CUDA graph, replayed per batch."""

    def __init__(self, model, opt, step_fn, pool_like: GraphBatch):
        if not all(g.get("capturable") for g in opt.param_groups):
            raise ValueError("the graphed pool step needs a capturable "
                             "optimizer: adam_with_plateau(..., "
                             "capturable=True)")
        super().__init__(pool_like)
        _warm_up(model, opt, lambda: step_fn(self.static), self.device)
        # grads set to None: the captured backward allocates them from the
        # graph's pool, at the same addresses in every replay
        opt.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        # a generator the capture draws from must be registered before it
        # starts: each replay then advances its offset, so every replay
        # draws new masks (an unregistered generator fails the capture)
        for gen in model_generators(model):
            self.graph.register_generator_state(gen)
        with torch.cuda.graph(self.graph):
            self._loss = step_fn(self.static)

    def __call__(self, pool: GraphBatch, order) -> torch.Tensor:
        with trace.span("pool_step"):  # the whole call
            losses = torch.empty(len(order), dtype=self._loss.dtype,
                                 device=self.device)

            def run(i):  # the replay and the loss's copy
                self.graph.replay()
                losses[i].copy_(self._loss)

            self.steps(pool, order, run)
            return losses


class _GraphedForwardPool:
    """A forward-only body over one batch, captured into a CUDA graph and
    replayed once per batch of a stacked pool: the pool eval and the BN
    refresh on a CUDA device. `body(batch) -> tensors` runs under
    `torch.no_grad()` and `modes(model)`; each replay adds its tensors
    into static sums, in batch order.

    One graph per batch layout (each entry's shapes and dtypes, the block
    sizes) and per address of the model's parameters and buffers: a stack
    of another layout gets a graph of its own, a model whose tensors were
    rebound rather than written in place a fresh capture in place of the
    stale one, so no graph replays over freed memory. A capture failure
    raises. `name` names the spans and counters: `<name>.forward` around
    each replay, `<name>.capture` around a capture; `<name>.batches`,
    `.replays` and `.captures`."""

    def __init__(self, model, body, name: str, modes):
        self.model, self.body, self.name, self.modes = model, body, name, modes
        self.graphs: dict = {}  # entry layout -> _ForwardGraph

    def find(self, stack: GraphBatch) -> "_ForwardGraph":
        """The graph of `stack`'s layout and the model's addresses,
        captured here if there is none."""
        key = (tuple((k, tuple(v.shape[1:]), v.dtype, v.device)
                     for k, v in stack.tensors().items()), _layout(stack))
        addrs = tuple(t.data_ptr() for t in _model_tensors(self.model))
        graph = self.graphs.get(key)
        if graph is None or graph.addrs != addrs:
            self.graphs[key] = graph = None  # free a stale graph's pool
            with trace.span(self.name + ".capture"):
                graph = _ForwardGraph(self.model, self.body, self.modes,
                                      stack, self.name)
            graph.addrs = addrs
            self.graphs[key] = graph
            trace.count(self.name + ".captures")
        return graph


class _ForwardGraph(_PoolBuffers):
    """One capture of a `_GraphedForwardPool`'s body over static batch
    buffers shaped like one entry of a stack."""

    def __init__(self, model, body, modes, stack: GraphBatch, name: str):
        super().__init__(stack)
        self.name = name
        with torch.no_grad(), modes(model):
            # a batch-statistics forward moves the running statistics:
            # the warm-up puts them back
            out = _warm_up(model, None, lambda: body(self.static),
                           self.device)
            self.sums = [torch.zeros_like(t) for t in out]
            self.graph = torch.cuda.CUDAGraph()
            for gen in model_generators(model):
                self.graph.register_generator_state(gen)
            with torch.cuda.graph(self.graph):
                for acc, t in zip(self.sums, body(self.static)):
                    acc.add_(t)

    def run(self, stack: GraphBatch) -> list:
        """Zero the sums, then per batch of `stack` its copies into the
        buffers and one replay; returns the sums (static tensors)."""
        if self.sums:  # a model without BatchNorm refreshes no statistic
            torch._foreach_zero_(self.sums)
        n = pool_size(stack)
        for j in range(n):
            self.load(stack, j)
            with trace.span(self.name + ".forward"):  # the replay's launch
                self.graph.replay()
        trace.count(self.name + ".batches", n)
        trace.count(self.name + ".replays", n)
        return self.sums


WARMUP_STEPS = 3


def _warm_up(model, opt, fn, device):
    """`fn()` `WARMUP_STEPS` times on a side stream ahead of a capture
    (allocator, cuBLAS workspaces, an optimizer's state, the kernels'
    scratch such as K1's counters); then every parameter, buffer,
    optimizer state (`opt` may be None) and generator state is put back
    in place, so the warm-up leaves the model as it was. Returns the last
    call's result."""
    snapshot = _snapshot(model, opt)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_STEPS):
            out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    _restore_in_place(model, opt, snapshot)
    return out


def _snapshot(model, opt=None) -> dict:
    return dict(
        tensors=[t.detach().clone() for t in _model_tensors(model)],
        opt_state={p: {k: v.clone() for k, v in s.items()
                       if isinstance(v, torch.Tensor)}
                   for p, s in (opt.state.items() if opt is not None else ())},
        rng=[g.get_state() for g in model_generators(model)],
    )


def _model_tensors(model):
    return list(model.parameters()) + list(model.buffers())


@torch.no_grad()
def _restore_in_place(model, opt, snapshot) -> None:
    for t, saved in zip(_model_tensors(model), snapshot["tensors"]):
        t.copy_(saved)
    for p, state in (opt.state.items() if opt is not None else ()):
        saved = snapshot["opt_state"].get(p)
        for k, v in state.items():
            if not isinstance(v, torch.Tensor):
                continue
            if saved is None:
                v.zero_()  # state the warm-up created: Adam starts at 0
            else:
                v.copy_(saved[k])
    for g, state in zip(model_generators(model), snapshot["rng"]):
        g.set_state(state)
