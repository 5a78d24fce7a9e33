"""Training loop building blocks (counterpart of `escgnn_tpu/train/loop.py`).

Adam + L1 loss + ReduceLROnPlateau, as eager PyTorch: `train_step` runs
forward (BatchNorm in batch-statistics mode), backward and one Adam
update; `eval_step` runs the model in `eval()` mode (running BatchNorm
statistics, the JAX package's `bn_mode="running"`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from escgnn_tpu_torch.data.container import GraphBatch


def adam_with_plateau(params, lr: float) -> torch.optim.Adam:
    """Adam with torch defaults (b1=0.9, b2=0.999, eps=1e-8 — the same
    update as optax.adam); the plateau scheduler sets its learning rate
    through `set_learning_rate`."""
    return torch.optim.Adam(params, lr=lr)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
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


def train_step(
    model: torch.nn.Module,
    opt: torch.optim.Optimizer,
    batch: GraphBatch,
    loss_fn: Callable[[torch.Tensor, GraphBatch], torch.Tensor],
) -> torch.Tensor:
    """One step: forward in train mode (BatchNorm running statistics are
    updated), backward, optimizer update. Returns the loss (computed
    before the update) as a detached tensor, without synchronizing."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model(batch), batch)
    loss.backward()
    opt.step()
    return loss.detach()


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: GraphBatch,
              node_level: bool = True):
    """(sum |err|, count) over real rows, with running BatchNorm
    statistics, so a caller accumulates an exact dataset MAE across
    fixed-shape batches."""
    model.eval()
    out = model(batch)
    mask = batch.node_mask if node_level else batch.graph_mask
    err = (out - batch.y).abs() * mask[:, None]
    return err.sum(), mask.sum() * out.shape[-1]
