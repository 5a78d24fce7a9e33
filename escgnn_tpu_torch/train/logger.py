"""Experiment logger: per-split metric accumulation and run logging
(counterpart of `escgnn_tpu/train/logger.py`, the same files and lines).

`SplitLogger` keeps the mask-selected (pred, target) rows of one split
across fixed-shape batches and reduces them to the task's metrics at the
epoch's end (regression: MAE and MSE; classification: accuracy;
multilabel: ROC-AUC and AP from `train/metrics.py`; link: the mean of
each graph's ranking stats). `RunLogger` appends each epoch's line to
`log.txt` and its JSON to `metrics.jsonl` in the run directory, and
mirrors it to wandb when asked and the package is there.

Usage per split and epoch:
    lg = SplitLogger("val", task="classification")
    for batch: lg.update(pred, y, mask)
    stats = lg.epoch_summary()   # dict of metrics; resets the buffer

As in JAX, the link task's summary resets its ranking stats only: rows
and losses given to `update` in a link logger stay and count into the
next summary's `loss`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from escgnn_tpu_torch.train.metrics import average_precision, rocauc


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class SplitLogger:
    """Accumulates (pred, target) rows of one split across fixed-shape
    batches (only mask-selected rows are kept), then reduces to metrics.
    `task`: regression | classification | multilabel | link."""

    def __init__(self, split: str, task: str = "regression"):
        self.split = split
        self.task = task
        self._preds: list = []
        self._trues: list = []
        self._link_stats: list = []
        self._loss = 0.0
        self._n = 0
        self._t0 = time.time()

    def update_link_stats(self, stats: dict):
        """One graph's ranking stats (mrr / hits@k from
        `train.metrics.graph_link_mrr`); an empty dict (a graph with no
        positive pair) is skipped."""
        if stats:
            self._link_stats.append(stats)

    def update(self, pred, true, mask, loss: Optional[float] = None):
        """Keep the rows of `pred` / `true` (arrays or tensors) that
        `mask` selects; `loss` counts once per selected row."""
        pred, true = _host(pred), _host(true)
        mask = _host(mask).astype(bool)
        self._preds.append(pred[mask])
        self._trues.append(true[mask])
        if loss is not None:
            self._loss += float(loss) * int(mask.sum())
            self._n += int(mask.sum())

    def epoch_summary(self) -> dict:
        pred = (np.concatenate(self._preds) if self._preds
                else np.zeros((0, 1)))
        true = (np.concatenate(self._trues) if self._trues
                else np.zeros((0, 1)))
        out: dict = {"split": self.split, "n": int(pred.shape[0]),
                     "time_s": round(time.time() - self._t0, 2)}
        if self._n:
            out["loss"] = self._loss / self._n
        if self.task == "link":
            keys = sorted({k for s in self._link_stats for k in s})
            for k in keys:
                vals = [s[k] for s in self._link_stats if k in s]
                out[k] = float(np.mean(vals)) if vals else float("nan")
            out["n"] = len(self._link_stats)
            self._link_stats = []
            self._t0 = time.time()
            return out
        if pred.shape[0]:
            if self.task == "regression":
                out["mae"] = float(np.mean(np.abs(pred - true)))
                out["mse"] = float(np.mean((pred - true) ** 2))
            elif self.task == "classification":
                cls = pred.argmax(-1) if pred.ndim > 1 else (pred > 0)
                out["accuracy"] = float(
                    np.mean(cls.reshape(-1) == true.reshape(-1)))
            elif self.task == "multilabel":
                p2 = pred.reshape(pred.shape[0], -1)
                t2 = true.reshape(true.shape[0], -1)
                out["rocauc"] = rocauc(t2, p2)
                out["ap"] = average_precision(t2, p2)
        self._preds, self._trues = [], []
        self._loss, self._n = 0.0, 0
        self._t0 = time.time()
        return out


class RunLogger:
    """Appends per-epoch lines to `log.txt` and `metrics.jsonl` in the run
    dir; mirrors them to wandb with `enable_wandb` when the package is
    there (without it, or when wandb fails to start, it says so and logs
    to the files alone)."""

    def __init__(self, run_dir: str, enable_wandb: bool = False,
                 wandb_project: str = "escgnn_tpu",
                 config: Optional[dict] = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._wandb = None
        if enable_wandb:
            try:
                import wandb  # type: ignore

                self._wandb = wandb.init(project=wandb_project, dir=run_dir,
                                         config=config or {})
            except Exception as e:  # wandb absent or failing to start
                print(f"wandb disabled: {e}")

    def log(self, epoch: int, **stats) -> str:
        line = {"epoch": epoch, **stats}
        with open(os.path.join(self.run_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")
        msg = f"epoch {epoch:03d} " + " ".join(
            f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in stats.items())
        with open(os.path.join(self.run_dir, "log.txt"), "a") as f:
            f.write(msg + "\n")
        if self._wandb is not None:
            self._wandb.log(stats, step=epoch)
        return msg

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
