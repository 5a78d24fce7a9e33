"""Metrics and losses of the OGB drivers (counterpart of
`escgnn_tpu/train/metrics.py`).

NaN-masked BCE runs on the device. ROC-AUC and average precision are
computed on the host in numpy, written out from their definitions (the
JAX package calls sklearn, which the machines that run the port need
not have), with the OGB task filters: a task whose labeled entries hold
one class only is skipped, and with no task left the metric is NaN.
`link_pair_loss` and the MRR helpers come with GPS (ROADMAP 8.3).
"""

from __future__ import annotations

import numpy as np
import torch

from escgnn_tpu_torch.data.container import GraphBatch


def optax_sigmoid_bce(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid BCE in optax's log(1 + exp(-|x|)) form."""
    return (logits.clamp_min(0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def masked_bce_with_logits(logits: torch.Tensor,
                           batch: GraphBatch) -> torch.Tensor:
    """BCE over the labeled (non-NaN) entries of real graphs."""
    y = batch.y
    labeled = ~torch.isnan(y) & batch.graph_mask[:, None]
    y_safe = torch.where(labeled, y, torch.zeros((), dtype=y.dtype,
                                                 device=y.device))
    per = torch.where(labeled, optax_sigmoid_bce(logits, y_safe),
                      torch.zeros((), dtype=logits.dtype,
                                  device=logits.device))
    return per.sum() / labeled.sum().to(per.dtype).clamp_min(1.0)


def _average_ranks(s: np.ndarray) -> np.ndarray:
    """1-based ranks of `s`, ties given the mean of the ranks they span."""
    _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
    start = np.cumsum(counts) - counts
    return (start + (counts + 1) / 2.0)[inv.reshape(-1)]


def _binary_auc(y: np.ndarray, s: np.ndarray) -> float:
    """ROC-AUC as the Mann-Whitney statistic with averaged tie ranks (a
    tied positive/negative pair counts one half), which is the area under
    the ROC curve that `sklearn.metrics.roc_auc_score` integrates. The
    larger of the two label values is the positive class."""
    pos = y == y.max()
    n_pos = int(pos.sum())
    n_neg = len(y) - n_pos
    r = _average_ranks(s)
    return float((r[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def _binary_ap(y: np.ndarray, s: np.ndarray) -> float:
    """Average precision as sklearn defines it: sum over the distinct
    score thresholds, from the highest down, of (R_n - R_(n-1)) * P_n,
    tied scores entering at one threshold; R_0 = 0."""
    order = np.argsort(-s, kind="mergesort")
    s_sorted = s[order]
    hit = (y[order] == 1).astype(np.float64)
    last = np.r_[np.flatnonzero(np.diff(s_sorted)), len(s) - 1]
    tps = np.cumsum(hit)[last]
    precision = tps / (last + 1.0)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def rocauc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Mean ROC-AUC over the tasks whose labeled entries hold both
    classes (OGB convention); NaN when there is none."""
    aucs = []
    for t in range(y_true.shape[1]):
        m = ~np.isnan(y_true[:, t])
        yt = y_true[m, t]
        if len(np.unique(yt)) < 2:
            continue
        aucs.append(_binary_auc(yt, y_score[m, t]))
    return float(np.mean(aucs)) if aucs else float("nan")


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Mean AP over the tasks with positives and negatives among their
    labeled entries (ogbg-molpcba's metric); NaN when there is none."""
    aps = []
    for t in range(y_true.shape[1]):
        m = ~np.isnan(y_true[:, t])
        yt = y_true[m, t]
        if yt.sum() == 0 or yt.sum() == len(yt):
            continue
        aps.append(_binary_ap(yt, y_score[m, t]))
    return float(np.mean(aps)) if aps else float("nan")
