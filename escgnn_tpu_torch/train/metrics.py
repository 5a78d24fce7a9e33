"""Metrics and losses of the OGB drivers (counterpart of
`escgnn_tpu/train/metrics.py`).

NaN-masked BCE runs on the device. ROC-AUC and average precision are
computed on the host in numpy, written out from their definitions (the
JAX package calls sklearn, which the machines that run the port need
not have), with the OGB task filters: a task whose labeled entries hold
one class only is skipped, and with no task left the metric is NaN.
`macro_f1` is sklearn's `f1_score(average="macro")` written out the
same way (the GPS node-classification metric). The GPS link task:
`link_pair_loss` (dot-decoded BCE over the batch's
labeled pairs, on the device) and the host-side ranking metrics
`eval_mrr` / `graph_link_mrr`, numpy copies of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.ops.segment import gather_rows


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


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sklearn's `f1_score(y_true, y_pred, average="macro")` for integer
    labels: the classes are the sorted union of the true and predicted
    labels, each scores 2 TP / (2 TP + FP + FN) (0 for a class with no
    true or no predicted member), and every class counts in the mean.
    Empty input raises, as sklearn does."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    if y_true.size == 0 or y_true.shape != y_pred.shape:
        raise ValueError(f"macro_f1: {y_true.size} true and {y_pred.size} "
                         f"predicted labels")
    labels = np.union1d(y_true, y_pred)
    t = np.searchsorted(labels, y_true)
    p = np.searchsorted(labels, y_pred)
    C = labels.size
    tp = np.bincount(t[t == p], minlength=C).astype(np.float64)
    fp = np.bincount(p, minlength=C) - tp
    fn = np.bincount(t, minlength=C) - tp
    return float(np.mean(2 * tp / (2 * tp + fp + fn)))


def link_pair_loss(node_emb: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Dot-decoded link-prediction BCE over labeled pairs.

    `node_emb` is the (N, D) output of the inductive-edge head
    (models/gps.py head="inductive_edge"); pairs, labels and masks come
    from the batcher's pair arrays. Padding pairs park on the padding
    node slot and drop out through `pair_mask`."""
    ex = batch.extras
    pi = ex["pair_index"].long()
    v1 = gather_rows(node_emb, pi[0])
    v2 = gather_rows(node_emb, pi[1])
    logits = (v1 * v2).sum(-1)
    mask = ex["pair_mask"]
    per = optax_sigmoid_bce(logits, ex["pair_label"].to(torch.float32))
    return (torch.where(mask, per, torch.zeros_like(per)).sum()
            / mask.sum().clamp_min(1))


def eval_mrr(y_pred_pos: np.ndarray, y_pred_neg: np.ndarray) -> dict:
    """Hits@{1,3,10} + MRR of positives ranked against their negatives.

    Mirrors the reference's `_eval_mrr`
    (GraphGPS/graphgps/head/inductive_edge.py:115-139, itself the OGB
    linkproppred evaluator): the positive score is prepended to its
    negative row, rows are argsorted descending, and the positive's
    rank (1-based) yields hits@k / reciprocal rank. Stable argsort, so
    score ties resolve in favor of the positive — same optimistic tie
    rule as torch.argsort on the reference's path.

    y_pred_pos: (B,); y_pred_neg: (B, num_neg). Returns per-edge
    arrays under 'hits@k_list' / 'mrr_list' keys like the reference."""
    y_pred = np.concatenate(
        [y_pred_pos.reshape(-1, 1), y_pred_neg], axis=1
    )
    argsort = np.argsort(-y_pred, axis=1, kind="stable")
    ranking = np.nonzero(argsort == 0)[1] + 1
    return {
        "hits@1_list": (ranking <= 1).astype(np.float64),
        "hits@3_list": (ranking <= 3).astype(np.float64),
        "hits@10_list": (ranking <= 10).astype(np.float64),
        "mrr_list": 1.0 / ranking.astype(np.float64),
    }


def graph_link_mrr(scores: np.ndarray, pair_index: np.ndarray,
                   pair_label: np.ndarray, num_nodes: int) -> dict:
    """One graph's MRR/hits from a dense (M, M) score matrix.

    Mirrors `compute_mrr` (inductive_edge.py:62-113): for every
    positive (i, j), the candidate set is j's score among ALL nodes of
    the graph except the true tail itself (self-loops included, other
    positives of i included — exactly the reference's neg_mask).
    Returns {} when the graph has no positive pairs (the reference
    emits empty stats)."""
    pos = pair_index[:, pair_label == 1]
    n_pos = pos.shape[1]
    if n_pos == 0:
        return {}
    pred = scores[:num_nodes, :num_nodes]
    pred_pos = pred[pos[0], pos[1]]
    neg_mask = np.ones((n_pos, num_nodes), bool)
    neg_mask[np.arange(n_pos), pos[1]] = False
    pred_neg = pred[pos[0]][neg_mask].reshape(n_pos, -1)
    out = eval_mrr(pred_pos, pred_neg)
    return {k[: -len("_list")]: float(v.mean()) for k, v in out.items()}
