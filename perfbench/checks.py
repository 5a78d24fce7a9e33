"""The numbers that decide `correct`: each a gap between what the timed
path produced and what the plain reference computes from the same inputs.

  loss1_gap   the relative gap of the first step's loss
  loss_gap    the largest relative gap of a step's loss, over the first
              three steps
  grad_gap    the first step's gradient as Adam takes it (after the clip),
              per leaf: | ||g_sys|| - ||g_ref|| | over the larger of the
              reference leaf's norm and the median leaf's; the worst leaf
  change_gap  the same for each leaf's change over three steps, over the
              leaves whose reference gradient is at least a thousandth of
              the median leaf's (a bias ahead of a BatchNorm has a
              gradient of rounding alone, and Adam moves it by rounding)
  grad_gap_median, change_gap_median
              the median leaf's gap instead of the worst leaf's
  grad_gap_large
              `grad_gap`'s worst among the leaves whose reference gradient
              is at least the median leaf's (the same per-leaf gaps)
  stats_gap   the worst leaf's gap of the BatchNorm statistics after the
              refresh (from the drawn weights, before the first step)
  val_gap,    the relative gap of the val and test mean absolute errors
  test_gap    under those statistics

A cell compares the numbers its limits file names; the others are read
by the calibration alone.
"""

from __future__ import annotations

import statistics

KEEP_GRAD_SHARE = 1e-3


def _median(d: dict) -> float:
    return statistics.median(d.values()) if d else 0.0


def leaf_gaps(sys_norms: dict, ref_norms: dict, keep=None) -> dict:
    """Each leaf's | ||a|| - ||b|| | / max(||b||, median ||b||)."""
    names = [k for k in ref_norms if keep is None or k in keep]
    med = _median({k: ref_norms[k] for k in names})
    return {k: abs(sys_norms[k] - ref_norms[k]) / max(ref_norms[k], med)
            for k in names if max(ref_norms[k], med) > 0}


def leaf_gap(sys_norms: dict, ref_norms: dict, keep=None) -> float:
    """The worst leaf's gap (`leaf_gaps`)."""
    return max(leaf_gaps(sys_norms, ref_norms, keep).values(), default=0.0)


def median_leaf_gap(sys_norms: dict, ref_norms: dict, keep=None) -> float:
    """The median leaf's gap (`leaf_gaps`)."""
    return _median(leaf_gaps(sys_norms, ref_norms, keep))


def large_leaves(ref_grad_norms: dict) -> set:
    med = _median(ref_grad_norms)
    return {k for k, v in ref_grad_norms.items() if v >= med}


def leaf_table(sys: dict, ref: dict, n: int = 6) -> list:
    """The `n` leaves of the first gradient with the largest gaps, each as
    [name, gap, its reference norm over the median leaf's]."""
    g = leaf_gaps(sys["grad1"], ref["grad1"])
    med = _median(ref["grad1"])
    top = sorted(g, key=g.get, reverse=True)[:n]
    return [[k, g[k], ref["grad1"][k] / med if med else 0.0] for k in top]


def worst_leaves(sys: dict, ref: dict) -> dict:
    """The leaf behind each leaf-wise gap, for a look at its cause."""
    out = {}
    for key, keep in (("grad1", None),
                      ("change", moved_leaves(ref["grad1"])),
                      ("stats", None)):
        if key in ref:
            g = leaf_gaps(sys[key], ref[key], keep)
            out[key] = max(g, key=g.get) if g else None
    return out


def moved_leaves(ref_grad_norms: dict) -> set:
    med = _median(ref_grad_norms)
    return {k for k, v in ref_grad_norms.items()
            if v >= KEEP_GRAD_SHARE * med}


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def gaps(sys: dict, ref: dict) -> dict:
    """The gaps between two readings (`sys` the system's or a control's,
    `ref` the reference's), each a dict of losses, grad1, change and, in
    an epoch cell, stats, val and test."""
    moved = moved_leaves(ref["grad1"])
    g1 = leaf_gaps(sys["grad1"], ref["grad1"])
    out = dict(
        loss1_gap=rel(sys["losses"][0], ref["losses"][0]),
        loss_gap=max(rel(a, b) for a, b in zip(sys["losses"],
                                               ref["losses"])),
        grad_gap=leaf_gap(sys["grad1"], ref["grad1"]),
        grad_gap_median=median_leaf_gap(sys["grad1"], ref["grad1"]),
        grad_gap_large=max((g1[k] for k in large_leaves(ref["grad1"])
                            if k in g1), default=0.0),
        change_gap=leaf_gap(sys["change"], ref["change"], keep=moved),
        change_gap_median=median_leaf_gap(sys["change"], ref["change"],
                                          keep=moved),
    )
    if "stats" in ref:
        out["stats_gap"] = leaf_gap(sys["stats"], ref["stats"])
        out["val_gap"] = rel(sys["val"], ref["val"])
        out["test_gap"] = rel(sys["test"], ref["test"])
    return out
