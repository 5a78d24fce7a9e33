#!/usr/bin/env python3
"""Put a port run's training curve beside the JAX package's record.

    python tools/quality_curve.py <jax log> <port log>

Both logs are read as text (gzip when the name ends in `.gz`): a
driver's `log.txt`, or its stdout, whose epoch lines the port's logger
writes in JAX's format (`epoch 001 lr 0.000500 loss 0.34364 val MAE
0.05187 ...`; the OGB driver's lines have no `lr`, the GPS driver's
start with `[seed 0]`). Lines that are not epoch lines are skipped.

It prints, per epoch, the learning rate, the train loss and the val
metric of both runs side by side, then the first epoch from which the
port's best-so-far val metric stays outside the row's verdict band
around JAX's best-so-far at the same epoch: an error metric (MAE, MSE)
is inside while the port's is at most 1.5 x JAX's; a score (ROC-AUC, AP,
accuracy, F1) while the port's is at least JAX's - 0.02. "none" means
the port ends inside the band.
"""

from __future__ import annotations

import argparse
import gzip
import re

EPOCH = re.compile(
    r"epoch (?P<epoch>\d+)(?: lr (?P<lr>\S+))? loss (?P<loss>\S+) "
    r"val (?P<metric>[A-Za-z_0-9]+) (?P<val>\S+)")
# metrics where lower is better; every other metric is a score
ERRORS = {"mae", "mse", "rmse", "loss"}
MAE_FACTOR = 1.5
SCORE_MARGIN = 0.02


def read_curve(path: str) -> dict:
    """{'metric': name, 'epochs': {epoch: (lr or None, loss, val)}}; the
    last line of an epoch wins (a log appended twice keeps one)."""
    opener = gzip.open if path.endswith(".gz") else open
    epochs, metric = {}, None
    with opener(path, "rt") as f:
        for line in f:
            m = EPOCH.search(line)
            if not m:
                continue
            metric = m["metric"]
            lr = float(m["lr"]) if m["lr"] else None
            epochs[int(m["epoch"])] = (lr, float(m["loss"]), float(m["val"]))
    if not epochs:
        raise SystemExit(f"{path}: no epoch lines")
    return {"metric": metric, "epochs": epochs}


def lower_is_better(metric: str) -> bool:
    return metric.lower() in ERRORS


def inside_band(port_best: float, jax_best: float, metric: str) -> bool:
    """The verdict rule: MAE within 1.5x of JAX's, a score within 0.02
    under JAX's; better than JAX's is inside."""
    if lower_is_better(metric):
        return port_best <= MAE_FACTOR * jax_best
    return port_best >= jax_best - SCORE_MARGIN


def best_so_far(vals, lower: bool):
    out, best = [], None
    for v in vals:
        if v == v:  # a nan val (one class in a split) keeps the best
            best = v if best is None else (min(best, v) if lower
                                           else max(best, v))
        out.append(best)
    return out


def compare(jax: dict, port: dict) -> dict:
    """Rows over the epochs both logs hold, and the first epoch from
    which the port's best-so-far stays outside the band (None if it ends
    inside)."""
    if jax["metric"].lower() != port["metric"].lower():
        raise SystemExit(f"metrics differ: {jax['metric']} / "
                         f"{port['metric']}")
    metric = jax["metric"]
    lower = lower_is_better(metric)
    epochs = sorted(set(jax["epochs"]) & set(port["epochs"]))
    if not epochs:
        raise SystemExit("no epoch in common")
    jbest = best_so_far([jax["epochs"][e][2] for e in epochs], lower)
    pbest = best_so_far([port["epochs"][e][2] for e in epochs], lower)
    rows, first_out = [], None
    for e, jb, pb in zip(epochs, jbest, pbest):
        ok = (jb is None or pb is not None
              and inside_band(pb, jb, metric))
        rows.append((e, jax["epochs"][e], port["epochs"][e], jb, pb, ok))
        if ok:
            first_out = None
        elif first_out is None:
            first_out = e
    return {"metric": metric, "rows": rows, "first_out": first_out,
            "jax_best": jbest[-1], "port_best": pbest[-1],
            "jax_epochs": len(jax["epochs"]),
            "port_epochs": len(port["epochs"])}


def _f(x, fmt="{:.5f}"):
    return "-" if x is None else fmt.format(x)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("jax_log")
    p.add_argument("port_log")
    args = p.parse_args(argv)
    res = compare(read_curve(args.jax_log), read_curve(args.port_log))
    m = res["metric"]
    print(f"epoch  lr_jax    lr_port   loss_jax  loss_port  val_{m}_jax  "
          f"val_{m}_port  best_jax  best_port  band")
    for e, (jlr, jl, jv), (plr, pl, pv), jb, pb, ok in res["rows"]:
        print(f"{e:5d}  {_f(jlr, '{:.6f}'):8s}  {_f(plr, '{:.6f}'):8s}  "
              f"{_f(jl):8s}  {_f(pl):9s}  {_f(jv):11s}  {_f(pv):12s}  "
              f"{_f(jb):8s}  {_f(pb):9s}  {'in' if ok else 'OUT'}")
    rule = (f"port <= {MAE_FACTOR} x JAX" if lower_is_better(m)
            else f"port >= JAX - {SCORE_MARGIN}")
    print(f"epochs: jax {res['jax_epochs']}, port {res['port_epochs']}; "
          f"best val {m}: jax {_f(res['jax_best'])}, port "
          f"{_f(res['port_best'])} (band: {rule})")
    print("first epoch from which the port's best-so-far val stays "
          f"outside the band: {res['first_out'] or 'none'}")
    return res


if __name__ == "__main__":
    main()
