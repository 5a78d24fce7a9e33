#!/usr/bin/env python3
"""Per-step losses of a JAX driver and of its twin from one initial
state, on the driver's own batches in the driver's order.

    # the JAX driver on the CPU: its first epochs, every step's loss
    JAX_PLATFORMS=cpu python tools/step_losses.py jax A.json \
        run_graphcount -- --model PPGN_eff ... --epochs 3 --res_dir DIR
    # the twin from the JAX driver's initial weights (`carry_jax_init.py
    # dump` at the same flags and seed), on the CPU or the card
    python tools/step_losses.py port B.json run_graphcount \
        --init INIT.npz -- --model PPGN_eff ... --epochs 3 --device cpu
    # side by side, with the JAX record's epoch lines from its log
    python tools/step_losses.py table A.json B.json C.json \
        --record results_archive/count_cycle_t0_ppgn/log.txt.gz

`jax` runs the repository's `<driver>.py` in this process (its compile
cache set-up skipped, `--num_workers 0`, which changes no data) with its
pool step wrapped so that each epoch's per-step losses are kept; `port`
runs the twin's `main` through `carry_jax_init.run`, whose records carry
the same per-step losses. Both write one JSON: the flags and, per epoch,
the mean loss, the val MAE and the steps' losses. With `--bf16_operands`
the twin rounds the operands of every dense layer (the PPGN blocks' 1x1
convs among them) and of the blocks' N x N products to bf16 and
multiplies in f32, as a TPU's f32 matmul at XLA's DEFAULT precision
does: a probe of that precision, not a mode of the package.

With `--one_pass_bn` the twin's BatchNorms take the JAX package's
one-pass batch statistics (var = E[x^2] - E[x]^2) in place of its own
centred two passes: a probe of that difference, not a mode.

With `--perturb SCALE [--draw N]` either side starts from the initial
parameters times (1 + SCALE N(0, 1)), the noise drawn by numpy from N
over the leaves in sorted path order, so both packages take the same
perturbed weights: the runs' own spread under a last-bit change.

`table` prints the epoch-1 steps of every run side by side, each run's
relative gap to the first, and the epochs' mean loss and val MAE, with
the record's epoch lines last. Its verdict lines hold step 1 to rel 1e-5
and the steps up to the first whose loss exceeds 10x step 1's to rel
1e-3, and the epoch-1 means to rel 1e-2.
"""

from __future__ import annotations

import argparse
import gzip
import importlib.util
import json
import os
import re
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"epoch (\d+) lr \S+ loss (\S+) val MAE (\S+)")
STEP1_RTOL, STEPS_RTOL, MEAN_RTOL, BLOWUP = 1e-5, 1e-3, 1e-2, 10.0


def _flag(flags: list, name: str):
    return flags[flags.index(name) + 1] if name in flags else None


def _epoch_lines(text: str) -> list:
    return [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
            for m in map(LINE.match, text.splitlines()) if m]


def _carry():
    """`tools/carry_jax_init.py` as a module."""
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "carry_jax_init", os.path.join(ROOT, "tools", "carry_jax_init.py"))
    carry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(carry)
    return carry


def perturbed(flat: dict, scale: float, draw: int) -> dict:
    """{"params/...": leaf} times (1 + scale N(0, 1)) per float leaf of
    "params/", the noise from `default_rng(draw)` in sorted key order;
    other leaves as given."""
    noise = np.random.default_rng(draw)
    out = dict(flat)
    for key in sorted(flat):
        a = np.asarray(flat[key])
        if key.startswith("params/") and a.dtype.kind == "f":
            out[key] = (a * (1 + scale * noise.standard_normal(a.shape))
                        ).astype(a.dtype)
    return out


def jax_steps(driver: str, flags: list, perturb: float = 0.0,
              draw: int = 0) -> dict:
    """Run the JAX driver with `flags` (its initial parameters perturbed
    by `perturb`, see `perturbed`); its epochs with their steps'
    losses."""
    res_dir = _flag(flags, "--res_dir")
    if res_dir is None:
        raise ValueError("give the JAX driver a --res_dir")
    mod = _carry().load_jax_driver(driver)
    import jax
    import flax.linen as nn

    argv, init = sys.argv, nn.Module.init
    steps = []

    def perturbed_init(self, *args, **kwargs):
        variables = init(self, *args, **kwargs)
        pairs, treedef = jax.tree_util.tree_flatten_with_path(variables)
        keys = ["/".join(k.key for k in path) for path, _ in pairs]
        flat = perturbed({k: np.asarray(v) for k, (_, v) in
                          zip(keys, pairs)}, perturb, draw)
        return jax.tree_util.tree_unflatten(
            treedef, [jax.numpy.asarray(flat[k]) for k in keys])

    make_step = mod.make_pool_train_step

    def keep_losses(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(*a):
            state, losses = step(*a)
            steps.append(np.asarray(losses, np.float64).tolist())
            return state, losses

        return run

    if perturb:
        nn.Module.init = perturbed_init
    try:
        mod.make_pool_train_step = keep_losses
        sys.argv = [f"{driver}.py", *flags, "--num_workers", "0"]
        mod.main()
    finally:
        sys.argv, nn.Module.init = argv, init
    with open(os.path.join(res_dir, "log.txt")) as f:
        lines = _epoch_lines(f.read())
    return dict(
        package="jax", device="cpu", flags=flags, perturb=perturb, draw=draw,
        epochs=[dict(epoch=e, loss=loss, val_mae=val, step_losses=s)
                for (e, loss, val), s in zip(lines, steps)])


def _bf16(t):
    import torch

    return t.to(torch.bfloat16).to(t.dtype)


def round_operands_to_bf16():
    """Patch the twin's dense layers and PPGN blocks to round their
    matmul operands to bf16 (f32 products and sums); returns the undo."""
    import torch
    import torch.nn.functional as F

    from escgnn_tpu_torch.models import layers, ppgn

    dense, block = layers.TorchDense.forward, ppgn.RegularBlock.forward

    def dense_bf16(self, x):
        x = x.to(self.weight.dtype)
        return F.linear(_bf16(x), _bf16(self.weight), self.bias)

    def block_bf16(self, x, pmask):  # RegularBlock.forward, f32 stacks
        pm = pmask.to(x.dtype)
        m1 = self.mlp1(x) * pm
        m2 = self.mlp2(x) * pm
        mult = torch.matmul(_bf16(m1.permute(0, 3, 1, 2)),
                            _bf16(m2.permute(0, 3, 1, 2)))
        out = self.skip(torch.cat([x, mult.permute(0, 2, 3, 1)], dim=-1))
        return out * pm

    layers.TorchDense.forward = dense_bf16
    ppgn.RegularBlock.forward = block_bf16

    def undo():
        layers.TorchDense.forward, ppgn.RegularBlock.forward = dense, block

    return undo


def one_pass_bn_statistics():
    """Patch the twin's MaskedBatchNorm to JAX's one-pass batch
    statistics (single device); returns the undo."""
    import torch

    from escgnn_tpu_torch.models import layers

    forward = layers.MaskedBatchNorm.forward

    def one_pass(self, x, mask=None, axis=None):
        if self.use_running_average or axis is not None:
            return forward(self, x, mask, axis)
        xf = x.to(torch.float32)
        m = (torch.ones((x.shape[0], 1), device=x.device) if mask is None
             else mask.to(torch.float32)[:, None])
        n = m.sum().clamp_min(1.0)
        mean = (xf * m).sum(0) / n
        var = ((xf * xf * m).sum(0) / n - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            unbiased = var * n / (n - 1.0).clamp_min(1.0)
            mom = self.momentum
            self.running_mean.copy_((1 - mom) * self.running_mean + mom * mean)
            self.running_var.copy_((1 - mom) * self.running_var
                                   + mom * unbiased)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)

    layers.MaskedBatchNorm.forward = one_pass

    def undo():
        layers.MaskedBatchNorm.forward = forward

    return undo


def port_steps(driver: str, init: str, flags: list,
               bf16_operands: bool = False, perturb: float = 0.0,
               draw: int = 0, one_pass_bn: bool = False) -> dict:
    """Run the twin from the JAX driver's initial weights (perturbed by
    `perturb`, see `perturbed`); its epochs with their steps' losses."""
    carry = _carry()
    if perturb:
        with np.load(init) as z:
            flat = perturbed({k: z[k] for k in z.files}, perturb, draw)
        res_dir = _flag(flags, "--res_dir") or "."
        os.makedirs(res_dir, exist_ok=True)
        init = os.path.join(res_dir, f"init_perturbed_{draw}.npz")
        np.savez(init, **flat)
    undo = []
    if bf16_operands:
        undo.append(round_operands_to_bf16())
    if one_pass_bn:
        undo.append(one_pass_bn_statistics())
    try:
        res = carry.run(init, driver, flags)
    finally:
        for u in undo:
            u()
    return dict(
        package="port", device=_flag(flags, "--device") or "cuda",
        bf16_operands=bf16_operands, one_pass_bn=one_pass_bn, flags=flags,
        perturb=perturb, draw=draw,
        epochs=[dict(epoch=r["epoch"], loss=r["loss"], val_mae=r["val_mae"],
                     step_losses=r["step_losses"]) for r in res["epochs"]])


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def compare(ref: dict, other: dict) -> dict:
    """The gaps the table's verdict reads: step 1, the steps before the
    blow-up (the first step whose loss exceeds BLOWUP x step 1's, in
    `ref`), and the epoch-1 mean."""
    a = ref["epochs"][0]["step_losses"]
    b = other["epochs"][0]["step_losses"]
    n = len(a)
    for i, x in enumerate(a):
        if x > BLOWUP * a[0]:
            n = i
            break
    pre = max((_rel(y, x) for x, y in zip(a[:n], b[:n])), default=0.0)
    mean = _rel(other["epochs"][0]["loss"], ref["epochs"][0]["loss"])
    step1 = _rel(b[0], a[0])
    return dict(step1_rel=step1, steps_before_blowup=n,
                pre_blowup_max_rel=pre, epoch1_mean_rel=mean,
                step1_ok=step1 <= STEP1_RTOL, steps_ok=pre <= STEPS_RTOL,
                mean_ok=mean <= MEAN_RTOL)


def _label(run: dict) -> str:
    tag = "+bf16" if run.get("bf16_operands") else ""
    if run.get("one_pass_bn"):
        tag += "+1passbn"
    if run.get("perturb"):
        tag += f"~{run['perturb']:g}#{run['draw']}"
    return f"{run['package']}-{run['device']}{tag}"


def table(runs: list, record: str | None = None) -> str:
    out = []
    labels = [_label(r) for r in runs]
    out.append("epoch-1 steps: " + "  ".join(labels)
               + "  (rel to the first)")
    rows = zip(*(r["epochs"][0]["step_losses"] for r in runs))
    for i, losses in enumerate(rows, 1):
        rels = "  ".join(f"{_rel(x, losses[0]):.2e}" for x in losses[1:])
        out.append(f"step {i:3d}  " + "  ".join(f"{x:.7g}" for x in losses)
                   + f"  | {rels}")
    out.append("epochs: mean loss / val MAE")
    for r, lab in zip(runs, labels):
        out.append(f"{lab:18s} " + "  ".join(
            f"{e['epoch']}: {e['loss']:.5f} / {e['val_mae']:.5f}"
            for e in r["epochs"]))
    if record:
        opener = gzip.open if record.endswith(".gz") else open
        with opener(record, "rt") as f:
            lines = _epoch_lines(f.read())[:len(runs[0]["epochs"])]
        out.append(f"{'record':18s} " + "  ".join(
            f"{e}: {loss:.5f} / {val:.5f}" for e, loss, val in lines))
    for r, lab in zip(runs[1:], labels[1:]):
        c = compare(runs[0], r)
        out.append(
            f"verdict {lab} vs {labels[0]}: step 1 rel {c['step1_rel']:.2e}"
            f" ({'ok' if c['step1_ok'] else 'OVER'} {STEP1_RTOL:g}); steps "
            f"1-{c['steps_before_blowup']} max rel "
            f"{c['pre_blowup_max_rel']:.2e} ({'ok' if c['steps_ok'] else 'OVER'}"
            f" {STEPS_RTOL:g}); epoch-1 mean rel {c['epoch1_mean_rel']:.2e} "
            f"({'ok' if c['mean_ok'] else 'OVER'} {MEAN_RTOL:g})")
    return "\n".join(out)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=["jax", "port", "table"])
    p.add_argument("paths", nargs="+",
                   help="jax/port: OUT.json DRIVER; table: the runs' JSONs")
    p.add_argument("--init", help="port: the JAX driver's initial weights")
    p.add_argument("--bf16_operands", action="store_true")
    p.add_argument("--one_pass_bn", action="store_true")
    p.add_argument("--perturb", type=float, default=0.0,
                   help="jax/port: scale of the initial parameters' noise")
    p.add_argument("--draw", type=int, default=0, help="the noise's seed")
    p.add_argument("--record", help="table: the JAX record's log")
    argv = sys.argv[1:] if argv is None else list(argv)
    flags = []
    if "--" in argv:
        i = argv.index("--")
        argv, flags = argv[:i], argv[i + 1:]
    args = p.parse_args(argv)
    if args.mode == "table":
        runs = []
        for path in args.paths:
            with open(path) as f:
                runs.append(json.load(f))
        print(table(runs, args.record))
        return
    out, driver = args.paths
    if args.mode == "jax":
        res = jax_steps(driver, flags, args.perturb, args.draw)
    else:
        if not args.init:
            p.error("port needs --init")
        res = port_steps(driver, args.init, flags, args.bf16_operands,
                         args.perturb, args.draw, args.one_pass_bn)
    with open(out, "w") as f:
        json.dump(res, f)
    for e in res["epochs"]:
        print(f"{_label(res)} epoch {e['epoch']} loss {e['loss']:.5f} "
              f"val MAE {e['val_mae']:.5f} steps "
              + " ".join(f"{x:.7g}" for x in e["step_losses"]), flush=True)


if __name__ == "__main__":
    main()
