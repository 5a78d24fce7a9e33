"""The reference's readings for a run: the same first three train steps
from the same weights on the same graphs, and in an epoch cell the BN
refresh and the val and test errors from the drawn weights, computed by
the plain reference (`perfbench/reference/`) with its own ESC
encoding."""

from __future__ import annotations

import contextlib

import torch

from perfbench.reference import batch as rbatch
from perfbench.reference import train as rtrain


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 in matrix products and convolutions on or off in the block,
    and PyTorch's deterministic algorithms on (the reference's sums by
    index add in a fixed order, so one seed gives one reading)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    old_det = (torch.are_deterministic_algorithms_enabled(),
               torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
        torch.use_deterministic_algorithms(old_det[0], warn_only=old_det[1])


def norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def encode_groups(groups: dict, h: int, workers: int) -> dict:
    """The reference encoding of every graph named in `groups` ({part:
    [[(graph, y), ...] per batch]}), encoded once each."""
    flat = [g for batches in groups.values() for b in batches for g, _ in b]
    enc = rbatch.encode_all(flat, h, workers)
    out, i = {}, 0
    for part, batches in groups.items():
        out[part] = []
        for b in batches:
            out[part].append(enc[i:i + len(b)])
            i += len(b)
    return out


def make_batches(groups: dict, encodings: dict, device) -> dict:
    return {part: [rbatch.make_batch([g for g, _ in b], e, [y for _, y in b],
                                     device)
                   for b, e in zip(batches, encodings[part])]
            for part, batches in groups.items()}


def readings(model: str, fields: dict, weights: dict, batches: dict,
             opt: dict, tf32: bool = False, fault: str | None = None) -> dict:
    """The reference's readings (`checks.gaps`' layout). `batches` holds
    "train" (the three steps' batches) and, in an epoch cell, "refresh",
    "val" and "test" (the refresh and evals run from `weights`, before
    the steps, as the system's check runs them). `tf32` computes it in
    TF32 (the control); `fault` plants "drop_half" or "alter_answer"
    (the faults' readings)."""
    mod = rtrain.model(model)
    mod.check(fields)
    out = {}
    with matmul_precision(tf32):
        if "refresh" in batches:
            stats = rtrain.refresh(mod, fields, weights, batches["refresh"])
            out["stats"] = {}
            for k, (mu, var) in stats.items():
                out["stats"][k + ".running_mean"] = float(
                    torch.linalg.vector_norm(mu.double()))
                out["stats"][k + ".running_var"] = float(
                    torch.linalg.vector_norm(var.double()))
            for part in ("val", "test"):
                out[part] = rtrain.mean_abs_error(
                    mod, fields, weights, stats, batches[part],
                    alter_first=fault == "alter_answer")
        tr = rtrain.train(mod, fields, weights, batches["train"], opt["lr"],
                          opt["grad_clip"], drop_half=fault == "drop_half",
                          alter_first=fault == "alter_answer")
        out.update(losses=tr["losses"], grad1=norms(tr["grad1"]),
                   change=norms({k: tr["weights"][k] - weights[k]
                                 for k in weights}))
    return out
