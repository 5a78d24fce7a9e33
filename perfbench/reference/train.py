"""Training, BatchNorm refresh and evaluation for the reference models:
autograd gradients, optax's global-norm clip, and Adam (b1 0.9, b2 0.999,
eps 1e-8) written out."""

from __future__ import annotations

import importlib

import torch

from perfbench.reference.nn import Norms

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def model(name: str):
    """The reference model module `perfbench/reference/<name>.py`."""
    return importlib.import_module(f"perfbench.reference.{name}")


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """optax.clip_by_global_norm: g unchanged when ||g|| < max_norm, else
    g * max_norm / ||g||."""
    if max_norm <= 0:
        return grads
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    if norm < max_norm:
        return grads
    return {k: g * (max_norm / norm).to(g.dtype) for k, g in grads.items()}


def train(mod, fields: dict, weights: dict, batches, lr: float,
          grad_clip: float, drop_half: bool = False,
          alter_first: bool = False) -> dict:
    """Adam over `batches` in order from `weights`. Returns each step's
    loss, the first step's gradients as Adam takes them (after the clip),
    and the weights after the last step.

    Faults for the control readings: `drop_half` takes each batch's loss
    over its first half of graphs only; `alter_first` adds 1 to the first
    output row of every step."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in
         weights.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t, b in enumerate(batches, start=1):
        out = mod.forward(p, b, fields, Norms())
        if alter_first:
            out = torch.cat([out[:1] + 1.0, out[1:]])
        if drop_half:
            keep = _first_half_rows(b, out.shape[0])
            loss = (out[keep] - b.y[keep]).abs().mean()
        else:
            loss = mod.loss(out, b)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()),
                                                allow_unused=True)))
        grads = {k: torch.zeros_like(p[k]) if g is None else g
                 for k, g in grads.items()}
        grads = clip_by_global_norm(grads, grad_clip)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k in p:
                m[k].mul_(B1).add_(grads[k], alpha=1 - B1)
                v2[k].mul_(B2).addcmul_(grads[k], grads[k], value=1 - B2)
                mhat = m[k] / (1 - B1 ** t)
                vhat = v2[k] / (1 - B2 ** t)
                p[k] -= lr * mhat / (torch.sqrt(vhat) + ADAM_EPS)
        losses.append(float(loss.detach()))
    return dict(losses=losses, grad1=first,
                weights={k: v.detach() for k, v in p.items()})


def _first_half_rows(b, rows: int) -> torch.Tensor:
    """The output rows of the batch's first half of graphs."""
    half = b.num_graphs // 2
    if rows == b.num_graphs:
        return torch.arange(half, device=b.y.device)
    return (b.node_graph < half).nonzero()[:, 0]


@torch.no_grad()
def refresh(mod, fields: dict, weights: dict, batches) -> dict:
    """BatchNorm statistics as the mean over `batches` of each batch's own
    mean and unbiased variance, by layer name."""
    acc: dict = {}
    for b in batches:
        norms = Norms()
        mod.forward(weights, b, fields, norms)
        for k, (mu, var) in norms.seen.items():
            a = acc.setdefault(k, [0.0, 0.0])
            a[0] = a[0] + mu
            a[1] = a[1] + var
    n = len(batches)
    return {k: (a[0] / n, a[1] / n) for k, a in acc.items()}


@torch.no_grad()
def mean_abs_error(mod, fields: dict, weights: dict, running: dict,
                   batches, alter_first: bool = False) -> float:
    """The mean absolute error over every row of `batches` under the
    statistics `running`; `alter_first` adds 1 to the first output row
    (a fault for the control readings)."""
    tot = cnt = 0.0
    for b in batches:
        out = mod.forward(weights, b, fields, Norms(running))
        if alter_first:
            out = torch.cat([out[:1] + 1.0, out[1:]])
        e = mod.errors(out, b)
        tot += float(e.double().sum())
        cnt += e.numel()
    return tot / max(cnt, 1.0)
