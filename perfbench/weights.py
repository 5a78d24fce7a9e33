"""The weights of a run, drawn on the device from its seed in two calls
(one uniform, one normal draw) and cut into the model's parameters by the
rules of the model's adapter (`perfbench/systems/<model>.py`
`draw_rule`). The system and the reference get the same tensors."""

from __future__ import annotations

import math

import torch
from torch import nn


def _plan(model: nn.Module, rule) -> list:
    """(name, shape, kind, bound) of every parameter, in
    `named_parameters` order; `rule(module, name, param)` gives each
    parameter's (kind, bound), or None where it has no rule."""
    kinds = {}
    for mname, mod in model.named_modules():
        for pname, prm in mod.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            kind = rule(mod, pname, prm)
            if kind is None:
                raise ValueError(f"no drawing rule for parameter {full}")
            kinds[full] = (tuple(prm.shape),) + tuple(kind)
    return [(n,) + kinds[n] for n, _ in model.named_parameters()]


def draw(model: nn.Module, seed: int, device, rule) -> dict:
    """{name: float32 tensor on `device`} for every parameter of `model`,
    each drawn by `rule` (the system adapter's `draw_rule`)."""
    plan = _plan(model, rule)
    g = torch.Generator(device=device).manual_seed(int(seed))
    size = {k: sum(math.prod(s) for _, s, kk, _ in plan if kk == k)
            for k in ("uniform", "normal")}
    pools = {
        "uniform": torch.rand(size["uniform"], generator=g, device=device),
        "normal": torch.randn(size["normal"], generator=g, device=device),
    }
    at = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, kind, bound in plan:
        if kind in ("ones", "zeros"):
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(
                shape, device=device)
            continue
        n = math.prod(shape)
        flat = pools[kind][at[kind]:at[kind] + n]
        at[kind] += n
        out[name] = (flat * (2 * bound) - bound if kind == "uniform"
                     else flat).reshape(shape).clone()
    return out


@torch.no_grad()
def load(model: nn.Module, weights: dict) -> None:
    for name, p in model.named_parameters():
        p.copy_(weights[name])
