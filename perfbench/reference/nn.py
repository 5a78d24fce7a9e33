"""Plain layers for the reference models: weights are a dict of named
float32 tensors, laid out as `torch.nn.Linear`'s ((out, in) and (out,))."""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
ACTS = {"relu": F.relu, "elu": F.elu}


def linear(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[name + ".weight"].t() + p[name + ".bias"]


class Norms:
    """BatchNorm over rows. With `running` None each call normalizes by its
    rows' own mean and biased variance and records, under the layer's name,
    the mean and the unbiased variance; otherwise it normalizes by
    `running[name]` = (mean, variance)."""

    def __init__(self, running: dict | None = None):
        self.running = running
        self.seen: dict = {}

    def __call__(self, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.running is None:
            n = x.shape[0]
            mean = x.mean(0)
            var = ((x - mean) ** 2).mean(0)
            self.seen[name] = (mean.detach(),
                               (var * n / max(n - 1, 1)).detach())
        else:
            mean, var = self.running[name]
        return ((x - mean) * torch.rsqrt(var + BN_EPS) * p[name + ".weight"]
                + p[name + ".bias"])


def l1_mean(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over every row and column."""
    return (out - y).abs().mean()
