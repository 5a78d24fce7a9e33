"""What several adapters share: torch's default initialization of its
standard modules, and the drivers' uniform block layouts."""

import math

from torch import nn


def default_rule(mod, pname: str, prm):
    """torch's default rule for a parameter of a standard module: a
    Linear's weight and bias U(+-1/sqrt(fan_in)), an embedding table
    N(0, 1), a BatchNorm's or LayerNorm's scale 1 and shift 0; None for
    any other parameter."""
    del prm
    if hasattr(mod, "running_mean") or isinstance(mod, nn.LayerNorm):
        return ("ones", 0.0) if pname == "weight" else ("zeros", 0.0)
    if isinstance(mod, nn.Embedding):
        return ("normal", 1.0)
    if isinstance(mod, nn.Linear):
        return ("uniform", 1.0 / math.sqrt(mod.in_features))
    return None


def uniform_spec(graphs: list, batch_size: int, layout: str):
    """The drivers' uniform per-graph blocks; `layout` "uniform_dedup"
    (deduplicated ESC rows) is the one the flagship drivers use."""
    from escgnn_tpu_torch.data.batching import BatchSpec

    if layout != "uniform_dedup":
        raise ValueError(f"layout {layout!r}")
    return BatchSpec.uniform(graphs, batch_size, enc_layout="dedup")
