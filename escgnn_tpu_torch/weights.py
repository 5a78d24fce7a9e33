"""Carry a flax NestedGINEff state into the PyTorch model.

The flax `params` and `batch_stats` trees arrive as nested dicts of numpy
arrays (the caller converts; this module imports no JAX). Names map
one to one, with three rules:
  * flax creates each conv's MLP in the parent scope, as `MLP_<i>`; here
    it lives inside its conv: `MLP_<i>` -> `conv<i+1>.mlp`;
  * leaf names: `kernel` -> `weight` (transposed: flax keeps (in, out),
    nn.Linear (out, in)), `scale` and `embedding` -> `weight`, batch
    statistics `mean`/`var` -> `running_mean`/`running_var`;
  * everything else keeps its name (`z_initial`, `eps`, `bias`, ...).
The load is strict: every flax leaf must land on a model tensor of the
same shape and every model tensor must be filled, or it raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(path, leaf_map) -> str:
    parts = list(path)
    m = re.fullmatch(r"MLP_(\d+)", parts[0])
    if m:
        parts[:1] = [f"conv{int(m.group(1)) + 1}", "mlp"]
    parts[-1] = leaf_map.get(parts[-1], parts[-1])
    return ".".join(parts)


def flax_to_state_dict(params: dict, batch_stats: dict) -> dict:
    """Flat {torch state_dict key: tensor} from the two flax trees."""
    out = {}
    for leaf_map, tree in ((_PARAM_LEAF, params), (_STAT_LEAF, batch_stats)):
        for path, value in _flatten(tree):
            a = np.asarray(value, np.float32)
            if path[-1] == "kernel":
                a = a.T
            key = _torch_key(path, leaf_map)
            if key in out:
                raise ValueError(f"two flax leaves map to {key!r}")
            # a writable C-ordered copy (keeps 0-d leaves such as eps 0-d)
            out[key] = torch.from_numpy(np.array(a, order="C"))
    return out


def load_flax_variables(model: torch.nn.Module, params: dict,
                        batch_stats: dict) -> None:
    """Fill `model` in place from flax `params` / `batch_stats`."""
    src = flax_to_state_dict(params, batch_stats)
    dst = model.state_dict()
    missing = sorted(set(dst) - set(src))
    unused = sorted(set(src) - set(dst))
    if missing or unused:
        raise ValueError(
            f"flax state does not match the model: model tensors not "
            f"filled {missing}, flax leaves not consumed {unused}")
    for k, v in src.items():
        if tuple(v.shape) != tuple(dst[k].shape):
            raise ValueError(
                f"{k}: flax shape {tuple(v.shape)} != model shape "
                f"{tuple(dst[k].shape)}")
    model.load_state_dict(
        {k: v.to(dst[k].device, dst[k].dtype) for k, v in src.items()})
