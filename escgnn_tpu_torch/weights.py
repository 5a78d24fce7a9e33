"""Carry a flax model state (NestedGINEff, PPGN, OgbGNN, NGNN, I2GNN,
NestedPPGN, BaselineGNN, RGCNBaseline, IDGNN, GINEPlusNetwork, KGNN)
into the PyTorch model.

The flax `params` and `batch_stats` trees arrive as nested dicts of numpy
arrays (the caller converts; this module imports no JAX). Names map
one to one, with these rules:
  * flax creates each NestedGINEff (and BaselineGNN GIN) conv's MLP in
    the parent scope, as a top-level `MLP_<i>`; here it lives inside its
    conv: `MLP_<i>` -> `conv<i+1>.mlp` (only that exact top-level name:
    OgbGNN's `mlp_virtualnode_<i>` keeps its name). A model whose GIN
    convs hold two MLPs (IDGNN: `mlp`, `mlp_id`) says so with
    `flax_mlps_per_conv = 2`: `MLP_<2i>` -> `conv<i+1>.mlp`,
    `MLP_<2i+1>` -> `conv<i+1>.mlp_id`;
  * a `FeatureSumEncoder` table `emb_<i>/embedding` is the encoder's
    parameter `emb_<i>`;
  * leaf names: `kernel` -> `weight` (a Dense kernel transposed: flax
    keeps (in, out), nn.Linear (out, in); a 1-D conv kernel permuted from
    flax's (width, in, out) to nn.Conv1d's (out, in, width)), `scale` and
    `embedding` -> `weight`, batch statistics `mean`/`var` ->
    `running_mean`/`running_var`;
  * everything else keeps its name and its flax layout (`z_initial`,
    `eps`, `bias`, the LSTM gates `ii` ... `ho`, RGCN's `w_rel` (R, F, F'),
    GAT's `att_src` / `att_dst` / `att`, PNA's `w_pre` / `b_pre` /
    `w_post` / `b_post`, GINE+'s `v0`, ...): only a leaf named `kernel`
    is transposed.
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


def _torch_key(path, leaf_map, mlps_per_conv: int = 1) -> str:
    parts = list(path)
    m = re.fullmatch(r"MLP_(\d+)", parts[0])
    if m:
        conv, j = divmod(int(m.group(1)), mlps_per_conv)
        parts[:1] = [f"conv{conv + 1}", "mlp_id" if j else "mlp"]
    if (len(parts) > 1 and parts[-1] == "embedding"
            and re.fullmatch(r"emb_\d+", parts[-2])):
        return ".".join(parts[:-1])
    parts[-1] = leaf_map.get(parts[-1], parts[-1])
    return ".".join(parts)


def flax_to_state_dict(params: dict, batch_stats: dict,
                       mlps_per_conv: int = 1) -> dict:
    """Flat {torch state_dict key: tensor} from the two flax trees."""
    out = {}
    for leaf_map, tree in ((_PARAM_LEAF, params), (_STAT_LEAF, batch_stats)):
        for path, value in _flatten(tree):
            a = np.asarray(value, np.float32)
            if path[-1] == "kernel":
                a = a.T if a.ndim == 2 else np.transpose(a, (2, 1, 0))
            key = _torch_key(path, leaf_map, mlps_per_conv)
            if key in out:
                raise ValueError(f"two flax leaves map to {key!r}")
            # a writable C-ordered copy (keeps 0-d leaves such as eps 0-d)
            out[key] = torch.from_numpy(np.array(a, order="C"))
    return out


def load_flax_variables(model: torch.nn.Module, params: dict,
                        batch_stats: dict) -> None:
    """Fill `model` in place from flax `params` / `batch_stats`."""
    src = flax_to_state_dict(params, batch_stats,
                             getattr(model, "flax_mlps_per_conv", 1))
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
