"""Model registry (counterpart of `escgnn_tpu/models/registry.py` and of
the registrations in `escgnn_tpu/models/__init__.py`): an explicit name
-> constructor map under the JAX registry's names.

    get_model(name, device="cuda", generator=None, **kwargs)

A flax model reads its input widths from the batch it is initialised
on; a torch module needs them when it is built. So `kwargs` holds the
config fields (the JAX registry's keywords) and, besides them, the
constructor's own keywords: `in_dim` (BaselineGNN, IDGNN,
NestedGIN_eff, NestedPPGN), `edge_attr_dim` (NestedGIN_eff),
`edge_dim` (NestedPPGN), `x_dim`, `edge_dim` and `has_pos` (the
k-GNNs) and `rng_seed` (the models with dropout). Unknown keywords
raise, as an unknown config field does in JAX.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

from escgnn_tpu_torch.models.baselines import (
    BaselineGNN,
    BaselineGNNConfig,
    RGCNBaseline,
    RGCNBaselineConfig,
)
from escgnn_tpu_torch.models.gine_plus import GINEPlusConfig, GINEPlusNetwork
from escgnn_tpu_torch.models.idgnn import IDGNN, IDGNNConfig
from escgnn_tpu_torch.models.kgnn_models import KGNN, KGNNConfig
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.models.nested_ppgn import NestedPPGN, NestedPPGNConfig
from escgnn_tpu_torch.models.ngnn import NGNN, NGNNConfig
from escgnn_tpu_torch.models.ogb_gnn import OgbGNN, OgbGNNConfig
from escgnn_tpu_torch.models.ppgn import PPGN, PPGNConfig

_REGISTRY: dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def _factory(model_cls, cfg_cls, **fixed):
    """A constructor that sends the config's fields (over `fixed`) to
    `cfg_cls` and every other keyword to `model_cls`."""
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    accepted = set(inspect.signature(model_cls.__init__).parameters) - {
        "self", "cfg"}

    def build(**kwargs):
        cfg_kw = dict(fixed)
        ctor_kw = {}
        for k, v in kwargs.items():
            if k in fixed:
                raise TypeError(f"{model_cls.__name__}: {k!r} is fixed to "
                                f"{fixed[k]!r} under this name")
            if k in fields:
                cfg_kw[k] = v
            elif k in accepted:
                ctor_kw[k] = v
            else:
                raise TypeError(f"{model_cls.__name__}: unknown keyword "
                                f"{k!r}")
        return model_cls(cfg_cls(**cfg_kw), **ctor_kw)

    return build


for _name, _build in {
    "NestedGIN_eff": _factory(NestedGINEff, NestedGINEffConfig),
    "OgbGNN": _factory(OgbGNN, OgbGNNConfig),
    "PPGN": _factory(PPGN, PPGNConfig),
    "PPGN_eff": _factory(PPGN, PPGNConfig, use_esc=True),
    "NGNN": _factory(NGNN, NGNNConfig),
    "BaselineGNN": _factory(BaselineGNN, BaselineGNNConfig),
    "RGCN": _factory(RGCNBaseline, RGCNBaselineConfig),
    "IDGNN": _factory(IDGNN, IDGNNConfig),
    "GINEPlus": _factory(GINEPlusNetwork, GINEPlusConfig),
    "NestedPPGN": _factory(NestedPPGN, NestedPPGNConfig),
    "k1_GNN": _factory(KGNN, KGNNConfig, levels=(), nested=False),
    "Nested_k12_GNN": _factory(KGNN, KGNNConfig, levels=(2,)),
    "Nested_k13_GNN": _factory(KGNN, KGNNConfig, levels=(3,)),
    "Nested_k123_GNN": _factory(KGNN, KGNNConfig, levels=(2, 3)),
}.items():
    register_model(_name)(_build)


def get_model(name: str, **kwargs):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
