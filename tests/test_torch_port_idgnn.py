"""The RGCN baseline, IDGNN and the model registry of the PyTorch port
against the JAX package, on the CPU, through `test_torch_port_zoo.py`'s
case runner (numpy-drawn flax variables carried strictly, eval outputs
at rtol 1e-5, gradients at rtol 1e-4).
"""

import numpy as np
import pytest
import torch

import escgnn_tpu.models as j_models
from escgnn_tpu_torch.models import registry
from escgnn_tpu_torch.models.idgnn import IDGNN_CONVS
from escgnn_tpu_torch.weights import load_flax_variables
from tests.test_torch_port_zoo import (
    IN_DIM,
    _batches,
    _check,
    numpy_variables,
)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", [
    {}, dict(node_level=True, concat=True)])
def test_rgcn_baseline(variant):
    """The RGCN baseline (relation ids from the ZINC bond types) at graph
    level and per node with concatenated layers."""
    _check("RGCN", dict(num_layers=2, **variant), onehot=False)


@pytest.mark.parametrize("conv", IDGNN_CONVS)
def test_idgnn(conv):
    """Each IDGNN conv on node copies (the roots carry the identity)."""
    _check("IDGNN", dict(conv=conv, hidden=8, num_layers=2, dropout=0.0),
           copies=True, in_dim=IN_DIM)


def test_registry_names_and_strict_loads():
    """The port registers every name of the JAX registry; keywords that
    are neither config fields nor constructor arguments raise, and so
    does a fixed field; a flax state with a missing or an extra leaf
    does not load."""
    assert sorted(registry._REGISTRY) == sorted(j_models.registry._REGISTRY)
    with pytest.raises(TypeError, match="unknown keyword"):
        registry.get_model("RGCN", device="cpu", widht=3)
    with pytest.raises(TypeError, match="fixed"):
        registry.get_model("k1_GNN", levels=(2,), x_dim=1, edge_dim=1)
    with pytest.raises(KeyError, match="unknown model"):
        registry.get_model("GPS")
    jb, _ = _batches(False, onehot=False)
    params = numpy_variables(j_models.get_model("RGCN", num_layers=2),
                             jb)["params"]
    m = registry.get_model("RGCN", num_layers=2, device="cpu")
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="not consumed"):
        load_flax_variables(m, extra, {})
    missing = {k: v for k, v in params.items() if k != "fc3"}
    with pytest.raises(ValueError, match="not filled"):
        load_flax_variables(m, missing, {})
