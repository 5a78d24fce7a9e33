"""BaselineGNN's heads in the PyTorch port against the JAX package, on
the CPU, through `test_torch_port_zoo.py`'s case runner (numpy-drawn
flax variables carried strictly, eval outputs at rtol 1e-5, gradients
at rtol 1e-4):
jumping knowledge, the deep-supervision heads, nested two-level pooling,
the node-level heads and the node-type embedding.
"""

import pytest
import torch

from tests.test_torch_port_zoo import IN_DIM, _check


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", [
    dict(jk=True, multi_layer=True, out_dim=3, classify=False),
    dict(jk=True, multi_layer=True, node_level=True, out_dim=3),
    dict(nested=True, jk=True),
    dict(nested=True, node_level=True, multi_layer=True, out_dim=3),
    dict(node_level=True, node_embed_vocab=32),
])
def test_baseline_heads(variant):
    """Jumping knowledge, the deep-supervision heads (their outputs
    compared too), nested two-level pooling, the node-level head (per
    copy row when nested) and the node-type embedding (of type ids), on
    8 graphs. The graph-level deep-supervision heads compare outputs
    only: their BatchNorm normalizes 8 graph means that differ by little,
    so the rounding of that small batch variance reaches their
    gradients at 3e-3 relative (the node-level heads hold 1e-4)."""
    graph_heads = variant.get("multi_layer") and not variant.get(
        "node_level")
    _check("BaselineGNN", dict(conv="gcn", hidden=8, num_layers=3,
                               dropout=0.0, **variant),
           copies=variant.get("nested", False),
           onehot=not variant.get("node_embed_vocab"), graphs=8,
           grads=not graph_heads, in_dim=IN_DIM)
