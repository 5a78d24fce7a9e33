"""GINE+ of the PyTorch port against the JAX package, on the CPU, on
the molecules and carried weights of `test_torch_port_gine_plus.py`:
  * nested subgraph pooling (sum, and mean for every other value) over
    node copies, every layer and the logits at rtol 1e-5;
  * the train-mode loss (rtol 1e-5) and every gradient (dropout 0);
  * `compute_dtype="bfloat16"` at the JAX package's bf16 tolerance (rtol
    3e-2, `tests/test_playbook_r5.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu_torch.weights import flax_to_state_dict
from tests.test_torch_port_gine_plus import BS, _check_eval, _setup
from tests.test_torch_port_zoo import jax_run


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("pooling", ["sum", "mean"])
def test_gine_plus_nested_pooling(pooling):
    """Node -> copy (sum or mean) -> graph mean pooling over node copies
    without the virtual node (rtol 1e-5)."""
    _check_eval(dict(nested=True, subgraph_pooling=pooling,
                     virtual_node=False, dropout=0.0), "ragged", 2,
                nested=True)


def test_gine_plus_train_loss_and_gradients():
    """Train mode at dropout 0 (batch statistics): the BCE loss (rtol
    1e-5) and every gradient at rtol 1e-4, atol 1e-4 of its tensor's
    largest entry (the atom encoder's rows sum many node gradients, in
    another order than JAX's: 2.4e-4 relative on one entry of 1904 at a
    plain rtol) or 1e-6 of the model's largest gradient (a bias that
    feeds a BatchNorm has a gradient of rounding noise)."""
    jm, v, jb, m, tb = _setup(dict(dropout=0.0), "uniform", 3)
    y = np.random.default_rng(1).integers(0, 2, (BS, 2)).astype(np.float32)

    def bce(out, y):
        return jnp.mean(jnp.maximum(out, 0) - out * y
                        + jnp.log1p(jnp.exp(-jnp.abs(out))))

    def loss_of(p):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                          jb, deterministic=False, use_running_average=False,
                          mutable=["batch_stats"])
        return bce(out[:BS], jnp.asarray(y))

    jloss, jgrads = jax_run(jax.value_and_grad(loss_of), v["params"])
    m.train()
    out = m(tb)
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        out[:BS], torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jgrads), {})
    got = {k: p.grad for k, p in m.named_parameters()}
    assert set(got) == set(want)
    gmax = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        atol = max(1e-4 * float(w.abs().max()), 1e-6 * gmax)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("layout", ["ragged", "uniform"])
def test_gine_plus_bf16(layout):
    """bf16 history, messages and aggregation against JAX's bf16 stack at
    rtol 3e-2 (measured: 1.5e-3 ragged, 2e-7 uniform)."""
    _check_eval(dict(dropout=0.0, compute_dtype="bfloat16"), layout, 3,
                rtol=3e-2)
