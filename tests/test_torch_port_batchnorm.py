"""`MaskedBatchNorm`'s batch statistics against the JAX package's, and on
a column whose rows are equal.

The port centres the rows about a first-pass mean before it sums their
squares (the JAX package sums x and x^2 in one pass). On ordinary rows
the two agree to f32 rounding; on a column of equal rows the port's
output is 0, where the one-pass form leaves the mean's rounding error
divided by sqrt(eps), whose size depends on the order of the sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.models.layers import MaskedBatchNorm as JaxBN
from escgnn_tpu_torch.models.layers import MaskedBatchNorm

ROWS, COLS = 37, 6


def _mask(kind, rng):
    if kind == "none":
        return None
    if kind == "bool":
        m = np.ones(ROWS, bool)
        m[[3, 17, 30]] = False
        return m
    return rng.integers(0, 4, ROWS).astype(np.float32)  # row multiplicities


@pytest.mark.parametrize("mask_kind", ["none", "bool", "weights"])
def test_batch_statistics_match_jax(mask_kind):
    """Train-mode output, running statistics and the input's gradient
    equal JAX's on ordinary rows (rtol 1e-5, atol 1e-5 of the largest)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(ROWS, COLS)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=(ROWS, COLS)).astype(np.float32)
    mask = _mask(mask_kind, rng)

    jbn = JaxBN()
    jm = None if mask is None else jnp.asarray(mask)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jm)

    def jloss(xx):
        y, upd = jbn.apply(variables, xx, jm, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    (_, (jy, upd)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))

    bn = MaskedBatchNorm(COLS)
    tx = torch.tensor(x, requires_grad=True)
    tm = None if mask is None else torch.as_tensor(mask)
    y = bn(tx, tm)
    (y * torch.as_tensor(g)).sum().backward()

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())

    close(y.detach().numpy(), jy)
    close(tx.grad.numpy(), jgrad)
    close(bn.running_mean.numpy(), upd["batch_stats"]["mean"])
    close(bn.running_var.numpy(), upd["batch_stats"]["var"])


@pytest.mark.parametrize("mask_kind", ["none", "bool", "weights"])
def test_column_of_equal_rows_normalizes_to_zero(mask_kind):
    """Each column holds one value in every row: the batch variance is 0
    and the normalized rows are 0, within 1e-8 (the one-pass form gives
    the mean's rounding error times 1/sqrt(1e-5), up to 1e-4 here), and
    the running mean is the value itself."""
    rng = np.random.default_rng(1)
    values = (rng.normal(size=COLS) * 3).astype(np.float32)
    x = torch.tensor(np.tile(values, (ROWS, 1)))
    mask = _mask(mask_kind, rng)
    bn = MaskedBatchNorm(COLS)
    y = bn(x, None if mask is None else torch.as_tensor(mask))
    assert y.abs().max().item() <= 1e-8
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * values,
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9, rtol=1e-6)
