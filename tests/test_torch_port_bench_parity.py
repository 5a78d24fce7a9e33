"""The first train step of each bench line on carried weights: the bench
twin's model (`escgnn_tpu_torch/bench.py` `BenchLine.model`, the weights
carried by `weights.py`) and torch Adam against `bench.py`'s flax model,
its loss and the JAX package's `make_train_step` (optax Adam 5e-4), one
step each on the line's batch at BENCH_SMOKE's graph counts
(`test_torch_port_bench.py` `jax_lines`, `port_line`). The flax weights
are drawn with numpy (`test_torch_port_zoo.py` `numpy_variables`); the
JAX step is compiled at XLA's optimization level 0.

  * f32, both sides `compute_dtype="float32"` where the line has one
    (GPS and k123 are f32 as configured): the loss at rel 1e-5, and the
    parameters after the step within 1e-4 of the norm of JAX's update.
    Adam's first step moves an entry by the learning rate times the sign
    of its gradient, so an entry whose gradient is within the two
    packages' rounding of 0 may step either way: an entry under
    `NOISE` of the largest gradient (a bias that feeds a BatchNorm,
    whose exact gradient is 0, and the entries a few sums of rounding
    decide) is left out of that norm and may move by up to 2 * lr. At
    these widths the f32 gradients themselves agree to 3.2e-4 of the
    largest (OGB's virtual-node MLP) and 2.7e-4 (GPS peptides' z
    tables): flipped steps were found on gradients up to 6.1e-5 (OGB)
    and 1.0e-5 (GPS peptides) of the largest;
  * bf16 as configured (flagship, PPGN, OGB, I2GNN, NGNN, NestedPPGN,
    GINE+): the loss at rel 2e-2.

On the CPU JAX's dedup expansion takes XLA's gather and its scatter
transpose (the Pallas sorted segment sum runs on the TPU or in interpret
mode only), and the twin's takes K1's plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.train.loop import TrainState, make_train_step
from escgnn_tpu.train.loop import adam_with_plateau as j_adam
from escgnn_tpu_torch import bench as T
from escgnn_tpu_torch.train.loop import adam_with_plateau, train_step
from escgnn_tpu_torch.weights import flax_to_state_dict, load_flax_variables
from tests.test_torch_port_bench import jax_lines, port_line
from tests.test_torch_port_zoo import _FAST_COMPILE, numpy_variables

NOISE = 1e-4
BF16_LINES = [T.PPGN, T.OGB, T.I2GNN, T.NGNN, T.NESTED_PPGN, T.GINE_PLUS,
              T.FLAGSHIP]
_VARIABLES = {}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _with_dtype(cfg, dtype):
    if dtype is None or not hasattr(cfg, "compute_dtype"):
        return cfg
    return dataclasses.replace(cfg, compute_dtype=dtype)


def _first_steps(metric, dtype):
    """(JAX loss, JAX params after the step, port loss, the port model
    after the step) from one set of drawn weights; `dtype` None keeps the
    line's compute dtype."""
    want, line = jax_lines()[metric], port_line(metric)
    jb = jax.tree.map(jnp.asarray, want["batch"])
    jm = type(want["model"])(_with_dtype(want["model"].cfg, dtype))
    if metric not in _VARIABLES:
        _VARIABLES[metric] = numpy_variables(want["model"], jb)
    v = _VARIABLES[metric]
    params, stats = v["params"], v.get("batch_stats", {})

    state = TrainState.create(jax.tree.map(jnp.asarray, params),
                              jax.tree.map(jnp.asarray, stats),
                              j_adam(T.LR))
    step = make_train_step(jm, want["loss_fn"])
    key = jax.random.key(1)
    new_state, jloss = step.lower(state, jb, key).compile(
        compiler_options=_FAST_COMPILE)(state, jb, key)

    line = dataclasses.replace(line, config=_with_dtype(line.config, dtype))
    m = line.model("cpu")
    load_flax_variables(m, params, stats)
    opt = adam_with_plateau(m.parameters(), T.LR)
    loss = train_step(m, opt, line.host_batch(), line.loss_fn)
    return float(jloss), new_state.params, float(loss), m


@pytest.mark.parametrize("metric", T.METRICS)
def test_first_step_f32(metric):
    jloss, jparams, loss, m = _first_steps(metric, "float32")
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)

    before = flax_to_state_dict(_VARIABLES[metric]["params"], {})
    after = flax_to_state_dict(jax.tree.map(np.asarray, jparams), {})
    got = {k: p.detach() for k, p in m.named_parameters()}
    grads = {k: p.grad for k, p in m.named_parameters()}
    assert set(got) == set(after)
    top = max(float(g.abs().max()) for g in grads.values()
              if g is not None)
    diff2 = update2 = 0.0
    for k, want in after.items():
        g = grads[k] if grads[k] is not None else torch.zeros_like(want)
        noise = g.abs() < NOISE * top
        d = (got[k] - want).abs()
        if noise.any():
            assert float(d[noise].max()) <= 2 * T.LR, k
        diff2 += float((d[~noise] ** 2).sum())
        update2 += float(((want - before[k]) ** 2).sum())
    assert update2 > 0
    assert diff2 ** 0.5 <= 1e-4 * update2 ** 0.5, (diff2 ** 0.5,
                                                   update2 ** 0.5)


@pytest.mark.parametrize("metric", BF16_LINES)
def test_first_step_bf16(metric):
    assert port_line(metric).config.compute_dtype == "bfloat16"
    jloss, _, loss, _ = _first_steps(metric, None)
    np.testing.assert_allclose(loss, jloss, rtol=2e-2)
