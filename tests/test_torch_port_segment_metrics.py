"""The port's segment reductions, OGB losses and metrics against the JAX
package, on the CPU.

Segment mean/max/min/softmax: values and gradients (of a fixed random
projection of the output) on one numpy-seeded input with masked rows,
empty segments and tied values, f32, rtol 1e-6. The losses: NaN-masked
BCE over padded graphs, node CE with labels outside the split, the
sequence CE, rtol 1e-6. ROC-AUC and AP: the port's numpy versions
against the JAX package's sklearn-based ones on tied scores, NaN holes,
one-class tasks and the all-skipped NaN case, abs 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.ops import segment as jseg
from escgnn_tpu.train import loop as jloop
from escgnn_tpu.train import metrics as jmetrics
from escgnn_tpu_torch.data.container import GraphBatch
from escgnn_tpu_torch.ops import segment as tseg
from escgnn_tpu_torch.train import loop as tloop
from escgnn_tpu_torch.train import metrics as tmetrics

S = 7  # segments; 5 and 6 stay empty


def _segment_input():
    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, 5, 40)).astype(np.int32)
    vals = rng.normal(size=(40, 3)).astype(np.float32)
    # ties: a segment's max and min shared by two rows
    first = np.flatnonzero(ids == 1)
    vals[first[1]] = vals[first[0]]
    mask = rng.random(40) > 0.25
    mask[ids == 3] = False  # segment 3 all masked: empty after the mask
    mask[first[:2]] = True
    proj = rng.normal(size=(S, 3)).astype(np.float32)
    return ids, vals, mask, proj


def _jax_op(name, vals, ids, mask):
    fn = getattr(jseg, f"segment_{name}")
    if name == "softmax":
        return fn(vals[:, 0], ids, S, mask=mask)
    return fn(vals, ids, S, mask=mask)


def _torch_op(name, vals, ids, mask):
    fn = getattr(tseg, f"segment_{name}")
    if name == "softmax":
        return fn(vals[:, 0], ids, S, mask=mask)
    return fn(vals, ids, S, mask=mask)


@pytest.mark.parametrize("name", ["mean", "max", "min", "softmax"])
@pytest.mark.parametrize("masked", [True, False])
def test_segment_values_and_grads(name, masked):
    """Values and the gradient of sum(out * proj) against JAX (rtol
    1e-6, atol 1e-7); tied max/min split their gradient evenly in both;
    empty segments give 0."""
    ids, vals, mask, proj = _segment_input()
    m = mask if masked else None
    w = proj[ids, 0] if name == "softmax" else proj

    def jloss(v):
        out = _jax_op(name, v, jnp.asarray(ids),
                      None if m is None else jnp.asarray(m))
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(vals))
    tv = torch.tensor(vals, requires_grad=True)
    tout = _torch_op(name, tv, torch.tensor(ids),
                     None if m is None else torch.tensor(m))
    (tout * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-7)
    if name != "softmax":
        assert np.all(tout.detach().numpy()[5:] == 0.0)
        if masked:
            assert np.all(tout.detach().numpy()[3] == 0.0)


def test_segment_softmax_ignores_huge_masked_logits():
    """A masked logit above its segment's max reaches neither the output
    nor the gradient (no inf * 0)."""
    logits = torch.tensor([1.0, 2.0, 1e30, 0.5], requires_grad=True)
    ids = torch.tensor([0, 0, 0, 1])
    mask = torch.tensor([True, True, False, True])
    out = tseg.segment_softmax(logits, ids, 2, mask=mask)
    out.sum().backward()
    assert torch.isfinite(logits.grad).all()
    np.testing.assert_allclose(out.detach().numpy()[[0, 1, 3]].sum(), 2.0,
                               rtol=1e-6)
    assert out[2].item() == 0.0


def _padded_bce_batch():
    rng = np.random.default_rng(1)
    y = (rng.random((6, 4)) > 0.5).astype(np.float32)
    y[rng.random((6, 4)) < 0.3] = np.nan
    y[5] = 0.0  # the padding graph's row
    gm = np.array([True] * 5 + [False])
    logits = rng.normal(size=(6, 4)).astype(np.float32) * 3
    return y, gm, logits


def test_masked_bce_with_logits():
    """NaN holes and the padding graph drop out of the mean (rtol 1e-6),
    gradients equal JAX's; the loss is finite with every label a hole."""
    y, gm, logits = _padded_bce_batch()

    class JB:
        pass

    jb = JB()
    jb.y, jb.graph_mask = jnp.asarray(y), jnp.asarray(gm)
    jl, jg = jax.value_and_grad(
        lambda x: jmetrics.masked_bce_with_logits(x, jb))(jnp.asarray(logits))
    tb = GraphBatch(y=torch.tensor(y), graph_mask=torch.tensor(gm))
    tx = torch.tensor(logits, requires_grad=True)
    tl = tloop.bce_graph_loss(tx, tb)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-8)
    holes = GraphBatch(y=torch.full((6, 4), float("nan")),
                       graph_mask=torch.tensor(gm))
    assert tmetrics.masked_bce_with_logits(tx, holes).item() == 0.0


def test_ce_node_and_sequence_losses():
    """ce_node_loss (labels < 0 and padding nodes dropped) and the
    sequence CE against JAX, rtol 1e-6."""
    rng = np.random.default_rng(2)
    out = rng.normal(size=(10, 5)).astype(np.float32)
    labels = rng.integers(-1, 5, 10).astype(np.int32)
    nmask = np.arange(10) < 8

    class JB:
        pass

    jb = JB()
    jb.y, jb.node_mask = jnp.asarray(labels), jnp.asarray(nmask)
    want = float(jloop.ce_node_loss(jnp.asarray(out), jb))
    got = tloop.ce_node_loss(torch.tensor(out), GraphBatch(
        y=torch.tensor(labels), node_mask=torch.tensor(nmask))).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)

    seq = rng.normal(size=(4, 3 * 6)).astype(np.float32)
    toks = rng.integers(0, 6, (4, 3)).astype(np.int32)
    gm = np.array([True, True, True, False])
    jb.y, jb.graph_mask = jnp.asarray(toks), jnp.asarray(gm)
    want = float(jloop.make_sequence_ce_loss(3, 6)(jnp.asarray(seq), jb))
    got = tloop.make_sequence_ce_loss(3, 6)(torch.tensor(seq), GraphBatch(
        y=torch.tensor(toks), graph_mask=torch.tensor(gm))).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _metric_case(kind):
    rng = np.random.default_rng(3)
    n, t = 60, 4
    y = (rng.random((n, t)) > 0.6).astype(np.float64)
    s = rng.normal(size=(n, t))
    if kind == "ties":
        s = np.round(s, 1)  # many tied scores across both classes
    elif kind == "nan_holes":
        y[rng.random((n, t)) < 0.3] = np.nan
    elif kind == "one_class":
        y[:, 1] = 1.0  # task 1 has no negatives
        y[:, 2] = 0.0  # task 2 has no positives
        y[::3, 3] = np.nan
    elif kind == "all_skipped":
        y[:, :] = 0.0
        y[::2, 0] = np.nan
    return y, s


@pytest.mark.parametrize("kind", ["ties", "nan_holes", "one_class",
                                  "all_skipped"])
@pytest.mark.parametrize("metric", ["rocauc", "average_precision"])
def test_metric_against_sklearn(metric, kind):
    """The numpy metric equals the JAX package's sklearn-based one (abs
    1e-12); both are NaN when every task is skipped."""
    y, s = _metric_case(kind)
    want = getattr(jmetrics, metric)(y, s)
    got = getattr(tmetrics, metric)(y, s)
    if kind == "all_skipped":
        assert np.isnan(want) and np.isnan(got)
    else:
        assert abs(got - want) <= 1e-12, (got, want)


def test_pool_logits_step_and_generators():
    """make_pool_logits_step returns (logits, y, graph_mask) of every
    batch of a stacked pool, with the model in eval() on its running
    statistics; `model_generators` lists what `generators()` returns,
    or nothing."""
    lin = torch.nn.Linear(2, 3)

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = lin

        def forward(self, b):
            return self.lin(b.x)

    x = torch.randn(2, 4, 2)
    stacked = GraphBatch(x=x, y=torch.zeros(2, 4, 1),
                         graph_mask=torch.ones(2, 4, dtype=torch.bool))
    m = M().train()
    logits, y, gm = tloop.make_pool_logits_step(m)(stacked)
    assert not m.training
    torch.testing.assert_close(logits, lin(x).detach())
    assert y is stacked.y and gm is stacked.graph_mask
    assert tloop.model_generators(m) == []
    g = torch.Generator()
    m.generators = lambda: [g]
    assert tloop.model_generators(m) == [g]
