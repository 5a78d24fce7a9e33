"""The TU baselines' pooling zoo of the port (`models/pooling.py`:
`TopKPool`, `dense_diff_pool`, `batch_dense_adj`, `graclus_cluster`,
`pool_by_cluster`), `ops/segment.py` `masked_mean` and the torch-default
initializers of `models/layers.py`, against the JAX package on the CPU.

The batches are 3 random graphs with numpy-drawn features, batched by
each package into a 4-graph spec (one empty graph slot). Held: TopKPool's
kept mask bit-equal and its output and gradients (input and score
vector) at rtol 1e-5; DiffPool's pooled features, adjacency, both
losses and their gradient at rtol 1e-5; the dense adjacency bit-equal;
graclus's ids bit-equal for the same seed (the same
`np.random.default_rng` draws); each cluster pooling at rtol 1e-6;
`masked_mean` over every axis at rtol 1e-6. The initializers draw from
JAX's distributions (the bounds, and the moments of 20000 draws within 5
standard errors). `weights.py` carries TopKPool's `weight` both ways.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.container import GraphData as JGraphData
from escgnn_tpu.models import layers as jlayers
from escgnn_tpu.models import pooling as jpool
from escgnn_tpu.ops.segment import masked_mean as j_masked_mean
from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.models import layers
from escgnn_tpu_torch.models import pooling
from escgnn_tpu_torch.ops.segment import masked_mean
from escgnn_tpu_torch.weights import load_flax_variables
from tests.conftest import random_graph

F = 5
M = 16  # dense nodes per graph


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(3)
    raw = []
    for _ in range(3):
        n, ei = random_graph(rng, n=int(rng.integers(5, 11)), p=0.4)
        raw.append((n, ei, rng.normal(size=(n, F)).astype(np.float32)))
    jg = [JGraphData(num_nodes=n, edge_index=ei, x=x) for n, ei, x in raw]
    tg = [GraphData(num_nodes=n, edge_index=ei, x=x) for n, ei, x in raw]
    jb = jax.tree.map(jnp.asarray,
                      j_pad_and_batch(jg, JBatchSpec.from_graphs(jg, 4)))
    tb = pad_and_batch(tg, BatchSpec.from_graphs(tg, 4), device="cpu")
    return jb, tb, raw


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=rtol)


@pytest.mark.parametrize("ratio", [0.5, 0.8])
def test_topk_pool_equals_jax(batches, ratio):
    """Mask-form TopK: the kept nodes (ceil(ratio * n_g) per graph, none
    of the padding), x' and the gradients of sum(sin(x')) with respect
    to x and the score vector; the flax `weight` carried by
    `load_flax_variables`."""
    jb, tb, raw = batches
    jm = jpool.TopKPool(ratio=ratio)
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(1), jb.x, jb,
                                         jb.node_mask))
    (jx, jkeep) = jm.apply(v, jb.x, jb, jb.node_mask)

    def j_obj(params, x):
        out, _ = jm.apply({"params": params}, x, jb, jb.node_mask)
        return jnp.sum(jnp.sin(out))

    jgp, jgx = jax.grad(j_obj, argnums=(0, 1))(v["params"], jb.x)
    m = pooling.TopKPool(F, ratio=ratio, generator=torch.Generator())
    load_flax_variables(m, v["params"], {})
    x = tb.x.clone().requires_grad_(True)
    out, keep = m(x, tb, tb.node_mask)
    assert torch.equal(keep, torch.from_numpy(np.array(jkeep)))
    ng = tb.node_graph.numpy()
    for gi, (n, _, _) in enumerate(raw):
        assert int(keep.numpy()[ng == gi].sum()) == math.ceil(ratio * n)
    _close(out, jx)
    torch.sin(out).sum().backward()
    _close(x.grad, jgx)
    _close(m.weight.grad, jgp["weight"])
    assert float(m.weight.grad.abs().sum()) > 0


def test_topk_pool_weight_round_trip():
    """TopKPool's score vector: drawn N(0, 0.1) like flax's, carried from
    a flax tree and read back from the state dict unchanged."""
    m = pooling.TopKPool(4000, generator=torch.Generator().manual_seed(0))
    std = float(m.weight.detach().std())
    assert abs(std - 0.1) < 5 * 0.1 / math.sqrt(2 * 4000)
    w = np.random.default_rng(0).normal(size=7).astype(np.float32)
    m = pooling.TopKPool(7, generator=torch.Generator())
    load_flax_variables(m, {"weight": w}, {})
    np.testing.assert_array_equal(m.state_dict()["weight"].numpy(), w)


def test_diff_pool_and_dense_adj_equal_jax(batches):
    """`batch_dense_adj` bit-equal; `dense_diff_pool` on the dense view
    and numpy-drawn assignment logits: x', adj', the link and entropy
    losses and the gradient of their sum with weighted sums of x' and
    adj' with respect to the logits, at rtol 1e-5."""
    jb, tb, _ = batches
    jadj = jpool.batch_dense_adj(jb, M)
    adj = pooling.batch_dense_adj(tb, M)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jadj))
    assert int(adj.sum()) == int(tb.edge_mask.sum())
    jdense, jmask = jpool.to_dense_batch(jb.x, jb, M)
    dense, mask = pooling.to_dense_batch(tb.x, tb, M)
    s = np.random.default_rng(2).normal(size=(4, M, 3)).astype(np.float32)

    # x' and adj' weighted by fixed draws: their plain sums are constant
    # in the assignment (each node's row of S sums to 1)
    wx = np.random.default_rng(3).normal(size=(4, 3, F)).astype(np.float32)
    wa = np.random.default_rng(4).normal(size=(4, 3, 3)).astype(np.float32)

    def j_obj(logits):
        x2, a2, ll, le = jpool.dense_diff_pool(jdense, jadj, logits, jmask)
        return jnp.sum(x2 * wx) + jnp.sum(a2 * wa) + ll + le, (x2, a2, ll,
                                                               le)

    (_, jouts), jg = jax.value_and_grad(j_obj, has_aux=True)(jnp.asarray(s))
    logits = torch.tensor(s, requires_grad=True)
    outs = pooling.dense_diff_pool(dense, adj, logits, mask)
    for got, want in zip(outs, jouts):
        _close(got, want)
    ((outs[0] * torch.from_numpy(wx)).sum()
     + (outs[1] * torch.from_numpy(wa)).sum() + outs[2] + outs[3]).backward()
    _close(logits.grad, jg)


@pytest.mark.parametrize("seed", [0, 7])
def test_graclus_equals_jax(seed):
    """The same matching, id for id, for the same seed, with and without
    edge weights."""
    rng = np.random.default_rng(seed)
    n, ei = random_graph(rng, n=14, p=0.35)
    w = rng.uniform(0.1, 2.0, ei.shape[1])
    for weight in (None, w):
        got = pooling.graclus_cluster(ei, n, weight, seed=seed)
        want = jpool.graclus_cluster(ei, n, weight, seed=seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("how", ["avg", "max", "sum"])
def test_pool_by_cluster_equals_jax(batches, how):
    """Node rows pooled into graclus clusters (over the whole batch's
    edge list; padding nodes masked out)."""
    jb, tb, _ = batches
    ei = np.stack([tb.senders.numpy(), tb.receivers.numpy()])
    ei = ei[:, tb.edge_mask.numpy()]
    cl = pooling.graclus_cluster(ei, tb.num_nodes)
    C = int(cl.max()) + 1
    want = jpool.pool_by_cluster(jb.x, jnp.asarray(cl), C, mask=jb.node_mask,
                                 how=how)
    got = pooling.pool_by_cluster(tb.x, torch.from_numpy(cl), C,
                                  mask=tb.node_mask, how=how)
    _close(got, want, rtol=1e-6)


@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1)])
def test_masked_mean_equals_jax(axis):
    """`masked_mean` of (6, 4, 3) values under a (6, 4) mask (a mask
    entry counts once for its 3 features, as in JAX), and an all-false
    mask giving 0."""
    rng = np.random.default_rng(4)
    v = rng.normal(size=(6, 4, 3)).astype(np.float32)
    mk = rng.uniform(size=(6, 4)) < 0.6
    for mask in (mk, np.zeros_like(mk)):
        want = np.asarray(j_masked_mean(jnp.asarray(v), jnp.asarray(mask),
                                        axis=axis))
        got = masked_mean(torch.from_numpy(v), torch.from_numpy(mask),
                          axis=axis).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_torch_linear_inits_draw_jax_distributions():
    """`torch_linear_kernel_init` ((fan_in, out) kernels) and
    `torch_linear_bias_init(fan_in)` draw U(+-1/sqrt(fan_in)) like JAX's:
    within the bound, mean and variance of 20000 draws within 5 standard
    errors of U's, in the requested shape and dtype, reproducible from
    the generator's seed."""
    shape = (25, 800)
    bound = 1.0 / 5.0
    jk = np.asarray(jlayers.torch_linear_kernel_init(jax.random.key(0),
                                                     shape))
    jbias = np.asarray(jlayers.torch_linear_bias_init(25)(
        jax.random.key(1), (20000,)))
    k = layers.torch_linear_kernel_init(torch.Generator().manual_seed(0),
                                        shape)
    b = layers.torch_linear_bias_init(25)(torch.Generator().manual_seed(1),
                                          (20000,))
    var_u = bound ** 2 / 3.0
    n = 20000
    for got in (k.numpy().ravel(), b.numpy(), jk.ravel(), jbias):
        assert np.abs(got).max() <= bound
        assert abs(got.mean()) < 5 * math.sqrt(var_u / n)
        assert abs(got.var() - var_u) < 5 * bound ** 2 * math.sqrt(
            4.0 / 45.0 / n)
    assert k.shape == shape and k.dtype == torch.float32
    assert layers.torch_linear_kernel_init(
        torch.Generator(), (3, 2), torch.float64).dtype == torch.float64
    assert torch.equal(k, layers.torch_linear_kernel_init(
        torch.Generator().manual_seed(0), shape))
