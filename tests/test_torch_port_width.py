"""The port's width-layout ops and PPGN pooling against the JAX package,
on the CPU.

K3 (the row-gather z reduce) and K4 (the PPGN diag/row/col pool) take
their plain PyTorch versions here (CPU tensors). Those are held against
the JAX Pallas kernels (K3 in interpret mode, at the bf16 tolerance of
its matmul; K4 interprets itself on a CPU backend) and against JAX's
exact f32 math. Every JAX global switch is restored in `finally`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.counting import CountingDatasetConfig as JCountingConfig
from escgnn_tpu.data.counting import generate_counting_graphs as j_generate
from escgnn_tpu.data.counting import normalize_targets as j_normalize
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu.models.nested_gin_eff import NestedGINEff as JNestedGINEff
from escgnn_tpu.models.nested_gin_eff import NestedGINEffConfig as JConfig
from escgnn_tpu.ops import zemb as j_zemb, zemb_pallas
from escgnn_tpu.ops.ppgn_pool import diag_row_col_pool as j_pool
from escgnn_tpu.ops.ppgn_pool import diag_row_col_pool_xla as j_pool_xla
from escgnn_tpu.train.loop import l1_node_loss as j_l1_node
from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.data.counting import (
    CountingDatasetConfig,
    generate_counting_graphs,
    normalize_targets,
)
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff, NestedGINEffConfig
from escgnn_tpu_torch.ops import ppgn_pool, zemb, zemb_cuda, zemb_gather
from escgnn_tpu_torch.train.loop import l1_node_loss
from escgnn_tpu_torch.utils import trace
from escgnn_tpu_torch.weights import flax_to_state_dict, load_flax_variables

H = 16
ESC = dict(h=2, use_rd=True, self_loop=True)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _bf16_close(got, want):
    """The Pallas z kernel rounds its matmul operands to bf16: agreement
    is cosine > 0.999 and relative L2 error < 0.02 (the JAX package's own
    tolerance for it, tests/test_zemb_dedup.py)."""
    a, b = np.ravel(got).astype(np.float64), np.ravel(want).astype(np.float64)
    cos = a.dot(b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
    assert cos > 0.999, cos
    assert np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12) < 0.02


def _random_encoding(rng, E, P, Z):
    """(E, P) ids and counts shaped like the width layout: a real row
    holds a few nonzero counts (small integers), then zero padding; a
    quarter of the rows are all padding."""
    idx = rng.integers(0, Z, (E, P)).astype(np.int32)
    cnt = rng.integers(1, 6, (E, P)).astype(np.float32)
    nnz = rng.integers(0, P + 1, E)
    nnz[rng.random(E) < 0.25] = 0
    cnt[np.arange(P)[None, :] >= nnz[:, None]] = 0
    return idx, cnt


def _loop_reduce(table, idx, cnt):
    """The reduce as a plain loop (ids outside the table add nothing)."""
    out = np.zeros((idx.shape[0], table.shape[1]), np.float64)
    for e in range(idx.shape[0]):
        for p in range(idx.shape[1]):
            if 0 <= idx[e, p] < table.shape[0]:
                out[e] += cnt[e, p] * table[idx[e, p]]
    return out


@pytest.fixture(scope="module")
def counting():
    """A width (`from_graphs`) batch of 4 counting graphs from each
    package (E a multiple of 128, as the Pallas z kernel needs)."""
    cfg_j, cfg_t = JCountingConfig(num_graphs=10), CountingDatasetConfig(
        num_graphs=10)
    js, _, _ = j_normalize(j_generate(cfg_j), 0)
    ts, _, _ = normalize_targets(generate_counting_graphs(cfg_t), 0)
    jg = j_featurize_many(js["train"][:4], JEscConfig(**ESC))
    tg = featurize_many(ts["train"][:4], EscConfig(**ESC))
    # random node features in place of the dataset's constant ones: a
    # BatchNorm over identical rows has zero variance, and the gradient
    # through it is f32 noise in either package
    rng = np.random.default_rng(12)
    for a, b in zip(jg, tg):
        a.x = b.x = rng.normal(size=b.x.shape).astype(np.float32)
    jb = j_pad_and_batch(jg, JBatchSpec.from_graphs(jg, 4))
    tb = pad_and_batch(tg, BatchSpec.from_graphs(tg, 4), device="cpu")
    return jax.tree.map(jnp.asarray, jb), tb, jg


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """On CPU tensors no wrapper launches its kernel."""
    yield
    assert (trace.counter("k3.launches"), trace.counter("k4.launches"),
            trace.counter("k2.launches")) == (0, 0, 0)


@pytest.mark.parametrize("Z", [40, 1800])
def test_count_matrix_scatter_equals_broadcast_and_jax(Z):
    """The scatter-built count matrix is bit-equal to the broadcast
    compare it replaces and to JAX `_count_matrix`; an id >= Z and a
    negative id contribute nothing."""
    rng = np.random.default_rng(0)
    idx, cnt = _random_encoding(rng, 50, 12, Z)
    idx[3, 0], cnt[3, 0] = Z, 4.0
    idx[7, 1], cnt[7, 1] = Z + 9, 2.0
    idx[9, 2], cnt[9, 2] = -1, 3.0
    got = zemb_cuda.count_matrix(_t(idx), _t(cnt), Z).numpy()
    it, ct = _t(idx), _t(cnt)
    onehot = it[:, :, None] == torch.arange(Z, dtype=it.dtype)[None, None]
    old = torch.where(onehot, ct[:, :, None], torch.zeros(())).sum(1)
    np.testing.assert_array_equal(got, old.numpy())
    want = np.asarray(j_zemb._count_matrix(jnp.asarray(idx),
                                           jnp.asarray(cnt), Z))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.sum() == cnt.sum() - 9.0


def test_k3_plain_vs_pallas_interpret_and_gather(counting):
    """zemb_gather (plain version) on the counting batch against the TPU
    kernel in interpret mode (bf16 tolerance) and against the JAX f32
    `_gather_reduce` (rtol 1e-5: the same f32 products summed in another
    order)."""
    jb, tb, _ = counting
    rng = np.random.default_rng(1)
    table = rng.normal(size=(1800, H)).astype(np.float32)
    idx = tb.enc_idx.to(torch.int32)
    cnt = tb.enc_cnt.to(torch.float32)
    got = zemb_gather.zemb_gather(_t(table), idx, cnt).numpy()
    want_k = np.asarray(zemb_pallas.zemb_pallas(
        jnp.asarray(table), jb.enc_idx, jb.enc_cnt, interpret=True))
    _bf16_close(got, want_k)
    want = np.asarray(j_zemb._gather_reduce(
        jnp.asarray(table), jb.enc_idx.astype(jnp.int32),
        jb.enc_cnt.astype(jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_k3_plain_ragged_duplicates_and_out_of_range():
    """E not a multiple of 128, H not a multiple of 32, duplicate ids in
    a row and ids outside [0, Z), against a plain loop (rtol 1e-5)."""
    rng = np.random.default_rng(2)
    Z, E, P, W = 30, 77, 9, 45
    table = rng.normal(size=(Z, W)).astype(np.float32)
    idx, cnt = _random_encoding(rng, E, P, Z)
    idx[5, :4] = 11  # duplicates
    cnt[5, :4] = [1, 2, 3, 4]
    idx[6, 0], cnt[6, 0] = Z, 5.0
    idx[8, 1], cnt[8, 1] = -3, 2.0
    got = zemb_gather.zemb_gather(_t(table), _t(idx), _t(cnt)).numpy()
    np.testing.assert_allclose(got, _loop_reduce(table, idx, cnt),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_width_zemb_and_table_grad_match_jax(counting, impl):
    """zemb_from_batch on the width layout under impls "gather" and
    "pallas" (K3's plain version on the CPU), forward and table gradient,
    against JAX `_zemb_core` (impl "gather") with its backward matmul in
    f32: rtol/atol 1e-5 (forward) and 1e-4 (gradient: f32 sums over a
    few hundred rows in another order)."""
    jb, tb, _ = counting
    rng = np.random.default_rng(3)
    table = rng.normal(size=(1800, H)).astype(np.float32)
    co = rng.normal(size=(tb.num_edges, H)).astype(np.float32)
    j_zemb.set_impl("gather")
    j_zemb.set_backward_matmul_dtype(jnp.float32)
    try:
        want_z, vjp = jax.vjp(lambda t: j_zemb.zemb_from_batch(t, jb),
                              jnp.asarray(table))
        want_g = np.asarray(vjp(jnp.asarray(co))[0])
    finally:
        j_zemb.set_backward_matmul_dtype(jnp.bfloat16)
        j_zemb.set_impl("countmat")
    tt = _t(table, grad=True)
    zemb.set_impl(impl)
    try:
        z = zemb.zemb_from_batch(tt, tb)
    finally:
        zemb.set_impl("countmat")
    (z * _t(co)).sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(want_z),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), want_g, rtol=1e-4, atol=1e-4)


def test_width_countmat_default_matches_jax(counting):
    """The default impl on the width layout (C built by the scatter, then
    C @ table) against JAX's default `_countmat_reduce` and its autodiff
    gradient (rtol/atol 1e-5)."""
    jb, tb, _ = counting
    rng = np.random.default_rng(4)
    table = rng.normal(size=(1800, H)).astype(np.float32)
    co = rng.normal(size=(tb.num_edges, H)).astype(np.float32)
    want_z, vjp = jax.vjp(lambda t: j_zemb.zemb_from_batch(t, jb),
                          jnp.asarray(table))
    tt = _t(table, grad=True)
    z = zemb.zemb_from_batch(tt, tb)
    (z * _t(co)).sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(want_z),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(co))[0]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,N,C", [(4, 24, 32), (3, 7, 20)])
def test_k4_plain_matches_jax(dtype, G, N, C):
    """diag_row_col_pool (plain version) against the JAX Pallas kernel
    (interpreted on the CPU) and its jnp reference, f32 and bf16 inputs,
    G and N off any tiling: rtol 1e-6, atol 1e-5 (f32 sums of up to 48
    unit-normal terms, in another order)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(G, N, N, C)).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = _t(x).to(getattr(torch, dtype))
    got = ppgn_pool.diag_row_col_pool(xt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (G, N, 2 * C)
    for want in (j_pool(xj), j_pool_xla(xj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), ppgn_pool.diag_row_col_pool_plain(xt).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_gradient_matches_jax(dtype):
    """The pool's backward (the broadcast of `_pool_bwd`, in x's dtype)
    against jax.grad of the Pallas pool: rtol 1e-5, atol 1e-6 in f32;
    in bf16 both round the same f32 sums to bf16 (rtol 1e-2)."""
    rng = np.random.default_rng(6)
    G, N, C = 3, 7, 20
    x = rng.normal(size=(G, N, N, C)).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.sin(j_pool(a))))(xj)
                      .astype(jnp.float32))
    xt = _t(x).to(getattr(torch, dtype)).requires_grad_(True)
    torch.sin(ppgn_pool.diag_row_col_pool(xt)).sum().backward()
    assert xt.grad.dtype == xt.dtype
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(
        rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(xt.grad.float().numpy(), want, **tol)


def test_new_wrappers_refuse_other_devices():
    """No silent fallback: a tensor neither on the CPU nor on a CUDA card
    is refused by the K3 and K4 wrappers."""
    meta = torch.empty(4, 3, device="meta")
    ids = torch.zeros(4, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        zemb_gather.zemb_gather(meta, ids, meta)
    with pytest.raises(ValueError):
        ppgn_pool.diag_row_col_pool(torch.empty(2, 3, 3, 4, device="meta"))


@pytest.fixture(scope="module")
def jax_nested_width(counting):
    """The JAX counting NestedGINEff on the width batch (impl "gather",
    backward matmul in f32): variables, train-mode output, gradients."""
    jb, _, _ = counting
    jmodel = JNestedGINEff(JConfig(hidden=H, num_layers=2))
    j_zemb.set_impl("gather")
    j_zemb.set_backward_matmul_dtype(jnp.float32)
    try:
        variables = jax.jit(jmodel.init)(jax.random.key(0), jb)

        def loss_of(p):
            out, _ = jmodel.apply(
                {"params": p, "batch_stats": variables["batch_stats"]}, jb,
                deterministic=True, use_running_average=False,
                mutable=["batch_stats"])
            return j_l1_node(out, jb), out

        (_, out), grads = jax.jit(jax.value_and_grad(
            loss_of, has_aux=True))(variables["params"])
    finally:
        j_zemb.set_backward_matmul_dtype(jnp.bfloat16)
        j_zemb.set_impl("countmat")
    return (jax.tree.map(np.asarray, variables), np.asarray(out),
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_nested_gin_eff_width_layout_matches_jax(counting, jax_nested_width,
                                                 impl):
    """The counting NestedGINEff on the width layout under impls "gather"
    and "pallas" against JAX (impl "gather", backward matmul in f32):
    train-mode output (rtol/atol 1e-5) and every gradient (rtol 1e-4,
    atol 1e-5 of the largest gradient: f32 sums in another order)."""
    _, tb, _ = counting
    variables, want, grads = jax_nested_width
    model = NestedGINEff(NestedGINEffConfig(hidden=H, num_layers=2),
                         in_dim=tb.x.shape[1], device="cpu")
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    model.train()
    zemb.set_impl(impl)
    try:
        out = model(tb)
        l1_node_loss(out, tb).backward()
    finally:
        zemb.set_impl("countmat")
    np.testing.assert_allclose(out.detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)
    want_g = flax_to_state_dict(grads, {})
    gmax = max(np.abs(v.numpy()).max() for v in want_g.values())
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   rtol=1e-4, atol=1e-5 * gmax, err_msg=k)
