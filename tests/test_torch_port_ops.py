"""The port's ops against the JAX package on the CPU.

The kernel wrappers take their plain PyTorch versions here (CPU tensors);
those are held against the JAX Pallas kernels run in interpret mode (at
the bf16 tolerance those kernels' matmuls allow) and against JAX's exact
f32 math. Every JAX global switch is restored in `finally`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.molecules import synthetic_zinc as j_synthetic_zinc
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu.ops import expand_pallas, zemb as j_zemb, zemb_pallas
from escgnn_tpu.ops.embed import embed_take as j_embed_take
from escgnn_tpu.ops.segment import pool_nodes_to_graphs as j_pool
from escgnn_tpu.ops.segment import segment_sum as j_segment_sum
from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.data.molecules import synthetic_zinc
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.ops import expand_cuda, zemb, zemb_cuda
from escgnn_tpu_torch.ops.embed import embed_take
from escgnn_tpu_torch.ops.segment import pool_nodes_to_graphs, segment_sum
from escgnn_tpu_torch.utils import trace

H = 16


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _bf16_close(got, want):
    """The Pallas kernels round their matmul operands to bf16: agreement
    is cosine > 0.999 and relative L2 error < 0.02 (the JAX package's own
    tolerance for them, tests/test_zemb_dedup.py)."""
    a, b = np.ravel(got).astype(np.float64), np.ravel(want).astype(np.float64)
    cos = a.dot(b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
    assert cos > 0.999, cos
    assert np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12) < 0.02


@pytest.fixture(scope="module")
def batches():
    """One dedup batch of 6 synthetic ZINC molecules from each package
    (E and R multiples of 128, as the Pallas kernels need)."""
    jg = j_featurize_many(j_synthetic_zinc(6, seed=7), JEscConfig(h=3))
    tg = featurize_many(synthetic_zinc(6, seed=7), EscConfig(h=3))
    jb = j_pad_and_batch(jg, JBatchSpec.from_graphs(jg, 6, enc_layout="dedup"))
    tb = pad_and_batch(tg, BatchSpec.from_graphs(tg, 6, enc_layout="dedup"),
                       device="cpu")
    return jax.tree.map(jnp.asarray, jb), tb


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """On CPU tensors no wrapper launches its kernel."""
    def launches():
        return trace.counter("k1.launches"), trace.counter("k2.launches")

    k1, k2 = launches()
    yield
    assert launches() == (k1, k2) == (0, 0)


def test_k1_plain_vs_pallas_interpret_and_exact(batches):
    """sorted_segment_sum (plain version) against the TPU kernel in
    interpret mode (bf16 tolerance) and against the exact f32
    take-transpose (rtol 1e-6: the same f32 sums)."""
    jb, tb = batches
    rng = np.random.default_rng(0)
    R, E = tb.enc_idx.shape[0], tb.num_edges
    dZ = rng.normal(size=(E, H)).astype(np.float32)
    got = expand_cuda.sorted_segment_sum(
        _t(dZ), tb.enc_edge_perm, tb.enc_row_sorted, R).numpy()
    expand_pallas.set_interpret(True)
    try:
        want_k = np.asarray(expand_pallas.sorted_segment_sum_pallas(
            jnp.take(jnp.asarray(dZ), jb.enc_edge_perm, axis=0),
            jb.enc_row_sorted, R))
    finally:
        expand_pallas.set_interpret(False)
    _bf16_close(got, want_k)
    u0 = jnp.zeros((R, H), jnp.float32)
    want = np.asarray(jax.vjp(
        lambda u: jnp.take(u, jb.enc_edge_row, axis=0), u0)[1](
            jnp.asarray(dZ))[0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_k1_plain_ragged_rows_and_bf16():
    """Gaps, trailing empty rows and a bf16 gradient (summed in f32)."""
    rng = np.random.default_rng(1)
    rows = np.sort(rng.integers(0, 20, 200) * 2).astype(np.int32)
    perm = rng.permutation(200).astype(np.int32)
    dZ = rng.normal(size=(200, 5)).astype(np.float32)
    want = np.zeros((50, 5))
    np.add.at(want, rows, dZ[perm])
    got = expand_cuda.sorted_segment_sum(
        _t(dZ).bfloat16(), _t(perm), _t(rows), 50)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=5e-2)
    got32 = expand_cuda.sorted_segment_sum(_t(dZ), _t(perm), _t(rows), 50)
    np.testing.assert_allclose(got32.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not got32[40:].any() and not got32[1:40:2].any()


def test_expand_rows_grad_matches_jax(batches):
    """expand_rows forward (exact) and its K1 backward against jax.grad of
    the take (rtol 1e-6)."""
    jb, tb = batches
    rng = np.random.default_rng(2)
    R, E = tb.enc_idx.shape[0], tb.num_edges
    u = rng.normal(size=(R, H)).astype(np.float32)
    co = rng.normal(size=(E, H)).astype(np.float32)
    ut = _t(u, grad=True)
    z = zemb.expand_rows(ut, tb)
    (z * _t(co)).sum().backward()
    want_z = np.asarray(jnp.take(jnp.asarray(u), jb.enc_edge_row, axis=0))
    np.testing.assert_array_equal(z.detach().numpy(), want_z)
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(
        jnp.take(v, jb.enc_edge_row, axis=0) * co))(jnp.asarray(u)))
    np.testing.assert_allclose(ut.grad.numpy(), want_g, rtol=1e-6, atol=1e-6)


def test_k2_plain_vs_pallas_interpret_and_exact(batches):
    """zemb_countmat (plain version): C exactly equal to the TPU kernel's
    (interpret mode), z at its bf16 tolerance, and z against the JAX
    package's f32 `_countmat_reduce` at rtol 1e-5."""
    jb, tb = batches
    rng = np.random.default_rng(3)
    Zc = tb.enc_bucket_ids.shape[0]
    table = rng.normal(size=(Zc, H)).astype(np.float32)
    idx = tb.enc_idx.to(torch.int32)
    cnt = tb.enc_cnt.to(torch.float32)
    z, C = zemb_cuda.zemb_countmat(_t(table), idx, cnt)
    zj, Cj = zemb_pallas.zemb_countmat_pallas(
        jnp.asarray(table), jb.enc_idx, jb.enc_cnt, interpret=True)
    np.testing.assert_array_equal(C.numpy(), np.asarray(Cj))
    np.testing.assert_array_equal(C.numpy(), tb.enc_countmat.numpy())
    _bf16_close(z.numpy(), np.asarray(zj))
    want = np.asarray(j_zemb._countmat_reduce(
        jnp.asarray(table), jb.enc_idx.astype(jnp.int32),
        jb.enc_cnt.astype(jnp.float32)))
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-5, atol=1e-5)


def test_k2_table_grad_matches_jax(batches):
    """The table gradient of the K2 path (dT = C^T @ dU) against jax.grad
    under set_impl("countmat_pallas") with the JAX backward matmul in
    f32 (rtol/atol 1e-4: the same f32 products, summed over a few hundred
    rows in another order)."""
    jb, tb = batches
    rng = np.random.default_rng(4)
    Zc, R = tb.enc_bucket_ids.shape[0], tb.enc_idx.shape[0]
    table = rng.normal(size=(Zc, H)).astype(np.float32)
    co = rng.normal(size=(R, H)).astype(np.float32)

    def jloss(t):
        return jnp.sum(j_zemb.zemb_weighted_gather(
            t, jb.enc_idx, jb.enc_cnt) * co)

    j_zemb.set_impl("countmat_pallas")
    j_zemb.set_backward_matmul_dtype(jnp.float32)
    zemb_pallas.set_interpret(True)
    try:
        want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    finally:
        zemb_pallas.set_interpret(False)
        j_zemb.set_backward_matmul_dtype(jnp.bfloat16)
        j_zemb.set_impl("countmat")
    tt = _t(table, grad=True)
    zemb.set_impl("countmat_pallas")
    try:
        out = zemb.zemb_weighted_gather(tt, tb.enc_idx, tb.enc_cnt)
    finally:
        zemb.set_impl("countmat")
    (out * _t(co)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["countmat", "countmat_pallas"])
@pytest.mark.parametrize("host_countmat", [True, False])
def test_zemb_from_batch_matches_jax(batches, impl, host_countmat):
    """zemb_from_batch (bucket compaction, host C or the C build, then
    the expansion) and its table gradient against the JAX default path
    (rtol 1e-5)."""
    jb, tb = batches
    if not host_countmat:
        jb = jb.replace(enc_countmat=None)
        tb = dataclasses.replace(tb, enc_countmat=None)
    rng = np.random.default_rng(5)
    table = rng.normal(size=(1800, H)).astype(np.float32)
    co = rng.normal(size=(tb.num_edges, H)).astype(np.float32)
    want_z, vjp = jax.vjp(lambda t: j_zemb.zemb_from_batch(t, jb),
                          jnp.asarray(table))
    want_g = np.asarray(vjp(jnp.asarray(co))[0])
    tt = _t(table, grad=True)
    zemb.set_impl(impl)
    try:
        z = zemb.zemb_from_batch(tt, tb)
    finally:
        zemb.set_impl("countmat")
    (z * _t(co)).sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(want_z),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), want_g, rtol=1e-5, atol=1e-5)


def test_segment_sum_forward_and_grad():
    """Masked segment_sum, forward and gradient (rtol 1e-6)."""
    rng = np.random.default_rng(6)
    v = rng.normal(size=(40, 3)).astype(np.float32)
    ids = np.sort(rng.integers(0, 9, 40)).astype(np.int32)
    mask = rng.random(40) > 0.3
    co = rng.normal(size=(9, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: j_segment_sum(
        a, jnp.asarray(ids), 9, mask=jnp.asarray(mask)), jnp.asarray(v))
    vt = _t(v, grad=True)
    got = segment_sum(vt, _t(ids), 9, _t(mask))
    (got * _t(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(co))[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_pool_nodes_to_graphs(batches, uniform, reduce):
    """pool_nodes_to_graphs on the uniform layout (reshape) and the
    segment layout, forward and gradient (rtol 1e-6)."""
    jb, tb = batches
    if uniform:
        jg = j_featurize_many(j_synthetic_zinc(4, seed=8), JEscConfig(h=2))
        tg = featurize_many(synthetic_zinc(4, seed=8), EscConfig(h=2))
        jb = jax.tree.map(jnp.asarray, j_pad_and_batch(
            jg, JBatchSpec.uniform(jg, 4, enc_layout="dedup")))
        tb = pad_and_batch(tg, BatchSpec.uniform(tg, 4, enc_layout="dedup"),
                           device="cpu")
    rng = np.random.default_rng(9)
    v = rng.normal(size=(tb.num_nodes, 3)).astype(np.float32)
    co = rng.normal(size=(tb.num_graphs, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: j_pool(a, jb, reduce), jnp.asarray(v))
    vt = _t(v, grad=True)
    got = pool_nodes_to_graphs(vt, tb, reduce)
    (got * _t(co)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(co))[0]),
                               rtol=1e-6, atol=1e-6)


def test_embed_take_forward_and_grad():
    """F.embedding against the one-hot-VJP embed_take: equal forward,
    gradient at rtol 1e-6."""
    rng = np.random.default_rng(10)
    table = rng.normal(size=(12, 4)).astype(np.float32)
    ids = rng.integers(0, 12, (7, 3)).astype(np.int32)
    co = rng.normal(size=(7, 3, 4)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: j_embed_take(t, jnp.asarray(ids)),
                        jnp.asarray(table))
    tt = _t(table, grad=True)
    got = embed_take(tt, _t(ids))
    (got * _t(co)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(tt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(co))[0]),
                               rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA card is refused, and so is an unknown z impl."""
    meta = torch.empty(4, 2, device="meta")
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        expand_cuda.sorted_segment_sum(meta, ids, ids, 3)
    with pytest.raises(ValueError):
        zemb_cuda.zemb_countmat(meta, ids.reshape(2, 2), meta[:2, :2])
    with pytest.raises(NotImplementedError):
        zemb.set_impl("flat")
    assert zemb._IMPL == "countmat"
