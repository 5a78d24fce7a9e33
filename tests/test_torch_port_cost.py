"""The port's cost accounting (`escgnn_tpu_torch/utils/cost.py`) against
XLA's on the CPU:

  * one op at a time, on the same numpy inputs at (64, 32) f32: the
    port's `CostMode` against `jax.jit(f).lower(...).compile()
    .cost_analysis()` of the JAX expression the op's rule names. FLOPs
    and transcendentals are equal exactly; `bytes accessed` too for the
    ops that are one kernel on both sides. For reductions, gathers,
    scatters, composites and fills the bytes are the port's stated rule
    (operands read once, outputs written once; a gather's rows, not its
    table; a scatter's destination read and written), XLA's figure in a
    comment: XLA's CPU program fuses and splits them otherwise;
  * the hand kernels (K1-K4): each wrapper records one charge and no
    inner op, its FLOPs equal to `CostMode`'s count of its plain version
    called bare, its bytes the kernel's boundary; at the flagship and
    PPGN_eff shapes K1's, K2's and K4's bytes come to PERF.md's 16.5, 7.3
    and 22.0 MB;
  * whole steps, each of the ten bench lines at BENCH_SMOKE
    (`test_torch_port_bench.py` `jax_lines`, `port_line`): the port's
    FLOPs over `bench.py`'s `step_cost` FLOPs lie in [0.66, 1.02] (a
    band no wider than [0.8, 1.25]: 1.02 / 0.66 < 1.25 / 0.8). The
    measured ratios run from 0.684 (GPS ZINC) to 0.995 (k123): where
    JAX's step is lower, it does work the port's does not (the GPS
    lines' z-table gradient is `embed_take`'s one-hot matmul, 2 N V D
    FLOPs per table, where the port's is a scatter of N D). The bytes of
    the forward and backward (`jax.value_and_grad` of the step's loss,
    `hbm.py`'s boundary bytes) over the port's lie in [0.5, 2.0]: the
    measured ratios run 0.97 (k123) to 1.56 (OGB), the port charging
    every op as its own kernel. The optimizer is left out of the bytes:
    XLA on the CPU concatenates Adam's update into one flat vector that
    `hbm.py` charges in full to each parameter's slice fusion (OGB's
    whole-step JAX bytes 3.71e9 against 4.44e8 for its forward and
    backward). The PPGN_eff line's JAX figure leaves out the (E, P, Z)
    f32 select XLA on the CPU writes and reads back for the count matrix
    (`escgnn_tpu/ops/zemb.py:65-79`, on the TPU one loop fusion that
    writes only (R, Z));
  * an op without a rule raises, and the card's optimizer path (Adam
    capturable and foreach) has a rule for every op it dispatches.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

import bench as B
from escgnn_tpu.train.loop import TrainState, make_train_step
from escgnn_tpu.train.loop import adam_with_plateau as j_adam
from escgnn_tpu.utils.hbm import compiled_boundary_bytes
from escgnn_tpu_torch import bench as T
from escgnn_tpu_torch.data.prefetch import stack_batches
from escgnn_tpu_torch.models.layers import set_use_running_average
from escgnn_tpu_torch.ops import expand_cuda, ppgn_pool, zemb_cuda, zemb_gather
from escgnn_tpu_torch.train.loop import adam_with_plateau, train_step
from escgnn_tpu_torch.utils import cost
from tests.test_torch_port_bench import jax_lines, port_line
from tests.test_torch_port_zoo import _FAST_COMPILE

aten = torch.ops.aten


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def xla_cost(f, *args) -> tuple:
    """(flops, transcendentals, bytes accessed) of `f` jitted on the CPU."""
    ca = jax.jit(f).lower(*args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return (int(ca.get("flops", 0)), int(ca.get("transcendentals", 0)),
            int(ca.get("bytes accessed", 0)))


def port_cost(f, *args) -> cost.StepCost:
    with cost.CostMode() as mode:
        f(*args)
    return mode.total()


# ---------------------------------------------------------------------------
# one op at a time
# ---------------------------------------------------------------------------


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = np.float32
    a = rng.normal(size=(64, 32)).astype(f32)
    return dict(
        a=a, b=rng.normal(size=(64, 32)).astype(f32),
        g=rng.normal(size=(64, 32)).astype(f32),
        pos=(np.abs(a) + 0.5).astype(f32),
        w=rng.normal(size=(32, 16)).astype(f32),
        bias=rng.normal(size=(32,)).astype(f32),
        bias16=rng.normal(size=(16,)).astype(f32),
        a3=rng.normal(size=(4, 16, 32)).astype(f32),
        b3=rng.normal(size=(4, 32, 16)).astype(f32),
        idx=rng.integers(0, 64, size=(100,)).astype(np.int32),
        idx2=rng.integers(0, 64, size=(64, 32)).astype(np.int32),
        img=rng.normal(size=(1, 4, 16, 16)).astype(f32),
        kernel=rng.normal(size=(8, 4, 3, 3)).astype(f32),
        bias8=rng.normal(size=(8,)).astype(f32),
        src=rng.normal(size=(100, 32)).astype(f32),
        mean=a.mean(-1, keepdims=True),
        rstd=(1 / np.sqrt(a.var(-1, keepdims=True) + 1e-5)).astype(f32),
        bmean=a.mean(0), brstd=(1 / np.sqrt(a.var(0) + 1e-5)).astype(f32),
    )


_IN = _inputs()
_S2 = float(np.sqrt(0.5))
_SCATTER = lax.ScatterDimensionNumbers(
    update_window_dims=(1,), inserted_window_dims=(0,),
    scatter_dims_to_operand_dims=(0,))


def _torch_in(name):
    v = _IN[name]
    return torch.from_numpy(v.astype(np.int64) if name.startswith("idx")
                            else v)


# (id, torch op, JAX expression, inputs, bytes): bytes "xla" means equal
# to XLA's bytes accessed, an int the port's rule for that op, None a
# sequence of several kernels (FLOPs only)
OPS = [
    # matrix products
    ("mm", lambda a, w: torch.mm(a, w), lambda a, w: a @ w, "a w", "xla"),
    # one kernel here; XLA's dot and bias add are two (22592 bytes)
    ("addmm", lambda a, w, c: torch.addmm(c, a, w),
     lambda a, w, c: a @ w + c, "a w bias16", 8192 + 2048 + 64 + 4096),
    ("bmm", torch.bmm, lambda x, y: jnp.einsum("bij,bjk->bik", x, y),
     "a3 b3", "xla"),
    ("baddbmm", lambda x, y, c: torch.baddbmm(c, x, y),
     lambda x, y, c: jnp.einsum("bij,bjk->bik", x, y) + c, "a3 b3 bias16",
     None),
    # F.linear reaches the mode as t and addmm
    ("linear", lambda a, w, c: F.linear(a, w.t(), c),
     lambda a, w, c: a @ w + c, "a w bias16", 8192 + 2048 + 64 + 4096),
    # the input, weight and bias read, the output written (XLA's CPU
    # convolution: 34592)
    ("convolution", F.conv2d,
     lambda x, k, c: lax.conv_general_dilated(x, k, (1, 1), "VALID")
     + c[None, :, None, None], "img kernel bias8",
     4096 + 1152 + 32 + 6272),
    # elementwise
    ("add", torch.add, jnp.add, "a b", "xla"),
    ("bias_add", torch.add, jnp.add, "a bias", "xla"),
    ("sub", torch.sub, jnp.subtract, "a b", "xla"),
    ("mul", torch.mul, jnp.multiply, "a b", "xla"),
    ("div", torch.div, jnp.divide, "a b", "xla"),
    ("neg", torch.neg, jnp.negative, "a", "xla"),
    ("abs", torch.abs, jnp.abs, "a", "xla"),
    ("sgn", torch.sgn, jnp.sign, "a", "xla"),
    ("reciprocal", torch.reciprocal, lambda a: 1 / a, "a", "xla"),
    ("remainder", lambda a: torch.remainder(a, 3.0),
     lambda a: jnp.remainder(a, 3.0), "a", "xla"),
    ("isnan", torch.isnan, jnp.isnan, "a", None),
    ("eq", torch.eq, jnp.equal, "a b", "xla"),
    ("not", lambda a: ~(a > 0), lambda a: ~(a > 0), "a", None),
    ("log1p", torch.log1p, jnp.log1p, "pos", "xla"),
    ("sigmoid_backward", lambda g, y: aten.sigmoid_backward(g, y),
     lambda g, y: g * y * (1 - y), "g a", "xla"),
    ("cat", lambda a, b: torch.cat([a, b], -1),
     lambda a, b: jnp.concatenate([a, b], -1), "a b", "xla"),
    ("relu", torch.relu, lambda a: jnp.maximum(a, 0), "a", "xla"),
    ("maximum", torch.maximum, jnp.maximum, "a b", "xla"),
    ("clamp", lambda a: torch.clamp(a, -1, 1), lambda a: jnp.clip(a, -1, 1),
     "a", "xla"),
    ("gt", torch.gt, jnp.greater, "a b", "xla"),
    ("where", lambda a: torch.where(a > 0, a, 0.0),
     lambda a: jnp.where(a > 0, a, 0), "a", None),
    ("threshold_backward", lambda g, a: aten.threshold_backward(g, a, 0),
     lambda g, a: jnp.where(a > 0, g, 0), "g a", "xla"),
    ("convert", lambda a: a.to(torch.bfloat16),
     lambda a: a.astype(jnp.bfloat16), "a", "xla"),
    ("lerp", lambda a, b: torch.lerp(a, b, 0.1),
     lambda a, b: a + 0.1 * (b - a), "a b", "xla"),
    ("addcmul", lambda a, g, b: torch.addcmul(a, g, b, value=0.5),
     lambda a, g, b: a + 0.5 * g * b, "a g b", "xla"),
    ("addcdiv", lambda a, g, p: torch.addcdiv(a, g, p, value=0.5),
     lambda a, g, p: a + 0.5 * g / p, "a g pos", "xla"),
    # transcendental
    ("exp", torch.exp, jnp.exp, "a", "xla"),
    ("log", torch.log, jnp.log, "pos", "xla"),
    ("tanh", torch.tanh, jnp.tanh, "a", "xla"),
    ("sqrt", torch.sqrt, jnp.sqrt, "pos", "xla"),
    ("rsqrt", torch.rsqrt, lax.rsqrt, "pos", "xla"),
    ("erf", torch.erf, lax.erf, "a", "xla"),
    ("sigmoid", torch.sigmoid, jax.nn.sigmoid, "a", "xla"),
    ("pow_1.7", lambda p: p ** 1.7, lambda p: p ** 1.7, "pos", "xla"),
    ("pow_0.5", lambda p: p ** 0.5, lambda p: p ** 0.5, "pos", "xla"),
    ("pow_2", lambda a: a ** 2, lambda a: a ** 2, "a", "xla"),
    ("pow_3", lambda a: a ** 3, lambda a: a ** 3, "a", "xla"),
    ("pow_-1", lambda p: p ** -1, lambda p: p ** -1, "pos", "xla"),
    ("pow_-2", lambda p: p ** -2, lambda p: p ** -2, "pos", "xla"),
    # reductions: the input read, the output written (XLA's CPU figures:
    # sum over rows 8840, over columns 8452, all 8220, amax 8452, mean
    # 8836, var 34188, argmax 8448, the bf16 sum 21128, norm 24600)
    ("sum_rows", lambda a: a.sum(0), lambda a: a.sum(0), "a", 8192 + 128),
    ("sum_cols", lambda a: a.sum(1), lambda a: a.sum(1), "a", 8192 + 256),
    ("sum_all", torch.sum, jnp.sum, "a", 8192 + 4),
    ("amax", lambda a: torch.amax(a, 1), lambda a: a.max(1), "a",
     8192 + 256),
    ("mean", lambda a: a.mean(0), lambda a: a.mean(0), "a", 8192 + 128),
    ("var", lambda a: a.var(0), lambda a: a.var(0, ddof=1), "a",
     8192 + 128),
    ("argmax", lambda a: a.argmax(0), lambda a: a.argmax(0), "a",
     8192 + 32 * 8),
    ("max_all", torch.max, jnp.max, "a", 8192 + 4),
    ("sum_bf16_to_f32",
     lambda a: a.to(torch.bfloat16).sum(0, dtype=torch.float32),
     lambda a: jnp.sum(a.astype(jnp.bfloat16), 0, dtype=jnp.float32), "a",
     None),
    ("norm", lambda a: torch.linalg.vector_norm(a), jnp.linalg.norm, "a",
     8192 + 4),
    # composite ops, each one kernel here (its operands and outputs)
    ("softmax", lambda a: torch.softmax(a, -1),
     lambda a: jax.nn.softmax(a, -1), "a", 2 * 8192),
    ("log_softmax", lambda a: torch.log_softmax(a, -1),
     lambda a: jax.nn.log_softmax(a, -1), "a", 2 * 8192),
    ("softmax_backward",
     lambda g, y: aten._softmax_backward_data(g, y, -1, torch.float32),
     lambda g, y: y * (g - jnp.sum(g * y, -1, keepdims=True)), "g a",
     3 * 8192),
    ("log_softmax_backward",
     lambda g, o: aten._log_softmax_backward_data(g, o, -1, torch.float32),
     lambda g, o: g - jnp.exp(o) * jnp.sum(g, -1, keepdims=True), "g a",
     3 * 8192),
    ("elu", F.elu, jax.nn.elu, "a", 2 * 8192),
    ("elu_alpha", lambda a: F.elu(a, 0.5), lambda a: jax.nn.elu(a, 0.5),
     "a", 2 * 8192),
    ("elu_backward",
     lambda g, a: aten.elu_backward(g, 1.0, 1, 1, False, a),
     lambda g, a: jnp.where(a > 0, g, g * jnp.exp(a)), "g a", 3 * 8192),
    ("elu_backward_result",
     lambda g, y: aten.elu_backward(g, 1.0, 1, 1, True, y),
     lambda g, y: jnp.where(y > 0, g, g * (y + 1.0)), "g a", 3 * 8192),
    ("silu", F.silu, jax.nn.silu, "a", 2 * 8192),
    ("silu_backward", lambda g, a: aten.silu_backward(g, a),
     lambda g, a: g * jax.nn.sigmoid(a) * (
         1 + a * (1 - jax.nn.sigmoid(a))), "g a", 3 * 8192),
    ("gelu", F.gelu, lambda a: a * 0.5 * (1 + lax.erf(a * _S2)), "a",
     2 * 8192),
    ("gelu_tanh", lambda a: F.gelu(a, approximate="tanh"),
     lambda a: jax.nn.gelu(a, approximate=True), "a", 2 * 8192),
    ("gelu_backward", lambda g, a: aten.gelu_backward(g, a),
     lambda g, a: g * (0.5 * (1 + lax.erf(a * _S2)) + a * jnp.exp(
         -0.5 * a * a) * (1 / np.sqrt(2 * np.pi))), "g a", 3 * 8192),
    ("gelu_backward_tanh",
     lambda g, a: aten.gelu_backward(g, a, approximate="tanh"),
     lambda g, a: jax.vjp(lambda x: jax.nn.gelu(x, approximate=True),
                          a)[1](g)[0], "g a", 3 * 8192),
    ("layer_norm",
     lambda a, w, b: aten.native_layer_norm(a, [32], w, b, 1e-5),
     lambda a, w, b: _layer_norm(a, w, b), "a bias bias",
     8192 + 2 * 128 + 8192 + 2 * 256),
    ("layer_norm_backward",
     lambda g, a, m, r, w: aten.native_layer_norm_backward(
         g, a, [32], m, r, w, w, [True, True, True]),
     lambda g, a, m, r, w: _layer_norm_backward(g, a, m, r, w),
     "g a mean rstd bias", 2 * 8192 + 2 * 256 + 2 * 128 + 8192 + 2 * 128),
    ("batch_norm",
     lambda a, w, b: aten.native_batch_norm(a, w, b, None, None, True,
                                            0.1, 1e-5),
     lambda a, w, b: _batch_norm(a, w, b), "a bias bias",
     8192 + 2 * 128 + 8192 + 2 * 128),
    ("batch_norm_running_stats",
     lambda a, w, b: aten.native_batch_norm(a, w, b, w.abs(), b.abs(),
                                            True, 0.1, 1e-5),
     lambda a, w, b: _batch_norm_running(a, w, b), "a bias bias", None),
    ("batch_norm_eval",
     lambda a, w, b: aten.native_batch_norm(a, w, b, w, b.abs(), False,
                                            0.1, 1e-5),
     lambda a, w, b: (a - w) * lax.rsqrt(jnp.abs(b) + 1e-5) * w + b,
     "a bias bias", None),
    ("layer_norm_no_affine",
     lambda a: aten.native_layer_norm(a, [32], None, None, 1e-5),
     lambda a: _layer_norm(a, None, None), "a", None),
    ("batch_norm_backward",
     lambda g, a, m, r, w: aten.native_batch_norm_backward(
         g, a, w, None, None, m, r, True, 1e-5, [True, True, True]),
     lambda g, a, m, r, w: _batch_norm_backward(g, a, m, r, w),
     "g a bmean brstd bias", 2 * 8192 + 3 * 128 + 8192 + 2 * 128),
    # gathers: the indices, the rows read and the output written (XLA's
    # 21392 reads the whole table and int32 ids)
    ("index_select", lambda a, i: a.index_select(0, i),
     lambda a, i: jnp.take(a, i, axis=0, mode="clip"), "a idx",
     800 + 2 * 12800),
    ("embedding", lambda a, i: F.embedding(i, a),
     lambda a, i: jnp.take(a, i, axis=0, mode="clip"), "a idx",
     800 + 2 * 12800),
    ("index", lambda a, i: a[i],
     lambda a, i: jnp.take(a, i, axis=0, mode="clip"), "a idx",
     800 + 2 * 12800),
    # XLA's 2-D gather: 24576
    ("gather", lambda a, i: torch.gather(a, 0, i), lambda a, i: _gather(a, i),
     "a idx2", 16384 + 2 * 8192),
    # scatters: the indices and source read, the destination read and
    # written (XLA's lax.scatter_add: 45968)
    ("index_add", lambda a, i, s: a.index_add(0, i, s),
     lambda a, i, s: lax.scatter_add(
         a, i[:, None], s, _SCATTER,
         mode=lax.GatherScatterMode.PROMISE_IN_BOUNDS),
     "a idx src", 800 + 12800 + 2 * 8192),
    ("scatter_add",
     lambda a, i, s: a.scatter_add(0, i[:, None].expand(100, 32), s),
     lambda a, i, s: lax.scatter_add(
         a, i[:, None], s, _SCATTER,
         mode=lax.GatherScatterMode.PROMISE_IN_BOUNDS),
     "a idx src", 800 + 12800 + 2 * 8192),
    ("scatter_reduce_sum",
     lambda a, i, s: a.scatter_reduce(0, i[:, None].expand(100, 32), s,
                                      "sum"),
     lambda a, i, s: lax.scatter_add(
         a, i[:, None], s, _SCATTER,
         mode=lax.GatherScatterMode.PROMISE_IN_BOUNDS),
     "a idx src", 800 + 12800 + 2 * 8192),
    ("embedding_dense_backward",
     lambda s, i: aten.embedding_dense_backward(s, i, 64, -1, False),
     lambda s, i: jax.ops.segment_sum(s, i, 64), "src idx",
     800 + 12800 + 2 * 8192),
    # sorts: the keys read, the values and int64 indices written (XLA's
    # CPU sort 16384, writing no indices; its argsort of the 100 int32
    # ids, sorting them beside an iota, 2000)
    ("sort", lambda a: torch.sort(a, 0), lambda a: jnp.sort(a, 0), "a",
     8192 + 8192 + 16384),
    ("argsort_stable", lambda i: torch.sort(i, stable=True),
     lambda i: jnp.argsort(i, stable=True), "idx", 3 * 800),
    # views are free; a copy reads and writes (XLA's transpose: 16384)
    ("views", lambda a: (a.t(), a.view(32, 64), a.permute(1, 0),
                         a[:, :16], a.expand(2, 64, 32), a.unsqueeze(0),
                         a.detach()),
     lambda a: (a.T, a.reshape(32, 64)), "a", None),
    ("transpose_copy", lambda a: a.t().contiguous(), jnp.transpose, "a",
     "xla"),
    # fills write their output (XLA: 8196, the output and its constant)
    ("zeros", lambda a: torch.zeros(64, 32), lambda a: jnp.zeros((64, 32)),
     "a", 8192),
]


def _layer_norm(x, w, b):
    """`native_layer_norm`'s decomposition; w or b None: not applied."""
    m = x.mean(-1, keepdims=True)
    xc = x - m
    rstd = lax.rsqrt((xc * xc).mean(-1, keepdims=True) + 1e-5)
    y = xc * rstd
    y = y if w is None else y * w
    return (y if b is None else y + b), m, rstd


def _layer_norm_backward(g, x, m, rstd, w):
    xhat = (x - m) * rstd
    gx = g * w
    n = x.shape[-1]
    dx = rstd / n * (n * gx - gx.sum(-1, keepdims=True)
                     - xhat * (gx * xhat).sum(-1, keepdims=True))
    return dx, (g * xhat).sum(0), g.sum(0)


def _batch_norm(x, w, b):
    m = x.mean(0)
    xc = x - m
    rstd = lax.rsqrt((xc * xc).mean(0) + 1e-5)
    return xc * rstd * w + b, m, rstd


def _batch_norm_running(x, w, b):
    """`_batch_norm` and the running statistics' update at momentum 0.1,
    the variance's unbiased factor folded into one constant."""
    y, m, rstd = _batch_norm(x, w, b)
    n = x.shape[0]
    var = ((x - m) ** 2).mean(0)
    return (y, m, rstd, 0.9 * jnp.abs(w) + 0.1 * m,
            0.9 * jnp.abs(b) + 0.1 * (var * (n / (n - 1))))


_GATHER = lax.GatherDimensionNumbers(
    offset_dims=(), collapsed_slice_dims=(0, 1), start_index_map=(0, 1))


def _gather(a, rows):
    """a[rows[i, j], j]: the gather torch.gather(a, 0, rows) makes."""
    cols = jnp.broadcast_to(jnp.arange(a.shape[1], dtype=rows.dtype),
                            rows.shape)
    return lax.gather(a, jnp.stack([rows, cols], -1), _GATHER, (1, 1),
                      mode=lax.GatherScatterMode.PROMISE_IN_BOUNDS)


def _batch_norm_backward(g, x, m, rstd, w):
    xhat = (x - m) * rstd
    n = x.shape[0]
    gb = g.sum(0)
    gw = (g * xhat).sum(0)
    return w * rstd / n * (n * g - gb - xhat * gw), gw, gb


@pytest.mark.parametrize("case", OPS, ids=[c[0] for c in OPS])
def test_single_op_equals_xla(case):
    """FLOPs and transcendentals equal XLA's exactly; bytes equal XLA's
    for one-kernel ops, else the port's stated rule."""
    _, torch_fn, jax_fn, names, nbytes = case
    names = names.split()
    got = port_cost(torch_fn, *[_torch_in(n) for n in names])
    want = xla_cost(jax_fn, *[jnp.asarray(_IN[n]) for n in names])
    assert (got.flops, got.transcendentals) == want[:2], (got, want)
    if nbytes == "xla":
        assert got.bytes == want[2], (got.bytes, want[2])
    elif nbytes is not None:
        assert got.bytes == nbytes, (got.bytes, nbytes)
    if case[0] == "views":
        assert got.by_op == {} and got.bytes == 0


def test_convolution_backward_is_two_convolutions():
    """The input and weight gradients each cost the forward's multiply-adds
    and the bias gradient its sum (XLA's CPU count of `jax.vjp` of the
    convolution is 2.3e5 more: its transposed convolution multiplies the
    zero padding too)."""
    x, k = _torch_in("img"), _torch_in("kernel")
    g = torch.ones(1, 8, 14, 14)
    got = port_cost(lambda: aten.convolution_backward(
        g, x, k, [8], [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
        [True, True, True]))
    forward = 2 * 1568 * 36
    assert got.flops == 2 * forward + 1568 - 8
    assert got.bytes == (6272 + 4096 + 1152) + (4096 + 1152 + 32)


@pytest.mark.parametrize("op", ["add", "lerp_", "addcdiv_", "sqrt", "norm"])
def test_foreach_charges_each_tensor_by_its_op(op):
    """A _foreach_ op costs what its single-tensor op costs on each tensor
    of the list (the optimizer's path on the card)."""
    a, b, g, p = (_torch_in(n) for n in ("a", "b", "g", "pos"))
    calls = {
        "add": (lambda: torch._foreach_add([a, b], [g, a]),
                lambda: (torch.add(a, g), torch.add(b, a))),
        "lerp_": (lambda: torch._foreach_lerp_([a.clone(), b.clone()],
                                               [g, g], 0.1),
                  lambda: (a.clone().lerp_(g, 0.1), b.clone().lerp_(g, 0.1))),
        "addcdiv_": (lambda: torch._foreach_addcdiv_(
            [a.clone(), b.clone()], [g, g], [p, p], 0.5),
            lambda: (a.clone().addcdiv_(g, p, value=0.5),
                     b.clone().addcdiv_(g, p, value=0.5))),
        "sqrt": (lambda: torch._foreach_sqrt([p, p]),
                 lambda: (torch.sqrt(p), torch.sqrt(p))),
        "norm": (lambda: torch._foreach_norm([a, b]),
                 lambda: (torch.linalg.vector_norm(a),
                          torch.linalg.vector_norm(b))),
    }[op]
    got, want = port_cost(calls[0]), port_cost(calls[1])
    assert (got.flops, got.transcendentals, got.bytes) == (
        want.flops, want.transcendentals, want.bytes)
    assert got.flops + got.transcendentals > 0
    assert any(k.startswith("aten._foreach_") for k in got.by_op)


def test_unknown_op_raises_before_it_runs():
    a = _torch_in("a")
    with pytest.raises(NotImplementedError, match="cumsum"):
        with cost.CostMode():
            torch.cumsum(a, 0)
    out = torch.zeros(64, 32)
    with pytest.raises(NotImplementedError, match="cumsum"):
        with cost.CostMode():
            torch.cumsum(a, 0, out=out)
    assert not out.any()
    with pytest.raises(NotImplementedError, match="rounding mode"):
        with cost.CostMode():
            torch.div(a, 3.0, rounding_mode="floor")


def test_charge_without_a_mode_is_a_no_op():
    cost.charge("nothing", 1, 2, 3)
    with cost.kernel_scope():
        torch.add(_torch_in("a"), 1)
    with cost.CostMode() as mode:
        with cost.kernel_scope():
            torch.add(_torch_in("a"), 1)
        cost.charge("k", 5, 6, 7)
    assert {k: (v.calls, v.flops, v.transcendentals, v.bytes)
            for k, v in mode.by_op.items()} == {"k": (1, 5, 6, 7)}


def test_footprint_counts_a_broadcast_once():
    t = torch.zeros(32)
    assert cost.footprint(t.expand(64, 32)) == 32
    assert cost.footprint(torch.zeros(64, 40)[:, :32]) == 64 * 32
    assert cost.nbytes(torch.zeros(64, 32, dtype=torch.bfloat16)) == 4096


# ---------------------------------------------------------------------------
# the hand kernels
# ---------------------------------------------------------------------------


def _k1_inputs(dtype, strided, E=50, R=12, H=16):
    gen = torch.Generator().manual_seed(1)
    wide = torch.randn(E, H + 8, generator=gen).to(dtype)
    dZ = wide[:, :H] if strided else wide[:, :H].contiguous()
    perm = torch.randperm(E, generator=gen).to(torch.int32)
    rows = torch.sort(torch.randint(0, R, (E,), generator=gen)).values.to(
        torch.int32)
    return (dZ, perm, rows, R), E * H * dZ.element_size() + 8 * E + R * H * 4


def _zemb_inputs(R=12, P=7, Z=20, H=16):
    gen = torch.Generator().manual_seed(2)
    table = torch.randn(Z, H, generator=gen)
    idx = torch.randint(-1, Z + 1, (R, P), generator=gen).to(torch.int32)
    cnt = torch.randint(0, 3, (R, P), generator=gen).float()
    return (table, idx, cnt), Z * H * 4 + 8 * R * P


def _k4_inputs(dtype, G=3, N=5, C=4):
    x = torch.randn(G, N, N, C, generator=torch.Generator().manual_seed(3))
    x = x.to(dtype)
    return (x,), G * N * N * C * x.element_size() + G * N * 2 * C * 4


KERNELS = {
    "k1_f32": ("sorted_segment_sum", expand_cuda.sorted_segment_sum,
               expand_cuda.sorted_segment_sum_plain,
               lambda: _k1_inputs(torch.float32, False)),
    "k1_f32_strided": ("sorted_segment_sum", expand_cuda.sorted_segment_sum,
                       expand_cuda.sorted_segment_sum_plain,
                       lambda: _k1_inputs(torch.float32, True)),
    "k1_bf16": ("sorted_segment_sum", expand_cuda.sorted_segment_sum,
                expand_cuda.sorted_segment_sum_plain,
                lambda: _k1_inputs(torch.bfloat16, False)),
    # + z (R, H) and C (R, Z) written
    "k2": ("zemb_countmat", zemb_cuda.zemb_countmat,
           zemb_cuda.zemb_countmat_plain,
           lambda: (lambda i, b: (i, b + 12 * 16 * 4 + 12 * 20 * 4))(
               *_zemb_inputs())),
    # + z (E, H) written
    "k3": ("zemb_gather", zemb_gather.zemb_gather,
           zemb_gather.zemb_gather_plain,
           lambda: (lambda i, b: (i, b + 12 * 16 * 4))(*_zemb_inputs())),
    "k4_f32": ("diag_row_col_pool", ppgn_pool.diag_row_col_pool,
               ppgn_pool.diag_row_col_pool_plain,
               lambda: _k4_inputs(torch.float32)),
    "k4_bf16": ("diag_row_col_pool", ppgn_pool.diag_row_col_pool,
                ppgn_pool.diag_row_col_pool_plain,
                lambda: _k4_inputs(torch.bfloat16)),
}


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_kernel_charges_once_as_its_plain_version(kernel):
    """The wrapper records one charge under the kernel's name and none of
    its inner ops; the charge's FLOPs are what its plain version counts
    called bare; its bytes are the kernel's operands and outputs once."""
    name, wrapper, plain, make = KERNELS[kernel]
    args, nbytes = make()
    got = port_cost(wrapper, *args)
    assert list(got.by_op) == [name] and got.by_op[name].calls == 1
    bare = port_cost(plain, *args)
    assert got.flops == bare.flops > 0
    assert got.transcendentals == bare.transcendentals == 0
    assert got.bytes == nbytes


def test_kernel_charges_in_the_autograd_paths():
    """The forward of K4's autograd function and the dedup expansion's
    backward (K1, a `gather_rows` over the batch's sorted view) each
    charge one call; their other ops are counted."""
    from escgnn_tpu_torch.ops.segment import SortedIds, gather_rows

    (x,), _ = _k4_inputs(torch.float32)
    x.requires_grad_(True)
    got = port_cost(lambda: ppgn_pool.diag_row_col_pool(x).sum().backward())
    assert got.by_op["diag_row_col_pool"].calls == 1
    (dZ, perm, rows, R), _ = _k1_inputs(torch.float32, False)
    u = torch.randn(R, dZ.shape[1], requires_grad=True)
    edge_row = rows[torch.argsort(perm)]
    view = SortedIds(edge_row, perm, rows, R)
    got = port_cost(lambda: gather_rows(u, None, view).sum().backward())
    assert got.by_op["sorted_segment_sum"].calls == 1
    assert got.by_op["aten.index_select"].calls == 1


def test_kernel_bytes_at_the_path_shapes():
    """K1 at the flagship's (E, 288) strided gradient (E 12288, R 3712,
    H 256), K2 at its unique rows (R 3712, P 48, Zc 128, H 256) and K4 at
    the PPGN_eff grid (128 x 24 x 24 x 128 bf16): PERF.md's 16.5, 7.3 and
    18.9 + 3.1 MB, within 1%."""
    E, R, H = 12288, 3712, 256
    dZ = torch.zeros(E, H + 32)[:, :H]
    perm = torch.arange(E, dtype=torch.int32)
    rows = (perm % R).sort().values
    k1 = port_cost(expand_cuda.sorted_segment_sum, dZ, perm, rows, R)
    k2 = port_cost(zemb_cuda.zemb_countmat, torch.zeros(128, H),
                   torch.zeros(R, 48, dtype=torch.int32), torch.zeros(R, 48))
    k4 = port_cost(ppgn_pool.diag_row_col_pool,
                   torch.zeros(128, 24, 24, 128, dtype=torch.bfloat16))
    for got, want in ((k1, 16.5e6), (k2, 7.3e6), (k4, 22.0e6)):
        assert abs(got.bytes / want - 1) < 0.01, (got.bytes, want)


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------


def _jax_state(metric):
    want = jax_lines()[metric]
    jb = jax.tree.map(jnp.asarray, want["batch"])
    variables = want["model"].init(jax.random.key(0), jb)
    return want, jb, variables


def _port_step(metric):
    """A line's port model and optimizer after one step (the state
    `bench.run_line` counts from), and its batch."""
    line = port_line(metric)
    batch = line.host_batch()
    model = line.model("cpu")
    opt = adam_with_plateau(model.parameters(), T.LR)
    train_step(model, opt, batch, line.loss_fn)
    return line, model, opt, batch


@pytest.mark.parametrize("metric", T.METRICS)
def test_step_flops_against_jax(metric):
    """The port's `count_cost` FLOPs over `bench.py`'s `step_cost` FLOPs
    of the same line lie in [0.66, 1.02]; the flagship's in 1.02 / 0.66
    of 0.94, as measured."""
    want, jb, variables = _jax_state(metric)
    state = TrainState.create(variables["params"],
                              variables.get("batch_stats", {}), j_adam(T.LR))
    step = make_train_step(want["model"], want["loss_fn"])
    jflops, jbytes, _ = B.step_cost(step, state, jb, jax.random.key(1))
    line, model, opt, batch = _port_step(metric)
    got, _ = cost.count_cost(model, opt, batch, line.loss_fn)
    ratio = got.flops / jflops
    # the whole step's bytes ratio, for the record (PERF.md): XLA on the
    # CPU charges its flat Adam update once per parameter
    print(f"{metric}: flops {got.flops} / {jflops:.0f} = {ratio:.4f}; "
          f"bytes {got.bytes} / {jbytes} = {got.bytes / jbytes:.4f}")
    assert 0.66 <= ratio <= 1.02, ratio


def _ppgn_select_bytes(batch) -> int:
    """The (E, P, Z) f32 select of JAX's count matrix, written and read
    back by XLA on the CPU (Z: the 1800-row z table)."""
    E, P = batch["enc_idx"].shape
    return 2 * E * P * 1800 * 4


@pytest.mark.parametrize("metric", T.METRICS)
def test_forward_backward_bytes_against_jax(metric):
    """The port's forward and backward bytes over `hbm.py`'s boundary
    bytes of JAX's `value_and_grad` of the same loss lie in [0.5, 2.0]
    (PPGN_eff: less the CPU's count-matrix select)."""
    want, jb, variables = _jax_state(metric)
    stats = variables.get("batch_stats", {})
    key = jax.random.key(1)

    def grads(params, batch):
        def loss(params):
            out, mut = want["model"].apply(
                {"params": params, "batch_stats": stats}, batch,
                deterministic=False, use_running_average=False,
                mutable=["batch_stats"],
                rngs={"dropout": key, "rni": jax.random.fold_in(key, 7)})
            return want["loss_fn"](out, batch), mut["batch_stats"]
        return jax.value_and_grad(loss, has_aux=True)(params)

    compiled = jax.jit(grads).lower(variables["params"], jb).compile(
        compiler_options=_FAST_COMPILE)
    jbytes = compiled_boundary_bytes(compiled)
    if metric == T.PPGN:
        jbytes -= _ppgn_select_bytes(vars(want["batch"]))
    line, model, _, batch = _port_step(metric)
    m = copy.deepcopy(model)
    m.train()
    set_use_running_average(m, False)
    with cost.CostMode() as mode:
        line.loss_fn(m(batch), batch).backward()
    ratio = mode.total().bytes / jbytes
    print(f"{metric}: forward and backward bytes {mode.total().bytes} / "
          f"{jbytes} = {ratio:.4f}")
    assert 0.5 <= ratio <= 2.0, ratio


def test_card_optimizer_path_has_rules(monkeypatch):
    """Adam as it runs on the card (capturable, foreach: the `_foreach_`
    ops, its step counts in tensors), here on the CPU: every op has a
    rule, and its FLOPs are the CPU path's but for its scalar step
    arithmetic."""
    import torch.optim.adam as adam

    supported = adam._get_capturable_supported_devices
    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda *a, **k: supported(*a, **k) + ["cpu"])
    line = port_line(T.FLAGSHIP)
    batch = line.host_batch()
    counts, tensors = {}, 0
    for capturable in (False, True):
        model = line.model("cpu")
        opt = adam_with_plateau(model.parameters(), T.LR,
                                capturable=capturable)
        for group in opt.param_groups:
            group["foreach"] = True
        train_step(model, opt, batch, line.loss_fn)
        counts[capturable], _ = cost.count_cost(model, opt, batch,
                                                line.loss_fn)
        tensors = len(list(model.parameters()))
    ops = {k for k in counts[True].by_op if k.startswith("aten._foreach_")}
    assert {"aten._foreach_pow", "aten._foreach_addcdiv_",
            "aten._foreach_lerp_"} <= ops
    # the capturable path's step counts are tensors: a few FLOPs each
    assert 0 < counts[True].flops - counts[False].flops < 10 * tensors


def test_pool_load_bytes_is_each_field_read_and_written():
    line = port_line(T.FLAGSHIP)
    batch = line.host_batch()
    pool = stack_batches([batch, batch])
    want = 2 * sum(t.numel() * t.element_size()
                   for t in batch.tensors().values())
    assert cost.pool_load_bytes(pool) == want > 0
