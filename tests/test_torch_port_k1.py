"""K1, the sorted segment sum of the dedup expansion backward, on the CPU
at the flagship batch.

The kernel reads the step's gradient in place: the first 256 columns of
the (E, 288) gradient of [z_emb | edge-type embedding]. These tests hold
the plain version on that strided layout, and the gradient of the
expansion followed by the concat, to JAX; check that the gradient reaches
K1's wrapper as that column slice and not as a copy; check that the
wrapper refuses the layouts the kernel does not take before anything is
built; and hold the launch plan (`segsum_plan`) and the constants it
shares with `csrc/expand_segsum.cu`.
"""

import ctypes
import importlib.util
import os
import re

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
from escgnn_tpu_torch import _build
from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.data.molecules import synthetic_zinc
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.ops import expand_cuda, zemb
from escgnn_tpu_torch.ops.expand_cuda import SegsumPlan

SOURCE = os.path.join(_build.CSRC, "expand_segsum.cu")
SWEEP = os.path.join(os.path.dirname(os.path.dirname(_build.CSRC)), "tools",
                     "segsum_sweep.py")
H, EDGE_DIM = 256, 32  # the flagship's z_emb and edge-type widths


@pytest.fixture(scope="module")
def flagship():
    """The flagship batch (128 synthetic ZINC molecules, h=3 with RD and
    self loops, uniform + dedup layout) from each package."""
    cfg = dict(h=3, use_rd=True, self_loop=True)
    jg = j_featurize_many(j_synthetic_zinc(128, seed=0), JEscConfig(**cfg))
    tg = featurize_many(synthetic_zinc(128, seed=0), EscConfig(**cfg))
    jb = j_pad_and_batch(jg, JBatchSpec.uniform(jg, 128, enc_layout="dedup"))
    tb = pad_and_batch(tg, BatchSpec.uniform(tg, 128, enc_layout="dedup"),
                       device="cpu")
    return jb, tb


def test_plain_on_the_step_layout_matches_jax_take_transpose(flagship):
    """The plain version on the first 256 columns of an (E, 288) tensor
    equals the VJP of JAX's take at the flagship batch (rtol 1e-6: f32
    sums of each row's edges, in ascending edge order on both sides)."""
    jb, tb = flagship
    R, E = tb.enc_idx.shape[0], tb.num_edges
    assert (E, R) == (12288, 3712)
    wide = np.random.default_rng(0).normal(
        size=(E, H + EDGE_DIM)).astype(np.float32)
    dZ = torch.from_numpy(wide)[:, :H]
    assert dZ.stride() == (H + EDGE_DIM, 1)
    got = expand_cuda.sorted_segment_sum(dZ, tb.enc_edge_perm,
                                         tb.enc_row_sorted, R)
    take_t = jax.vjp(lambda u: jnp.take(u, jnp.asarray(jb.enc_edge_row),
                                        axis=0),
                     jnp.zeros((R, H), jnp.float32))[1]
    want = np.asarray(take_t(jnp.asarray(wide[:, :H]))[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_expand_then_concat_gradient_matches_jax(flagship, monkeypatch):
    """z = [expand_rows(u) | e]: the forward equals JAX's exactly, both
    gradients equal jax.vjp of take + concatenate (rtol 1e-6), and K1's
    wrapper gets the (E, 288) gradient's column slice, not a copy."""
    jb, tb = flagship
    R, E = tb.enc_idx.shape[0], tb.num_edges
    rng = np.random.default_rng(1)
    u = rng.normal(size=(R, H)).astype(np.float32)
    e = rng.normal(size=(E, EDGE_DIM)).astype(np.float32)
    co = rng.normal(size=(E, H + EDGE_DIM)).astype(np.float32)
    seen = []
    segsum = expand_cuda.sorted_segment_sum

    def spy(dZ, *args):
        seen.append((tuple(dZ.shape), dZ.stride()))
        return segsum(dZ, *args)

    monkeypatch.setattr(expand_cuda, "sorted_segment_sum", spy)
    ut = torch.tensor(u, requires_grad=True)
    et = torch.tensor(e, requires_grad=True)
    z = torch.cat([zemb.expand_rows(ut, tb), et], dim=-1)
    (z * torch.from_numpy(co)).sum().backward()
    assert seen == [((E, H), (H + EDGE_DIM, 1))]

    def cat(u, e):
        return jnp.concatenate(
            [jnp.take(u, jnp.asarray(jb.enc_edge_row), axis=0), e], axis=-1)

    want_z, vjp = jax.vjp(cat, jnp.asarray(u), jnp.asarray(e))
    gu, ge = vjp(jnp.asarray(co))
    np.testing.assert_array_equal(z.detach().numpy(), np.asarray(want_z))
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gu), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ge), rtol=1e-6,
                               atol=1e-6)


def test_expand_rows_takes_a_gradient_the_kernel_cannot(flagship):
    """A loss of z.sum() sends an expanded (stride 0) gradient: the
    backward takes it (on a CUDA device it is copied first) and each row
    gets its edge count."""
    _, tb = flagship
    R = tb.enc_idx.shape[0]
    u = torch.zeros(R, 3, requires_grad=True)
    zemb.expand_rows(u, tb).sum().backward()
    counts = torch.bincount(tb.enc_edge_row.long(), minlength=R).float()
    torch.testing.assert_close(u.grad, counts[:, None].expand(R, 3))


def test_as_rows_keeps_the_step_slice_and_copies_the_rest():
    wide = torch.randn(6, 9)
    step = wide[:, :5]
    assert expand_cuda.as_rows(step) is step
    for other in (wide.t()[:5], torch.randn(1, 5).expand(6, 5)):
        rows = expand_cuda.as_rows(other)
        assert rows.is_contiguous() and torch.equal(rows, other)


@pytest.fixture
def no_build(monkeypatch):
    """The wrapper with no library and no card: reaching the build
    raises."""
    def no_load(name):
        raise AssertionError(f"{name} was loaded")

    monkeypatch.setattr(_build, "load", no_load)


@pytest.mark.parametrize("shape,stride,dtype,reason", [
    # a transposed view and every other column
    ((8, 4), (1, 8), torch.float32, "column stride"),
    ((8, 4), (8, 2), torch.float32, "column stride"),
    # rows that overlap, and one row broadcast to all
    ((8, 4), (3, 1), torch.float32, "row stride"),
    ((8, 4), (0, 1), torch.bfloat16, "row stride"),
    # taken: the step's column slice and a contiguous tensor, refused only
    # because meta is not a CUDA device
    ((8, 4), (6, 1), torch.float32, "unsupported device"),
    ((8, 4), (4, 1), torch.bfloat16, "unsupported device"),
])
def test_wrapper_refuses_layouts_before_any_build(no_build, shape, stride,
                                                  dtype, reason):
    dZ = torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    ids = torch.zeros(shape[0], dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match=reason):
        expand_cuda.sorted_segment_sum(dZ, ids, ids, 5)
    assert expand_cuda.launches == 0


@pytest.mark.parametrize("E,H,sms,want", [
    # the flagship: one span of 94 sorted edges per SM
    (12288, 256, 132, SegsumPlan(94, 131, 2 * 131 * 256)),
    # the same on a 114-SM part
    (12288, 256, 114, SegsumPlan(108, 114, 2 * 114 * 256)),
    # one edge, five columns (slots of 8 floats); no edge
    (1, 5, 132, SegsumPlan(1, 1, 2 * 8)),
    (0, 5, 132, SegsumPlan(1, 1, 2 * 8)),
    # chip_smoke's ragged and long-run cases, the PPGN_eff edge count
    (1000, 96, 132, SegsumPlan(8, 125, 2 * 125 * 96)),
    (20000, 256, 132, SegsumPlan(152, 132, 2 * 132 * 256)),
    (21504, 128, 132, SegsumPlan(163, 132, 2 * 132 * 128)),
    # past 256 per SM the span stops at 256 and the grid grows
    (10**6, 256, 132, SegsumPlan(256, 3907, 2 * 3907 * 256)),
])
def test_plan_at_main_and_limit_shapes(E, H, sms, want):
    assert expand_cuda.segsum_plan(E, H, sms) == want


@pytest.mark.parametrize("num_sms", [1, 7, 114, 132])
def test_plan_covers_every_edge_once(num_sms):
    """For any shape: the spans tile [0, E) with the last one ragged at
    most, one span per SM until spans reach MAX_SPAN, and slots for a head
    and a tail per block."""
    for E in (1, 2, 31, 94, 131, 132, 133, 1000, 12288, 33792, 10**5):
        for H in (1, 5, 96, 256, 300):
            p = expand_cuda.segsum_plan(E, H, num_sms)
            assert 1 <= p.span <= expand_cuda.MAX_SPAN
            assert (p.grid - 1) * p.span < E <= p.grid * p.span
            assert p.grid <= num_sms or p.span == expand_cuda.MAX_SPAN
            assert p.partial_floats == 2 * p.grid * (-(-H // 4) * 4)


def test_plan_forced_choices_and_bad_shapes():
    """The plan is a function of (E, H) and the SM count alone, and
    refuses an empty width, no SMs, a negative E and more blocks than the
    counters can name."""
    with pytest.raises(TypeError):
        expand_cuda.segsum_plan(12288, 256, span=32)
    for E, H, sms in ((-1, 8, 132), (8, 0, 132), (8, 8, 0)):
        with pytest.raises(ValueError, match="bad shape"):
            expand_cuda.segsum_plan(E, H, sms)
    most = expand_cuda.MAX_GRID * expand_cuda.MAX_SPAN
    assert expand_cuda.segsum_plan(most - expand_cuda.MAX_SPAN, 4, 1).grid \
        == expand_cuda.MAX_GRID - 1
    with pytest.raises(ValueError, match="fewer than"):
        expand_cuda.segsum_plan(most, 4, 1)


def test_source_constants_match_the_plan():
    """The kernel's span limit, slot alignment and grid limit are the
    plan's, and the ticket counter's fields (a 24-bit sum and two 20-bit
    block indices) fill its 64 bits."""
    src = open(SOURCE).read()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kMaxSpan")) == expand_cuda.MAX_SPAN
    assert int(const("kSlotAlign")) == expand_cuda.SLOT_ALIGN
    assert const("kMaxGrid").split("//")[0].strip() == "1 << 20"
    assert expand_cuda.MAX_GRID == 2**20
    assert "kSumMask = (1ull << 24) - 1;" in src
    assert "(ub << 24)" in src and "(ub << 44)" in src
    assert "(now >> 24) & 0xfffff" in src and "now >> 44" in src
    assert 24 + 2 * 20 == 64


def test_launcher_signature_takes_the_row_stride():
    """The C launchers take dZ's row stride as a 64-bit int after dZ,
    then the span from the plan."""
    for fn in ("expand_segsum_f32", "expand_segsum_bf16"):
        restype, args = _build.SIGNATURES["expand_segsum"][fn]
        assert restype is ctypes.c_int and len(args) == 12
        assert args[1] is ctypes.c_longlong
        assert args[4:8] == [ctypes.c_int] * 4  # E, H, R, span
    assert set(_build.SIGNATURES["expand_segsum"]) == {
        "expand_segsum_f32", "expand_segsum_bf16"}


def test_ticket_counters_are_zeroed_once_per_device_and_size():
    """The counters are made once per (device, rows rounded up to a power
    of two), zeroed, and handed out again on the next call."""
    a = expand_cuda._counters("cpu", 3712)
    assert a.dtype == torch.int64 and a.numel() == 4096 and not a.any()
    assert expand_cuda._counters("cpu", 4000) is a
    assert expand_cuda._counters("cpu", 5000).numel() == 8192
    assert expand_cuda._counters("cpu", 1).numel() == 1


def test_sweep_phase_anchors_are_in_the_source():
    """tools/segsum_sweep.py times copies of the kernel cut short before
    comments of the source: each of them is there exactly once."""
    spec = importlib.util.spec_from_file_location("segsum_sweep", SWEEP)
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    src = open(SOURCE).read()
    assert set(sweep.PHASES) == {"launch", "indices", "walk", "chains"}
    for anchor in sweep.PHASES.values():
        assert src.count(anchor) == 1, anchor
