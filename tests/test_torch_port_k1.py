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
from escgnn_tpu_torch.utils import trace

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_drops_positions_outside_the_rows(dtype):
    """Positions whose row lies outside [0, R) (a masked view's, sorted
    last under R; negative ones first) add nothing: the plain version
    equals the sum over the positions in range, as JAX's segment_sum
    drops out-of-range ids."""
    rng = np.random.default_rng(3)
    E, R = 200, 40
    ids = rng.integers(-3, R + 5, E).astype(np.int32)
    ids[:50] = R  # masked rows, as the sorted views send them
    rows = np.sort(ids)
    perm = rng.permutation(E).astype(np.int32)
    vals = rng.normal(size=(E, 6)).astype(np.float32)
    dZ = torch.from_numpy(vals).to(dtype)
    got = expand_cuda.sorted_segment_sum(dZ, torch.from_numpy(perm),
                                         torch.from_numpy(rows), R)
    keep = (rows >= 0) & (rows < R)
    want = np.zeros((R, 6), np.float64)
    np.add.at(want, rows[keep], dZ.float().numpy()[perm[keep]])
    assert got.shape == (R, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want_jax = jax.ops.segment_sum(jnp.asarray(dZ.float().numpy()[perm]),
                                   jnp.asarray(rows), R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), rtol=1e-6,
                               atol=1e-6)


def test_cost_charges_only_the_positions_read():
    """`segsum_cost`: the plain version's FLOPs over all E positions, and
    bytes for the dZ rows, perm and ids of the positions in range only
    (the kernel never loads the others) plus the (R, H) f32 output."""
    E, R, H = 100, 30, 8
    rows = torch.sort(torch.randint(0, R, (E,))).values.to(torch.int32)
    rows[70:] = R  # 30 masked positions, sorted last
    rows[:5] = -1
    perm = torch.randperm(E).to(torch.int32)
    for dtype, elt in ((torch.float32, 4), (torch.bfloat16, 2)):
        dZ = torch.zeros(E, H, dtype=dtype)
        flops, trans, nbytes = expand_cuda.segsum_cost(dZ, perm, rows, R)
        assert flops == E * H * (1 if elt == 4 else 2) + 4 * E
        assert trans == 0
        assert nbytes == 65 * (H * elt + 8) + R * H * 4


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
    assert trace.counter("k1.launches") == 0


@pytest.mark.parametrize("E,H,sms,want", [
    # want: (rows R, the plan). The flagship: R + 2E = 28288 merge-path
    # items (a position weighs 2, a row end 1), one share of 215 per SM
    (12288, 256, 132, (3712, SegsumPlan(215, 132, 2 * 132 * 256, 32))),
    # the same on a 114-SM part
    (12288, 256, 114, (3712, SegsumPlan(249, 114, 2 * 114 * 256, 32))),
    # one edge on one row, five columns (slots of 8 floats); no edge: a
    # share of one position's weight at least
    (1, 5, 132, (1, SegsumPlan(2, 2, 2 * 2 * 8, 64))),
    (0, 5, 132, (5, SegsumPlan(2, 3, 2 * 3 * 8, 64))),
    # chip_smoke's ragged and long-run cases, a PPGN_eff-sized sum
    (1000, 96, 132, (300, SegsumPlan(18, 128, 2 * 128 * 96, 64))),
    (20000, 256, 132, (3000, SegsumPlan(326, 132, 2 * 132 * 256, 32))),
    (21504, 128, 132, (3072, SegsumPlan(350, 132, 2 * 132 * 128, 32))),
    # past 1024 items per SM the share stops at 1024 and the grid grows
    (10**6, 256, 132, (10**5, SegsumPlan(1024, 2051, 2 * 2051 * 256, 32))),
    # the regimes the sorted views brought: k123's masked set sum (a
    # 4960-row gap; its masked positions count as items, unread), the
    # GPS peptides and ZINC layer sums and the TU pooling, one share of
    # 780, 59, 23 and 31 items per SM
    (45408, 64, 132, (12016, SegsumPlan(780, 132, 2 * 132 * 64, 32))),
    (2560, 96, 132, (2544, SegsumPlan(59, 130, 2 * 130 * 96, 64))),
    (1024, 64, 132, (928, SegsumPlan(23, 130, 2 * 130 * 64, 64))),
    (1928, 32, 132, (128, SegsumPlan(31, 129, 2 * 129 * 32, 64))),
])
def test_plan_at_main_and_limit_shapes(E, H, sms, want):
    R, plan = want
    assert expand_cuda.segsum_plan(E, H, R, sms) == plan


@pytest.mark.parametrize("num_sms", [1, 7, 114, 132])
def test_plan_covers_every_edge_once(num_sms):
    """For any shape: the shares tile the R + POS_WEIGHT * E merge-path
    items with the last one ragged at most, one share per SM until shares
    reach MAX_SHARE, never under one position's weight, and slots for a
    head and a tail per block."""
    w = expand_cuda.POS_WEIGHT
    for E in (0, 1, 2, 31, 94, 131, 132, 133, 1000, 12288, 33792, 10**5):
        for R in (1, 5, 128, 3712, 12016):
            for H in (1, 5, 96, 256, 300):
                p = expand_cuda.segsum_plan(E, H, R, num_sms)
                items = R + w * E
                assert w <= p.share <= expand_cuda.MAX_SHARE
                assert (p.grid - 1) * p.share < items <= p.grid * p.share
                assert p.grid <= num_sms or p.share == expand_cuda.MAX_SHARE
                assert p.partial_floats == 2 * p.grid * (-(-H // 4) * 4)
                assert p.snap == (expand_cuda.SNAP
                                  if p.share <= expand_cuda.SHORT_SHARE
                                  else expand_cuda.SNAP // 2)


def test_plan_forced_choices_and_bad_shapes():
    """The plan is a function of (E, H, R) and the SM count alone, and
    refuses an empty width, no rows, no SMs, a negative E and more blocks
    than the counters can name."""
    with pytest.raises(TypeError):
        expand_cuda.segsum_plan(12288, 256, 3712, share=32)
    for E, H, R, sms in ((-1, 8, 8, 132), (8, 0, 8, 132), (8, 8, 0, 132),
                         (8, 8, 8, 0)):
        with pytest.raises(ValueError, match="bad shape"):
            expand_cuda.segsum_plan(E, H, R, sms)
    # R + 2E items: the most blocks the counters can name, then one more
    most = expand_cuda.MAX_GRID * expand_cuda.MAX_SHARE
    w = expand_cuda.POS_WEIGHT
    E = (most - expand_cuda.MAX_SHARE - 1) // w
    assert expand_cuda.segsum_plan(E, 4, 1, 1).grid == expand_cuda.MAX_GRID - 1
    with pytest.raises(ValueError, match="fewer than"):
        expand_cuda.segsum_plan((most - 1) // w, 4, 1, 1)


def test_source_constants_match_the_plan():
    """The kernel's share limit, position weight, snap window, slot
    alignment and grid limit are the plan's, its staging holds a share's
    positions, the window before them and one past them, and the ticket
    counter's fields (a 24-bit sum and two 20-bit block indices) fill its
    64 bits."""
    src = open(SOURCE).read()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kMaxShare")) == expand_cuda.MAX_SHARE
    assert int(const("kPosWeight")) == expand_cuda.POS_WEIGHT
    assert int(const("kSnap")) == expand_cuda.SNAP
    assert int(const("kShortShare")) == expand_cuda.SHORT_SHARE
    # a share's positions, the window before them and one past them
    assert int(const("kMaxStage")) >= expand_cuda.MAX_SHARE // \
        expand_cuda.POS_WEIGHT + expand_cuda.SNAP + 2
    assert int(const("kSlotAlign")) == expand_cuda.SLOT_ALIGN
    assert const("kMaxGrid").split("//")[0].strip() == "1 << 20"
    assert expand_cuda.MAX_GRID == 2**20
    assert "kSumMask = (1ull << 24) - 1;" in src
    assert "(ub << 24)" in src and "(ub << 44)" in src
    assert "(now >> 24) & 0xfffff" in src and "now >> 44" in src
    assert 24 + 2 * 20 == 64


def test_launcher_signature_takes_the_row_stride():
    """The C launchers take dZ's row stride as a 64-bit int after dZ,
    then the share from the plan."""
    for fn in ("expand_segsum_f32", "expand_segsum_bf16"):
        restype, args = _build.SIGNATURES["expand_segsum"][fn]
        assert restype is ctypes.c_int and len(args) == 12
        assert args[1] is ctypes.c_longlong
        assert args[4:8] == [ctypes.c_int] * 4  # E, H, R, share
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
    assert set(sweep.PHASES) == {"launch", "search", "indices", "walk",
                                 "chains"}
    for anchor in sweep.PHASES.values():
        assert src.count(anchor) == 1, anchor
