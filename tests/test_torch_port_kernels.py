"""The launch plan of the z-reduce kernels K2 and K3 (`ops/smem_plan.py`),
on the CPU.

The plan (column-slice width, blocks per slice, the bytes of the table
slice held in shared memory) is computed in Python and handed to the CUDA
launchers, which refuse a plan that does not match the shapes. These tests
hold the plan at the main paths' shapes and at its limits, hold the
constants of `csrc/zemb_rows.cuh` to the Python ones, and check that the
wrappers refuse what the kernels do not take before anything is built or
launched.
"""

import os
import re

import pytest
import torch

from escgnn_tpu_torch import _build
from escgnn_tpu_torch.ops import smem_plan, zemb_cuda, zemb_gather
from escgnn_tpu_torch.ops.smem_plan import SmemPlan
from escgnn_tpu_torch.utils import trace

HEADER = os.path.join(_build.CSRC, "zemb_rows.cuh")


@pytest.mark.parametrize("Z,H,want", [
    # flagship unique rows (K2): the 128 KB table in one 256-column slice
    (128, 256, SmemPlan(256, 1, 132, 128 * 1024)),
    # PPGN_eff width batch (K3): too tall for a slice, rows through L1
    (1800, 128, SmemPlan(128, 1, 132, 0)),
    # the first K2's limit, and the uncompacted table at the flagship width
    (875, 256, SmemPlan(256, 1, 132, 0)),
    (1800, 256, SmemPlan(256, 1, 132, 0)),
    # the tallest 128-column slice, and one row more
    (437, 128, SmemPlan(128, 1, 132, 437 * 512)),
    (438, 128, SmemPlan(128, 1, 132, 0)),
    # the tallest 256-column slice, and one row more
    (218, 256, SmemPlan(256, 1, 132, 218 * 1024)),
    (219, 256, SmemPlan(256, 1, 132, 0)),
    (100, 200, SmemPlan(256, 1, 132, 100 * 1024)),
    (100, 300, SmemPlan(256, 2, 66, 100 * 1024)),
    # narrow and ragged widths
    (30, 16, SmemPlan(128, 1, 132, 30 * 512)),
    (77, 41, SmemPlan(128, 1, 132, 77 * 512)),
])
def test_plan_at_main_and_limit_shapes(Z, H, want):
    plan = smem_plan.smem_plan(Z, H)
    assert plan == want
    assert plan.grid == want.slices * want.blocks_per_slice <= 132
    assert plan.resident == (want.table_bytes > 0)
    assert plan.smem_bytes == smem_plan.FIXED_BYTES + want.table_bytes
    assert plan.smem_bytes <= smem_plan.MAX_SMEM_BYTES


@pytest.mark.parametrize("num_sms", [1, 7, 114, 132])
def test_plan_covers_every_column_within_shared_memory(num_sms):
    """For any shape: the slices cover H with the last one ragged at most,
    a resident slice fits a block's shared memory, and every slice has a
    block."""
    for Z in (1, 31, 128, 218, 219, 437, 438, 1800, 60000):
        for H in (1, 32, 33, 100, 128, 129, 256, 300, 1000):
            p = smem_plan.smem_plan(Z, H, num_sms)
            assert p.slice_cols in smem_plan.SLICE_COLS
            assert (p.slices - 1) * p.slice_cols < H <= p.slices * p.slice_cols
            assert p.smem_bytes <= smem_plan.MAX_SMEM_BYTES
            assert p.table_bytes in (0, Z * p.slice_cols * 4)
            tallest = smem_plan.MAX_RESIDENT_ROWS // (p.slice_cols // 128)
            assert p.resident == (Z <= tallest)
            assert p.blocks_per_slice >= 1
            assert p.grid <= max(num_sms, p.slices)


def test_plan_forced_choices_and_bad_shapes():
    """The plan is a function of (Z, H) and the SM count alone: it takes
    no forced slice width or residency, and refuses empty shapes."""
    for kw in ({"slice_cols": 128}, {"resident": False}):
        with pytest.raises(TypeError):
            smem_plan.smem_plan(128, 256, **kw)
    assert smem_plan.smem_plan(128, 256, 66) == SmemPlan(256, 1, 66,
                                                         128 * 1024)
    for Z, H, sms in ((0, 8, 132), (8, 0, 132), (8, 8, 0)):
        with pytest.raises(ValueError):
            smem_plan.smem_plan(Z, H, sms)


def test_header_constants_match_the_plan():
    """The launchers' shared-memory limit, block size, fixed bytes and
    slice widths are the ones the plan assumes."""
    src = open(HEADER).read()

    def const(name):
        return int(re.search(rf"{name} = (\d+);", src).group(1))

    assert const("kMaxSmemBytes") == smem_plan.MAX_SMEM_BYTES
    assert const("kThreads") == smem_plan.THREADS
    assert "kFixedBytes = kHeadBytes + kWarps * 32 * 8;" in src
    assert (const("kHeadBytes") + smem_plan.THREADS * 8
            == smem_plan.FIXED_BYTES)
    widths = {int(w) for w in re.findall(r"W == (\d+)", src)}
    assert widths == set(smem_plan.SLICE_COLS)
    assert smem_plan.MAX_RESIDENT_ROWS == 437


@pytest.fixture
def no_build(monkeypatch):
    """The wrappers with no library and no card: reaching the build
    raises."""
    def no_load(name):
        raise AssertionError(f"{name} was loaded")

    monkeypatch.setattr(_build, "load", no_load)
    monkeypatch.setattr(smem_plan, "sm_count", lambda dev: 132)


def test_tall_tables_go_through_l1_not_refused(no_build, monkeypatch):
    """K2 and K3 take a table too tall for shared memory (it is read
    through L1): both reach the launch."""
    # meta tensors stand in for the card's
    monkeypatch.setattr(smem_plan, "check_inputs", lambda *a: None)
    ids = torch.zeros(4, 3, dtype=torch.int32, device="meta")
    cnt = torch.zeros(4, 3, device="meta")
    table = torch.empty(1800, 256, device="meta")
    with pytest.raises(AssertionError, match="zemb_countmat was loaded"):
        zemb_cuda.zemb_countmat(table, ids, cnt)
    with pytest.raises(AssertionError, match="zemb_gather was loaded"):
        zemb_gather.zemb_gather(table, ids, cnt)


def test_table_above_the_limit_raises_before_any_launch(no_build):
    """A table above the kernels' 32-bit row offsets is refused by both
    wrappers' input checks before any library is built or loaded, and
    one float less is not refused for its size."""
    ids = torch.zeros(4, 3, dtype=torch.int32, device="meta")
    cnt = torch.zeros(4, 3, device="meta")
    table = torch.empty(2**20, 2**11, device="meta")
    for fn in (zemb_cuda.zemb_countmat, zemb_gather.zemb_gather):
        with pytest.raises(ValueError, match="32-bit"):
            fn(table, ids, cnt)
    # 2**31 - 1 floats: refused only because meta is not a CUDA device
    with pytest.raises(ValueError, match="unsupported device"):
        zemb_gather.zemb_gather(torch.empty(2**31 - 1, 1, device="meta"),
                                ids, cnt)
    assert (trace.counter("k2.launches"),
            trace.counter("k3.launches")) == (0, 0)


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("args", [
    (_meta(4, 8, dtype=torch.float64), _meta(2, 3, dtype=torch.int32),
     _meta(2, 3)),
    (_meta(8), _meta(2, 3, dtype=torch.int32), _meta(2, 3)),
    (_meta(4, 8), _meta(2, 3, dtype=torch.int64), _meta(2, 3)),
    (_meta(4, 8), _meta(2, 3, dtype=torch.int32), _meta(2, 4)),
    (_meta(4, 8), _meta(2, 3, dtype=torch.int32),
     _meta(2, 3, dtype=torch.float16)),
    (_meta(8, 4).t(), _meta(2, 3, dtype=torch.int32), _meta(2, 3)),
    (_meta(4, 8), _meta(2, 3, dtype=torch.int32), torch.zeros(2, 3)),
    # well formed, but not on a CUDA card
    (_meta(4, 8), _meta(2, 3, dtype=torch.int32), _meta(2, 3)),
])
def test_check_inputs_refuses(args):
    """What the kernels do not take is refused: table dtype and rank, id
    dtype, count shape and dtype, a strided table, tensors on two devices,
    a device that is not CUDA."""
    with pytest.raises(ValueError):
        smem_plan.check_inputs("k", *args)
