"""The control on the card: the reference put in the system's place and
computed in TF32 (the precision below the float32 the configurations
state) fails at least one of each cell's limits, at the configuration's
own widths on a smaller data set. The benchmark's runs never run it; the
readings at the cells' own size are in PERF.md."""

import time

import pytest

from perfbench import cell, checks, refcheck
from perfbench.tests.conftest import tiny

CELLS = ["zinc_nestedgin_eff.train", "count_ppgn_eff.train",
         "zinc_nestedgin_eff.epoch"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [101, 2**31 + 7, 9001])
def test_tf32_control_fails_a_limit(workload, seed, cuda_device):
    full = cell.resolve(workload)
    res = tiny(workload, graphs=640, batch=128)
    res["config"]["model"]["fields"] = full["config"]["model"]["fields"]
    run = cell.Run(res, seed, 0.0, False, cuda_device, time.time(), 4)
    run.setup()
    groups = run.groups()
    run.free_system()
    batches = run.reference_batches(groups)
    m, opt = res["config"]["model"], res["config"]["optimizer"]
    r32 = refcheck.readings(m["reference"], m["fields"], run.w0, batches, opt)
    ctl = refcheck.readings(m["reference"], m["fields"], run.w0, batches, opt,
                            tf32=True)
    gaps = checks.gaps(ctl, r32)
    assert any(gaps[k] > res["limits"][k] for k in res["limits"]), gaps
