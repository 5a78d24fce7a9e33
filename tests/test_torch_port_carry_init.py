"""`tools/carry_jax_init.py`: the JAX counting driver's initial weights,
dumped without training, carried into the twin, give the epoch lines
the JAX driver prints from them (PPGN_eff at 40 graphs, hidden 16, 2
layers, 2 epochs, at the driver parity test's tolerance: loss rel 1e-4
or 1e-5 absolute, val MAE rel 3e-3).
"""

import importlib.util
import math
import os
import re
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_port_driver_parity import load_jax_driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "carry_jax_init", os.path.join(ROOT, "tools", "carry_jax_init.py"))
carry = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(carry)

FLAGS = ["--model", "PPGN_eff", "--num_graphs", "40", "--hidden", "16",
         "--layers", "2", "--batch_size", "8", "--epochs", "2"]
LINE = re.compile(r"epoch (\d{3}) lr \S+ loss (\S+) val MAE (\S+)")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(path):
    return [tuple(map(float, m.groups()[1:]))
            for m in map(LINE.match, open(path).read().splitlines()) if m]


def test_dump_then_run_tracks_the_jax_driver(monkeypatch, tmp_path):
    init = str(tmp_path / "init.npz")
    carry.dump(init, "run_graphcount", FLAGS + [
        "--data_dir", str(tmp_path / "jd"), "--res_dir", str(tmp_path / "jr")])
    variables = carry.load(init)
    assert set(variables) == {"params", "batch_stats"}
    mod = load_jax_driver("run_graphcount")
    monkeypatch.setattr(sys, "argv", [
        "run_graphcount.py", *FLAGS, "--num_workers", "0",
        "--data_dir", str(tmp_path / "jd2"),
        "--res_dir", str(tmp_path / "jfull")])
    mod.main()
    carry.run(init, "run_graphcount", FLAGS + [
        "--device", "cpu", "--num_workers", "0",
        "--data_dir", str(tmp_path / "td"), "--res_dir", str(tmp_path / "tr")])
    want = _lines(tmp_path / "jfull" / "log.txt")
    got = _lines(tmp_path / "tr" / "log.txt")
    assert len(want) == len(got) == 2
    for (jl, jv), (tl, tv) in zip(want, got):
        assert math.isclose(tl, jl, rel_tol=1e-4, abs_tol=1e-5)
        assert math.isclose(tv, jv, rel_tol=3e-3, abs_tol=1e-5)
    # the dumped leaves are the driver's own init: a second dump is equal
    again = str(tmp_path / "again.npz")
    carry.dump(again, "run_graphcount", FLAGS + [
        "--data_dir", str(tmp_path / "jd"), "--res_dir", str(tmp_path / "jr")])
    with np.load(init) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
