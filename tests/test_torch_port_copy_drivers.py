"""The copy-family flags of the driver twins, on the CPU at a tiny size
(40 graphs, hidden 16, 2 layers, batch 8, 2 epochs, `--num_workers 0`).

`run_zinc --model NGNN|I2GNN` (uniform and bucketed copy layouts) runs
beside the JAX `run_zinc.py` main in this process, the flax variables it
initialises carried into the twin's model (as
`test_torch_port_driver_parity.py` does for NestedGIN_eff): both
`log.txt` files' epoch lines agree, the loss at rel 1e-4 (or one unit of
the lines' fifth decimal) and the val MAE likewise. The `run_zinc_cycle`
(per-node copy heads, all three layouts), `run_qm9` (typed copy graphs)
and `run_ogb_mol --model NestedPPGN` flags run on the twin alone: finite
losses that fall from the first epoch to the second, the JAX drivers'
epoch lines, the specs their layouts give.
"""

import math
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

import escgnn_tpu.models.i2gnn
import escgnn_tpu.models.ngnn
from escgnn_tpu_torch import run_ogb_mol, run_qm9, run_zinc, run_zinc_cycle
from escgnn_tpu_torch.weights import load_flax_variables
from tests.test_torch_port_driver_parity import REPO, load_jax_driver

TINY = ["--num_graphs", "40", "--hidden", "16", "--layers", "2",
        "--batch_size", "8", "--epochs", "2", "--num_workers", "0"]
LINE = re.compile(r"epoch (\d{3}) lr \S+ loss (\S+) val MAE (\S+)")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _epochs(res_dir):
    lines = (res_dir / "log.txt").read_text().splitlines()
    return [tuple(float(v) for v in m.groups()[1:])
            for m in map(LINE.match, lines) if m]


def _falls(out):
    losses = [e["loss"] for e in out["epochs"]]
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], losses


def _run_jax_zinc(monkeypatch, flags, data_dir, res_dir, model):
    """The JAX run_zinc.py main with `flags`; returns the flax variables
    its copy model initialised."""
    mod = load_jax_driver("run_zinc")
    package = escgnn_tpu.models.ngnn if model == "NGNN" \
        else escgnn_tpu.models.i2gnn
    base = getattr(package, model)
    captured = {}

    class Capturing(base):
        def init(self, *args, **kwargs):
            variables = super().init(*args, **kwargs)
            captured["variables"] = jax.tree.map(np.array, variables)
            return variables

    monkeypatch.setattr(package, model, Capturing)
    monkeypatch.setattr(sys, "argv", [os.path.join(REPO, "run_zinc.py"),
                                      *flags, "--data_dir", str(data_dir),
                                      "--res_dir", str(res_dir)])
    mod.main()
    return captured["variables"]


@pytest.mark.parametrize("flags", [
    ["--model", "NGNN"],
    ["--model", "I2GNN"],
    ["--model", "I2GNN", "--copy_layout", "bucketed"],
])
def test_zinc_copy_twin_tracks_the_jax_driver(monkeypatch, tmp_path, flags):
    args = TINY + flags
    variables = _run_jax_zinc(monkeypatch, args, tmp_path / "jdata",
                              tmp_path / "jres", flags[1])
    build = run_zinc.build_model

    def build_with_jax_init(*a, **k):
        model = build(*a, **k)
        load_flax_variables(model, variables["params"],
                            variables["batch_stats"])
        return model

    monkeypatch.setattr(run_zinc, "build_model", build_with_jax_init)
    out = run_zinc.main(args + ["--device", "cpu",
                                "--data_dir", str(tmp_path / "tdata"),
                                "--res_dir", str(tmp_path / "tres")])
    want, got = _epochs(tmp_path / "jres"), _epochs(tmp_path / "tres")
    assert len(want) == len(got) == 2
    for (jl, jv), (tl, tv) in zip(want, got):
        assert math.isclose(tl, jl, rel_tol=1e-4, abs_tol=1e-5), (got, want)
        assert math.isclose(tv, jv, rel_tol=1e-4, abs_tol=1e-5), (got, want)
    _falls(out)
    spec = out["spec"]
    assert spec.copy_nodes > 0 and spec.uniform_nodes == 0
    assert (out["batch_transform"] is not None) == ("bucketed" in flags)


@pytest.mark.parametrize("flags", [
    ["--model", "NGNN"],
    ["--model", "I2GNN"],
    ["--model", "I2GNN", "--copy_layout", "bucketed"],
    ["--model", "NGNN", "--copy_layout", "ragged"],
])
def test_zinc_cycle_copy_twin(tmp_path, flags):
    """Per-node copy heads: one copy row per original node, scored
    against `y_seg` over the copy rows."""
    out = run_zinc_cycle.main(TINY + flags + [
        "--device", "cpu", "--res_dir", str(tmp_path / "res")])
    _falls(out)
    assert len(_epochs(tmp_path / "res")) == 2
    assert out["spec"].num_segments > 0
    assert (out["spec"].copy_nodes > 0) == ("ragged" not in flags)


@pytest.mark.parametrize("model", ["NGNN", "I2GNN"])
def test_qm9_copy_twin(tmp_path, model):
    out = run_qm9.main(TINY + ["--model", model, "--device", "cpu",
                               "--data_dir", str(tmp_path / "data"),
                               "--res_dir", str(tmp_path / "res")])
    _falls(out)
    assert len(_epochs(tmp_path / "res")) == 2
    assert out["spec"].copy_nodes > 0


def test_ogb_nested_ppgn_twin(tmp_path):
    """NestedPPGN on node-rooted copies with the original adjacency,
    ragged batches, its copies cached under the `_nppgn` key."""
    out = run_ogb_mol.main([
        "--model", "NestedPPGN", "--num_graphs", "60", "--emb_dim", "16",
        "--num_layer", "2", "--batch_size", "8", "--epochs", "2",
        "--num_workers", "0", "--synth_label", "tri", "--device", "cpu",
        "--data_dir", str(tmp_path / "d"), "--res_dir", str(tmp_path / "r")])
    _falls(out)
    assert out["spec"].num_segments > 0 and out["spec"].uniform_nodes == 0
    cached = os.listdir(tmp_path / "d" / "ogbg_molhiv")
    assert cached and all("_nppgn" in f for f in cached)
