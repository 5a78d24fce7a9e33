"""This slice's flags of the driver twins, on the CPU at a tiny size
(`--num_workers 0`, one torch thread).

`run_qm9 --model k1_GNN` runs beside the JAX `run_qm9.py` main in this
process, the flax variables it initialises carried into the twin's
model (as `test_torch_port_driver_parity.py` does for NestedGIN_eff):
both `log.txt` files' epoch lines agree, the loss and the val MAE at rel
1e-4 (or one unit of the lines' fifth decimal). `run_zinc --model GNN`
and `run_zinc_cycle --model GNN` (the RGCN baseline, whose model is held
to JAX's in `test_torch_port_idgnn.py`), `run_qm9 --model
k12_GNN|k13_GNN|k123_GNN` and `run_ogb_mol --model GINEPlus` (uniform
and ragged) run on the twin alone: finite losses that fall, the JAX
drivers' epoch lines, the specs and cache keys their flags give.
"""

import math
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

import escgnn_tpu.models.kgnn_models
from escgnn_tpu_torch import run_ogb_mol, run_qm9, run_zinc, run_zinc_cycle
from escgnn_tpu_torch.weights import load_flax_variables
from tests.test_torch_port_driver_parity import REPO, load_jax_driver

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


def _run_jax(monkeypatch, driver, package, model, flags, data_dir, res_dir):
    """The JAX `<driver>.py` main with `flags`; returns the flax variables
    its `package.model` initialised."""
    mod = load_jax_driver(driver)
    captured = {}

    class Capturing(getattr(package, model)):
        def init(self, *args, **kwargs):
            variables = super().init(*args, **kwargs)
            captured["variables"] = jax.tree.map(np.array, variables)
            return variables

    monkeypatch.setattr(package, model, Capturing)
    monkeypatch.setattr(sys, "argv", [os.path.join(REPO, f"{driver}.py"),
                                      *flags, "--data_dir", str(data_dir),
                                      "--res_dir", str(res_dir)])
    mod.main()
    return captured["variables"]


def test_qm9_k1_twin_tracks_the_jax_driver(monkeypatch, tmp_path):
    """Per-epoch loss and val MAE of the twin on the JAX driver's initial
    weights, at rel 1e-4, over 2 epochs of pool steps, BN refreshes and
    plateau scheduling."""
    twin = run_qm9
    flags = ["--model", "k1_GNN", "--num_graphs", "40", "--batch_size", "8",
             "--epochs", "2", "--num_workers", "0"]
    variables = _run_jax(monkeypatch, "run_qm9",
                         escgnn_tpu.models.kgnn_models, "KGNN", flags,
                         tmp_path / "jdata", tmp_path / "jres")
    build = twin.build_model

    def build_with_jax_init(*a, **k):
        m = build(*a, **k)
        load_flax_variables(m, variables["params"],
                            variables.get("batch_stats", {}))
        return m

    monkeypatch.setattr(twin, "build_model", build_with_jax_init)
    out = twin.main(flags + ["--device", "cpu",
                             "--data_dir", str(tmp_path / "tdata"),
                             "--res_dir", str(tmp_path / "tres")])
    want, got = _epochs(tmp_path / "jres"), _epochs(tmp_path / "tres")
    assert len(want) == len(got) == 2
    for (jl, jv), (tl, tv) in zip(want, got):
        assert math.isclose(tl, jl, rel_tol=1e-4, abs_tol=1e-5), (got, want)
        assert math.isclose(tv, jv, rel_tol=1e-4, abs_tol=1e-5), (got, want)
    _falls(out)
    assert out["spec"].uniform_nodes == 0  # the ragged union


def test_zinc_gnn_twin(tmp_path):
    """The RGCN baseline on the ragged width batches of the ESC-featurized
    graphs, as the JAX driver batches them (the model reads none of the
    encoding)."""
    out = run_zinc.main([
        "--model", "GNN", "--num_graphs", "40", "--layers", "2",
        "--batch_size", "8", "--epochs", "2", "--num_workers", "0",
        "--device", "cpu", "--data_dir", str(tmp_path / "d"),
        "--res_dir", str(tmp_path / "res")])
    _falls(out)
    assert len(_epochs(tmp_path / "res")) == 2
    spec = out["spec"]
    assert spec.uniform_nodes == 0 and spec.enc_width > 0


def test_zinc_cycle_gnn_twin(tmp_path):
    """The node-level RGCN on the raw graphs, in ragged batches."""
    out = run_zinc_cycle.main([
        "--model", "GNN", "--num_graphs", "40", "--layers", "2",
        "--batch_size", "8", "--epochs", "2", "--device", "cpu",
        "--res_dir", str(tmp_path / "res")])
    _falls(out)
    assert len(_epochs(tmp_path / "res")) == 2
    spec = out["spec"]
    assert spec.uniform_nodes == 0 and spec.enc_width == 0
    assert spec.y_is_node_level


@pytest.mark.parametrize("model,levels", [
    ("k12_GNN", (2,)), ("k13_GNN", (3,)), ("k123_GNN", (2, 3))])
def test_qm9_nested_kgnn_twin(tmp_path, model, levels):
    """The nested k-GNNs on h-2 node copies with their k-set graphs: the
    spec carries exactly the budgets of the model's levels."""
    out = run_qm9.main([
        "--model", model, "--h", "2", "--num_graphs", "30", "--batch_size",
        "8", "--epochs", "2", "--num_workers", "0", "--device", "cpu",
        "--data_dir", str(tmp_path / "data"),
        "--res_dir", str(tmp_path / "res")])
    _falls(out)
    spec = out["spec"]
    for k in (2, 3):
        assert (getattr(spec, f"num_kset{k}") > 0) == (k in levels)
    assert (spec.num_assign_2to3 > 0) == (levels == (2, 3))
    assert spec.num_segments > 0


@pytest.mark.parametrize("layout", ["uniform", "ragged"])
def test_ogb_gineplus_twin(tmp_path, layout):
    """GINE+ on the multihop edges (k 2): uniform per-graph blocks without
    an encoding, or the ragged union; the feature cache under the JAX
    driver's `_ginep<k>` key."""
    out = run_ogb_mol.main([
        "--model", "GINEPlus", "--multihop_k", "2", "--num_graphs", "60",
        "--emb_dim", "16", "--num_layer", "2", "--batch_size", "8",
        "--epochs", "2", "--num_workers", "0", "--synth_label", "tri",
        "--layout", layout, "--device", "cpu",
        "--data_dir", str(tmp_path / "d"), "--res_dir", str(tmp_path / "r")])
    assert all(math.isfinite(e["loss"]) for e in out["epochs"])
    assert 0.0 <= out["best_val"] <= 1.0
    spec = out["spec"]
    assert spec.enc_width == 0
    assert (spec.uniform_nodes > 0) == (layout == "uniform")
    names = os.listdir(tmp_path / "d" / "ogbg_molhiv")
    assert names and all("_labtri_ginep2" in n for n in names), names
