"""The GPS driver twin (`escgnn_tpu_torch/run_gps.py`) against the JAX
`run_gps.py`, on the CPU.

The JAX driver's `run_one` runs in this process (its module loaded with
`setup_jax` skipped) on configs/gps/zinc-GPS.yaml cut to 40 graphs,
16 x 2 with 2 heads, batch 8, 3 epochs; the flax variables its
`GPSModel.init` makes are captured and carried into the twin's model
through `run_gps.build_model`, patched here. The twin's per-epoch loss
and val MAE then equal the JAX driver's printed ones at rel 1e-4 (or
1e-5 absolute, one unit of the lines' fifth decimal), at the config's
learning rate the val MAE at rel 3e-4 (see the test). Also held: the
attention dump's keys and weights against JAX's `dump_attention`,
`--eval_only` against the run's best val MAE, auto-resume, a frozen
finetune (body parameters bit-equal to the pretrained checkpoint's), the
11 configs of the former queue 9 running, all 24 building their
datasets, and peptides-struct and PATTERN against the JAX driver's epoch
lines.
"""

import glob
import math
import os
import re

import jax
import numpy as np
import pytest
import torch

import escgnn_tpu.config as jconfig
from escgnn_tpu_torch import run_gps
from escgnn_tpu_torch.config import load_cfg
from escgnn_tpu_torch.train.checkpoint import CheckpointManager
from escgnn_tpu_torch.weights import load_flax_variables
from tests.test_torch_port_driver_parity import REPO, load_jax_driver

CFG = os.path.join(REPO, "configs", "gps", "zinc-GPS.yaml")
TINY = ["dataset.num_graphs", "40", "model.dim_h", "16", "model.num_layers",
        "2", "model.num_heads", "2", "train.batch_size", "8",
        "train.epochs", "3"]
LINE = re.compile(r"\[seed 0\] epoch (\d{3}) lr \S+ loss (\S+) val \S+ (\S+)")
QUEUE9 = ["actor", "chameleon", "code2", "cora", "imdb", "malnet", "mnist",
          "pattern", "peptides-func", "peptides-struct", "voc"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_RUNS = {}


def _jax_run(tmp_path_factory, lr: str):
    """The JAX driver's `run_one` on the tiny config at learning rate
    `lr`: its module, the flax variables it initialised, its epoch lines
    and result (one run per rate in this process)."""
    if lr not in _JAX_RUNS:
        _JAX_RUNS[lr] = _run_jax(tmp_path_factory, lr)
    return _JAX_RUNS[lr]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _jax_run(tmp_path_factory, "1e-3")


def _run_jax(tmp_path_factory, lr: str):
    return run_jax_gps(tmp_path_factory.mktemp("jax_gps"), CFG,
                       TINY + ["optim.base_lr", lr])


def run_jax_gps(tmp, cfg_path: str, opts: list) -> dict:
    """The JAX driver's `run_one` on `cfg_path` with `opts` (and
    `dataset.dir` under `tmp`): its module, the flax variables its model
    initialised, its epoch lines (loss, val metric) and its result."""
    import contextlib
    import io

    mod = load_jax_driver("run_gps")
    captured = {}

    class Capturing(mod.GPSModel):
        def init(self, *args, **kwargs):
            variables = super().init(*args, **kwargs)
            captured["variables"] = jax.tree.map(np.array, variables)
            return variables

    mod.GPSModel = Capturing
    cfg = jconfig.load_cfg(cfg_path, opts + ["dataset.dir",
                                             str(tmp / "data")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = mod.run_one(cfg, 0, str(tmp / "res"))
    lines = [tuple(float(v) for v in m.groups()[1:])
             for m in map(LINE.match, out.getvalue().splitlines()) if m]
    return dict(mod=mod, variables=captured["variables"], lines=lines,
                res=res)


def _carry(monkeypatch, variables):
    build = run_gps.build_model

    def build_with_jax_init(*args, **kwargs):
        model = build(*args, **kwargs)
        load_flax_variables(model, variables["params"],
                            variables["batch_stats"])
        return model

    monkeypatch.setattr(run_gps, "build_model", build_with_jax_init)


def _close(a, b, rel=1e-4):
    return math.isclose(a, b, rel_tol=rel, abs_tol=1e-5)


@pytest.mark.parametrize("lr,val_rel", [("1e-4", 1e-4), ("1e-3", 3e-4)])
def test_twin_tracks_the_jax_driver(monkeypatch, tmp_path, tmp_path_factory,
                                    lr, val_rel):
    """Per-epoch loss (rel 1e-4) and val MAE. At the config's rate 1e-3
    the val MAE holds at rel 3e-4: the biases that feed a BatchNorm and
    the attention's key biases have a gradient that is 0 in exact
    arithmetic, and Adam turns each package's rounding noise there into
    a step of +-lr of its own sign (measured: those biases differ by
    1.5e-3 after one step, every other gradient agrees at 1.1e-5); the
    outputs are invariant to them only up to rounding, which reaches the
    val MAE at 1.3e-4 by epoch 1. At 1e-4 the steps are ten times smaller
    and the val MAE holds at 1e-4."""
    run = _jax_run(tmp_path_factory, lr)
    _carry(monkeypatch, run["variables"])
    cfg = load_cfg(CFG, TINY + ["dataset.dir", str(tmp_path / "data"),
                                "optim.base_lr", lr])
    res = run_gps.run_one(cfg, 0, str(tmp_path / "res"), "cpu")
    want = run["lines"]
    got = [(e["loss"], e["val"]) for e in res["epochs"]]
    assert len(want) == len(got) == 3
    for (jl, jv), (tl, tv) in zip(want, got):
        assert _close(tl, jl), (got, want)
        assert _close(tv, jv, val_rel), (got, want)
    assert want[-1][0] < want[0][0]
    jres = run["res"]
    assert res["best_epoch"] == jres["best_epoch"]
    assert _close(res["best_val_mae"], jres["best_val_mae"], val_rel)
    assert _close(res["best_test_mae"], jres["best_test_mae"], val_rel)


def test_dump_attention_equals_jax(monkeypatch, tmp_path, jax_run):
    """The twin's attention dump of the carried weights has JAX's keys,
    shapes and weights (the JAX dump of the same variables, fresh BN
    statistics)."""
    mod, variables = jax_run["mod"], jax_run["variables"]
    cfg = load_cfg(CFG, TINY + ["dataset.dir", str(tmp_path / "data")])
    splits, _, _ = run_gps.build_dataset(cfg, 0)
    spec = run_gps.BatchSpec.from_graphs(
        [g for s in splits.values() for g in s], cfg.train.batch_size)
    jcfg = jconfig.load_cfg(CFG, TINY + ["dataset.dir",
                                         str(tmp_path / "jdata")])
    jsplits, _, _ = mod.build_dataset(jcfg, 0)
    jspec = mod.BatchSpec.from_graphs(
        [g for s in jsplits.values() for g in s], cfg.train.batch_size)
    jmodel = mod.GPSModel(mod._gps_config(jcfg, jsplits))
    state = mod.TrainState.create(variables["params"],
                                  variables["batch_stats"],
                                  mod.adam_with_plateau(1e-3))
    mod.dump_attention(jmodel, state, jsplits, jspec,
                       str(tmp_path / "jax.npz"))
    _carry(monkeypatch, variables)
    model = run_gps.build_model(cfg, splits, 0, "cpu")
    got = run_gps.dump_attention(model, splits, spec,
                                 str(tmp_path / "port.npz"), "cpu")
    want = np.load(tmp_path / "jax.npz")
    assert sorted(got) == sorted(want.files) == ["layer0/self_attn",
                                                  "layer1/self_attn"]
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
    assert sorted(np.load(tmp_path / "port.npz").files) == sorted(want.files)


def test_main_eval_only_resume_and_frozen_finetune(tmp_path, capsys):
    """main: config.yaml and agg.json in the run dir; `--eval_only` on the
    run's checkpoints prints the best val MAE; auto-resume starts after
    the saved epochs; a finetune with `freeze_main` keeps every body
    parameter bit-equal to the pretrained checkpoint's while the fresh
    head trains."""
    import yaml

    base = TINY + ["out_dir", str(tmp_path / "runs"), "dataset.dir",
                   str(tmp_path / "data"), "--device", "cpu"]
    res = run_gps.main(["--cfg", CFG, *base])
    run = res["runs"][0]
    with open(os.path.join(res["out_dir"], "config.yaml")) as f:
        assert yaml.safe_load(f) == load_cfg(CFG, base[:-2]).to_plain()
    assert os.path.exists(os.path.join(res["out_dir"], "agg.json"))
    ckpt = os.path.join(res["out_dir"], "ckpt_s0")
    ev = run_gps.main(["--cfg", CFG, *base, "--eval_only", ckpt])
    assert math.isclose(ev["val_mae"], run["best_val_mae"], rel_tol=1e-6)
    assert '"val_mae"' in capsys.readouterr().out

    cfg = load_cfg(CFG, TINY[:-2] + ["train.epochs", "2",
                                     "train.ckpt_period", "1", "dataset.dir",
                                     str(tmp_path / "data")])
    out = str(tmp_path / "resume")
    first = run_gps.run_one(cfg, 0, out, "cpu")
    cfg.train.epochs, cfg.train.auto_resume = 3, True
    second = run_gps.run_one(cfg, 0, out, "cpu")
    assert [e["epoch"] for e in first["epochs"]] == [1, 2]
    assert [e["epoch"] for e in second["epochs"]] == [3]

    pre = CheckpointManager(ckpt).restore()["params"]
    fin = run_gps.main(["--cfg", CFG, *base, "train.epochs", "2",
                        "pretrained.dir", ckpt,
                        "pretrained.freeze_main", "true"])
    after = CheckpointManager(os.path.join(fin["out_dir"], "ckpt_s0")
                              ).restore()["params"]
    heads = [k for k in after if k.split(".")[0] in run_gps.HEAD_KEYS]
    assert heads and set(after) == set(pre)
    for k, v in after.items():
        if k not in heads:
            assert torch.equal(v, pre[k]), k
    assert any(not torch.equal(after[k], pre[k]) for k in heads)


# the single-graph node-split configs keep their own batch of 1
SINGLE_GRAPH = ("actor", "chameleon", "cora")


@pytest.fixture(scope="module")
def shared_data(tmp_path_factory):
    """One dataset.dir for the config runs and builds below: a split the
    runs featurized is a cache hit for the builds."""
    return tmp_path_factory.mktemp("gps_data")


def _tiny(name):
    opts = TINY[:-2] + ["train.epochs", "2"]
    if name in SINGLE_GRAPH:
        i = opts.index("train.batch_size")
        del opts[i:i + 2]
    return opts


@pytest.mark.parametrize("name", QUEUE9)
def test_queue9_configs_raise_before_building_data(tmp_path, shared_data,
                                                   name):
    """The 11 configs ROADMAP queue 9 once refused (their datasets and the
    node_classification and sequence tasks) run through `main` on the
    CPU at tiny widths, 2 epochs: finite losses and a finite metric
    (accuracy, AP, MAE, macro-F1 or sub-token F1) in agg.json."""
    import json

    path = os.path.join(REPO, "configs", "gps", f"{name}-GPS.yaml")
    res = run_gps.main(["--cfg", path, *_tiny(name), "out_dir",
                        str(tmp_path / "runs"), "dataset.dir",
                        str(shared_data), "--device", "cpu"])
    run = res["runs"][0]
    losses = [e["loss"] for e in run["epochs"]]
    metric = {k: v for k, v in run.items() if k.startswith("best_")}
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert len(metric) == 3 and all(math.isfinite(v)
                                    for v in metric.values()), metric
    cfg = load_cfg(path)
    key = {"node_classification": "f1", "sequence": "f1",
           "classification": "acc", "multilabel": "ap"}.get(
        cfg.dataset.task, "mae")
    assert f"best_val_{key}" in run
    with open(os.path.join(res["out_dir"], "agg.json")) as f:
        assert f"best_test_{key}_mean" in json.load(f)["agg"]


def test_every_config_is_runnable_or_queue9(shared_data):
    """All 24 configs load through `config.py` and build their dataset
    (40 graphs, the single-graph ones whole): three non-empty splits."""
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "gps", "*.yaml")))
    assert len(paths) == 24
    for p in paths:
        cfg = load_cfg(p, ["dataset.num_graphs", "40", "dataset.dir",
                           str(shared_data)])
        splits, mean, std = run_gps.build_dataset(cfg, 0)
        assert sorted(splits) == ["test", "train", "val"], p
        assert all(len(v) for v in splits.values()), p
        assert math.isfinite(mean) and math.isfinite(std), p


@pytest.mark.parametrize("name", ["peptides-struct", "pattern"])
def test_new_tasks_track_the_jax_driver(monkeypatch, tmp_path, name):
    """peptides-struct (11 standardized targets, MAE) and PATTERN (node
    classification, macro-F1) at tiny widths, lr 1e-4 (see
    test_twin_tracks_the_jax_driver), 3 epochs from the JAX driver's
    init: per-epoch loss and val metric at rel 1e-4, the best epoch and
    the best test metric as JAX's."""
    path = os.path.join(REPO, "configs", "gps", f"{name}-GPS.yaml")
    opts = TINY + ["optim.base_lr", "1e-4"]
    run = run_jax_gps(tmp_path / "jax", path, opts)
    _carry(monkeypatch, run["variables"])
    cfg = load_cfg(path, opts + ["dataset.dir", str(tmp_path / "data")])
    res = run_gps.run_one(cfg, 0, str(tmp_path / "res"), "cpu")
    want = run["lines"]
    got = [(e["loss"], e["val"]) for e in res["epochs"]]
    assert len(want) == len(got) == 3
    for (jl, jv), (tl, tv) in zip(want, got):
        assert _close(tl, jl) and _close(tv, jv), (got, want)
    assert want[-1][0] < want[0][0]
    jres = run["res"]
    assert set(res) - {"epochs"} == set(jres)
    assert res["best_epoch"] == jres["best_epoch"]
    for k, v in jres.items():
        if k.startswith("best_test"):
            assert _close(res[k], v), (k, res[k], v)
