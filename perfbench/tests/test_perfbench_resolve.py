"""Every cell resolves its files by name, and a cell, a traffic mix and a
per-layer metric added as files and entries alone resolve too."""

import importlib
import json
import os
import shutil

import pytest

from perfbench import cell

BENCH = json.load(open(os.path.join(cell.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(name):
    res = cell.resolve(name)
    cfg = res["config"]
    importlib.import_module(f"perfbench.systems.{cfg['model']['system']}")
    ref = importlib.import_module(
        f"perfbench.reference.{cfg['model']['reference']}")
    ref.check(cfg["model"]["fields"])
    importlib.import_module(f"perfbench.costs.{cfg['name']}")
    importlib.import_module(f"perfbench.gen.{res['traffic']['generator']}")
    names = {m["name"] for m in res["metrics"]}
    assert "setup_s" in names
    assert any(m["kind"] == "per_layer" for m in res["metrics"])
    assert any(m["kind"] == "end_to_end" and m["name"] != "setup_s"
               for m in res["metrics"])
    for path in res["readers"].values():
        assert callable(cell.reader(path))
    lim = set(res["limits"])
    assert lim & {"loss1_gap", "loss_gap"}
    assert lim & {"grad_gap", "grad_gap_median"} and "change_gap" in lim


def test_config_files_state_their_cuts():
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(cell.ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["dtype"] == "float32" and cfg["tf32"] is False


def test_a_cell_that_exists_only_as_data(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(cell.ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    # a new traffic mix: the counting graphs walked as whole fit() epochs
    mix = json.load(open(root / "perfbench/traffic/count5k_train.json"))
    mix.update(epoch=["train", "refresh", "val", "test"], refresh_batches=8)
    (root / "perfbench/traffic/count5k_epoch.json").write_text(
        json.dumps(mix))
    (root / "perfbench/limits/count_ppgn_eff.epoch.json").write_text(
        json.dumps({"loss_gap": 1, "grad_gap": 1, "change_gap": 1,
                    "stats_gap": 1, "val_gap": 1, "test_gap": 1}))
    (root / "perfbench/metrics/epochs_per_window.py").write_text(
        "def read(r):\n    return r['window']['epochs']\n")
    bench["workloads"].append(dict(
        name="count_ppgn_eff.epoch", config="count_ppgn_eff",
        traffic="count5k_epoch", chips=1, why="data only"))
    epoch_s = next(m for m in bench["end_to_end"] if m["name"] == "epoch_s")
    epoch_s["workloads"].append("count_ppgn_eff.epoch")
    bench["per_layer"].append(dict(
        name="epochs_per_window", unit="epochs", better="higher",
        source="host_clock", layer="pool step", moves="epoch_s",
        workloads=["count_ppgn_eff.epoch"]))
    res = cell.resolve("count_ppgn_eff.epoch", bench, root=str(root))
    assert res["traffic"]["epoch"] == ["train", "refresh", "val", "test"]
    read = cell.reader(res["readers"]["epochs_per_window"])
    assert read({"window": {"epochs": 7}}) == 7
    assert {m["name"] for m in res["metrics"]} >= {
        "epoch_s", "setup_s", "epochs_per_window", "featurize_s"}


def test_drawing_rules_come_from_the_adapter():
    import torch
    from torch import nn

    from perfbench import weights
    from perfbench.systems import common

    class Toy(nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 3)
            self.norm = nn.LayerNorm(3)
            self.gamma = nn.Parameter(torch.empty(3))

    def rule(mod, pname, prm):
        if pname == "gamma":
            return ("normal", 1.0)
        return common.default_rule(mod, pname, prm)

    w = weights.draw(Toy(), 7, "cpu", rule)
    assert torch.equal(w["norm.weight"], torch.ones(3))
    assert torch.equal(w["norm.bias"], torch.zeros(3))
    assert float(w["lin.weight"].abs().max()) <= 0.5
    assert torch.equal(w["gamma"], weights.draw(Toy(), 7, "cpu",
                                                rule)["gamma"])
    with pytest.raises(ValueError, match="gamma"):
        weights.draw(Toy(), 7, "cpu", common.default_rule)
