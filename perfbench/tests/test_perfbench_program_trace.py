"""The readers of the system's own spans and counters
(`perfbench/program_trace.py`): each of them on a synthetic result and a
registry filled at known seconds, on an empty registry, and on a system
that keeps none (as a checkout from before the registry)."""

import os
import sys

import pytest

from escgnn_tpu_torch.utils import trace
from perfbench import cell, program_trace

R = dict(spans={}, counters={}, trace={}, window=dict(steps=75, seconds=1.0))
WANT = {
    "pool_load_ms_per_step.train": 5.0,
    "pool_run_ms_per_step.train": 6.0,
    "batch_copies_per_step.train": 20.0,
    "eager_forward_ms.epoch": 10.0,
    "refresh_self_ms.epoch": 30.0,
    "pool_pad_s": 8.0,
    "pool_upload_s": 2.0,
    "pool_sizing_s": 3.5,
    "featurize_graphs_per_s": 3000.0,
}


def _read(name):
    return cell.reader(os.path.join(cell.HERE, "metrics", name + ".py"))(R)


@pytest.fixture
def registry(monkeypatch):
    trace.reset()
    yield
    trace.reset()


def _spend(monkeypatch, name, *seconds):
    for s in seconds:
        ticks = iter([100.0, 100.0 + s])
        monkeypatch.setattr(trace, "_clock", lambda: next(ticks))
        with trace.span(name):
            pass


def _fill(monkeypatch):
    _spend(monkeypatch, "pool_step.load", *[0.005] * 4)
    _spend(monkeypatch, "pool_step.run", *[0.006] * 4)
    trace.count("pool_step.steps", 4)
    trace.count("pool_step.copies", 80)
    _spend(monkeypatch, "refresh.forward", *[0.01] * 8)
    _spend(monkeypatch, "eval.forward", *[0.01] * 20)
    _spend(monkeypatch, "refresh", 0.32)
    _spend(monkeypatch, "pools.pad", 3.0, 5.0)
    _spend(monkeypatch, "pools.upload", 1.0, 1.0)
    _spend(monkeypatch, "pools.size", 1.5, 2.0)
    _spend(monkeypatch, "featurize", 1.0, 2.0, 1.0)
    trace.count("featurize.graphs", 12000)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_of_a_filled_registry(name, registry, monkeypatch):
    _fill(monkeypatch)
    assert _read(name) == pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_of_an_empty_registry(name, registry):
    assert _read(name) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_of_a_system_without_the_registry(name, registry, monkeypatch):
    _fill(monkeypatch)
    # a module set to None in sys.modules raises ImportError on import
    import escgnn_tpu_torch.utils

    monkeypatch.delattr(escgnn_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "escgnn_tpu_torch.utils.trace", None)
    assert program_trace.totals() is None
    assert _read(name) is None


def test_every_reader_is_listed_for_its_cells():
    import json

    bench = json.load(open(os.path.join(cell.ROOT, "BENCHMARK.json")))
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in WANT:
        assert listed[name]["workloads"], name
        for w in listed[name]["workloads"]:
            assert name in cell.resolve(w)["readers"]
