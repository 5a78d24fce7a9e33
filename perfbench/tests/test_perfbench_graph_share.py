"""The reader of `graph_share.epoch` (`metrics/graph_share.epoch.py`): the
share of the refresh's and evals' batches the system replayed from a CUDA
graph, on a registry with and without replays, on an empty registry, and
on a system that keeps no registry (as a checkout from before it)."""

import os
import sys

import pytest

from escgnn_tpu_torch.utils import trace
from perfbench import cell, program_trace

NAME = "graph_share.epoch"
R = dict(spans={}, counters={}, trace={}, window=dict(steps=75, seconds=1.0))


def _read():
    return cell.reader(os.path.join(cell.HERE, "metrics", NAME + ".py"))(R)


@pytest.fixture(autouse=True)
def registry():
    trace.reset()
    yield
    trace.reset()


@pytest.mark.parametrize("counts, want", [
    (dict(eval_batches=20, refresh_batches=8, eval_replays=20,
          refresh_replays=8), 1.0),
    (dict(eval_batches=20, refresh_batches=8, eval_replays=10,
          refresh_replays=8), 18 / 28),
    (dict(eval_batches=20, refresh_batches=8), 0.0),
    (dict(eval_batches=20, eval_replays=20), 1.0),
])
def test_share_of_replayed_batches(counts, want):
    for k, n in counts.items():
        trace.count(k.replace("_", "."), n)
    assert _read() == pytest.approx(want, rel=1e-12)


def test_empty_registry_reads_none():
    assert _read() is None


def test_system_without_the_registry_reads_none(monkeypatch):
    trace.count("eval.batches", 4)
    trace.count("eval.replays", 4)
    import escgnn_tpu_torch.utils

    monkeypatch.delattr(escgnn_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "escgnn_tpu_torch.utils.trace", None)
    assert program_trace.totals() is None
    assert _read() is None


def test_listed_for_the_epoch_cell():
    import json

    bench = json.load(open(os.path.join(cell.ROOT, "BENCHMARK.json")))
    metric = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert metric["workloads"] == ["zinc_nestedgin_eff.epoch"]
    assert NAME in cell.resolve("zinc_nestedgin_eff.epoch")["readers"]
