"""The port's spans and counters (`escgnn_tpu_torch/utils/trace.py`): the
totals, nesting, the profiler's trace, and the exact counts at every site
on the CPU path (featurizer, pools, pool step, BN refresh, eval)."""

import json
import time

import pytest
import torch

from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.molecules import synthetic_zinc
from escgnn_tpu_torch.data.prefetch import (
    pool_size,
    stack_split,
    stack_split_compressed,
    stacked_batch_pools,
)
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.featurize.spd import attach_attn_bias_many
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.train.loop import (
    adam_with_plateau,
    l1_graph_loss,
    make_pool_eval_step,
    make_pool_refresh_step,
    make_pool_train_step,
)
from escgnn_tpu_torch.utils import trace
from perfbench import cell

CFG = dict(hidden=8, num_layers=2, act="elu", graph_pred=True, pool="add",
           use_x_embedding_jk=False, head_order="dropout_act",
           node_embed_vocab=100, node_embed_dim=4,
           edge_embed_vocab=100, edge_embed_dim=4)


@pytest.fixture(autouse=True)
def _clean_registry():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def graphs():
    return featurize_many(synthetic_zinc(12, seed=3), EscConfig(h=2))


@pytest.fixture(scope="module")
def spec(graphs):
    return BatchSpec.uniform(graphs, 4, enc_layout="dedup")


def _spans():
    return trace.snapshot()["spans"]


def _counters():
    return trace.snapshot()["counters"]


def _nbytes(batch) -> int:
    return sum(t.nbytes for t in batch.tensors().values())


def test_totals_and_nesting():
    with trace.span("outer"):
        time.sleep(0.002)
        with trace.span("inner"):
            time.sleep(0.002)
        with trace.span("outer"):  # a span of one name may nest in itself
            pass
    with trace.span("inner"):
        pass
    trace.count("c")
    trace.count("c", 4)
    got = trace.snapshot()
    assert {k: v["calls"] for k, v in got["spans"].items()} == {
        "outer": 2, "inner": 2}
    assert got["spans"]["outer"]["seconds"] >= 0.004
    assert got["spans"]["inner"]["seconds"] >= 0.002
    assert got["spans"]["outer"]["seconds"] > got["spans"]["inner"]["seconds"]
    assert got["counters"] == {"c": 5}


def test_a_raising_block_is_timed_and_the_error_passes():
    with pytest.raises(KeyError):
        with trace.span("bad"):
            raise KeyError("x")
    assert _spans()["bad"]["calls"] == 1


def test_reset_clears_the_named_or_all():
    with trace.span("a"):
        pass
    trace.count("a", 2)
    trace.count("b", 3)
    trace.reset("a")
    assert _spans() == {} and _counters() == {"b": 3}
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_snapshot_is_a_copy():
    trace.count("n")
    snap = trace.snapshot()
    snap["counters"]["n"] = 100
    assert _counters() == {"n": 1}


def test_span_under_the_profiler_lands_in_its_trace(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.span("pool_step"):
            with trace.span("pool_step.load"):
                torch.ones(3).sum()
        trace.count("seen")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"escgnn.pool_step", "escgnn.pool_step.load"} <= names
    # the totals describe the unprofiled run only; counters always count
    assert _spans() == {} and _counters() == {"seen": 1}


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    for _ in range(3):
        with trace.span("quiet"):
            pass
    assert entered == [] and _spans()["quiet"]["calls"] == 3
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("loud"):
            pass
    assert entered == ["escgnn.loud"]


def test_featurize_counts_its_graphs():
    raw = synthetic_zinc(7, seed=1)
    featurize_many(raw, EscConfig(h=2))
    assert _counters() == {"featurize.graphs": 7}
    assert _spans()["featurize"]["calls"] == 1


@pytest.mark.parametrize("layout", ["width", "dedup"])
def test_batch_spec_sizing_counts_as_padding(graphs, layout):
    """A batch spec's sizing pass is a set-up span of its own, apart from
    the padding, whichever caller builds the spec."""
    BatchSpec.uniform(graphs, 4, enc_layout=layout)
    BatchSpec.from_graphs(graphs, 4, enc_layout=layout)
    assert {n: s["calls"] for n, s in _spans().items()} == {"pools.size": 2}
    assert _counters() == {}


@pytest.mark.parametrize("k", [1, 3])
def test_stacked_pools_count_their_bytes(graphs, spec, k):
    pools, _, _ = stacked_batch_pools(graphs, spec, k=k, seed=0,
                                      device="cpu")
    assert _counters() == {"pools.bytes": sum(_nbytes(p) for p in pools)}
    spans = _spans()
    assert spans["pools.pad"]["calls"] == spans["pools.upload"]["calls"] == k


@pytest.mark.parametrize("compressed", [False, True])
def test_stack_split_counts_its_bytes(graphs, spec, compressed):
    if compressed:
        stack, _ = stack_split_compressed(graphs, spec, device="cpu")
    else:
        stack = stack_split(graphs, spec, device="cpu")
    assert _counters() == {"pools.bytes": _nbytes(stack)}
    spans = _spans()
    assert spans["pools.pad"]["calls"] == spans["pools.upload"]["calls"] == 1


@pytest.fixture
def model_and_pool(graphs, spec):
    torch.manual_seed(0)
    model = NestedGINEff(NestedGINEffConfig(**CFG), device="cpu")
    pools, _, _ = stacked_batch_pools(graphs, spec, k=1, seed=0,
                                      device="cpu")
    trace.reset()
    return model, pools[0]


@pytest.mark.parametrize("order", [[2, 0, 1, 2], [1]])
def test_eager_pool_step_counts(model_and_pool, order):
    model, pool = model_and_pool
    opt = adam_with_plateau(model.parameters(), 1e-3)
    step = make_pool_train_step(model, opt, l1_graph_loss, pool)
    losses = step(pool, order)
    k = len(order)
    assert losses.shape == (k,)
    spans = _spans()
    assert {n: spans[n]["calls"] for n in spans} == {
        "pool_step": 1, "pool_step.load": k, "pool_step.run": k}
    assert _counters() == {"pool_step.steps": k,
                           "pool_step.copies": k * len(pool.tensors())}


def test_refresh_and_eval_count_each_forward(model_and_pool):
    model, pool = model_and_pool
    b = pool_size(pool)
    make_pool_refresh_step(model)(pool)
    make_pool_eval_step(model, node_level=False)(pool)
    make_pool_eval_step(model, node_level=False, bn_mode="batch")(pool)
    spans = _spans()
    assert {n: spans[n]["calls"] for n in spans} == {
        "refresh": 1, "refresh.forward": b, "eval": 2, "eval.forward": 2 * b}
    assert spans["refresh"]["seconds"] > spans["refresh.forward"]["seconds"]
    # the CPU path is eager: every batch counted, none replayed or captured
    assert _counters() == {"refresh.batches": b, "eval.batches": 2 * b}
    for name in ("refresh", "eval"):
        assert trace.counter(name + ".replays") == 0
        assert trace.counter(name + ".captures") == 0


def test_spd_is_one_span_counting_its_graphs():
    gs = featurize_many(synthetic_zinc(5, seed=2), EscConfig(h=2))
    trace.reset()
    out = attach_attn_bias_many(gs)
    assert len(out) == 5 and all(a is b for a, b in zip(out, gs))
    assert all(g.extras["attn_bias"].shape == (g.num_nodes,) * 2
               for g in gs)
    assert _counters() == {"featurize.spd_graphs": 5}
    assert {n: s["calls"] for n, s in _spans().items()} == {
        "featurize.spd": 1}


@pytest.mark.parametrize("k", [1, 2])
def test_stacked_spd_grids_count_their_bytes(k):
    """Every stack that carries GPS's SPD grids (the train pools and a
    fixed split) counts the grids' bytes; `pools.bytes` holds them too."""
    gs = attach_attn_bias_many(
        featurize_many(synthetic_zinc(12, seed=3), EscConfig(h=2)))
    spec = BatchSpec.uniform(gs, 4, enc_layout="dedup")
    trace.reset()
    pools, _, _ = stacked_batch_pools(gs, spec, k=k, seed=0, device="cpu")
    stack = stack_split(gs, spec, device="cpu")
    grids = [p.extras["attn_bias"] for p in pools + [stack]]
    M = spec.max_nodes_per_graph
    assert all(g.shape == (3, 4, M, M) and g.dtype == torch.int16
               for g in grids)
    assert _counters() == {
        "pools.bytes": sum(_nbytes(p) for p in pools + [stack]),
        "pools.attn_bias_bytes": sum(g.nbytes for g in grids)}


# every per-layer metric the GPS cell reports: the ZINC train cell's step,
# kernel, device and set-up readers, and the SPD featurizer's
GPS_READERS = sorted(m["name"] for m in cell.resolve("gps_zinc.train")[
    "metrics"] if m["kind"] == "per_layer")


def _reader(name):
    return cell.reader(f"{cell.HERE}/metrics/{name}.py")


@pytest.mark.parametrize("name", GPS_READERS)
def test_gps_readers_read_none_without_their_source(name):
    """A run whose system has no such span, counter, window or trace (the
    parent of the cell for `spd_graphs_per_s`, or a CPU run) leaves the
    metric out."""
    r = dict(spans={}, counters={}, trace={}, peaks=dict(
        f32_flops=67e12, hbm_bytes_per_s=3.35e12))
    assert _reader(name)(r) is None


def test_spd_reader_reads_the_span_and_counter():
    attach_attn_bias_many(featurize_many(synthetic_zinc(4, seed=5),
                                         EscConfig(h=2)))
    s = _spans()["featurize.spd"]
    got = _reader("spd_graphs_per_s")({})
    assert got == pytest.approx(4 / s["seconds"])
