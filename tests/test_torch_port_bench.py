"""The bench twin (`escgnn_tpu_torch/bench.py`) against the root
`bench.py`, on the CPU, at BENCH_SMOKE's graph counts:

  * each graph generator bit-equal to `bench.py`'s (every array, dtype
    and extra), the GPS ZINC set (`attach_attn_bias` over the ZINC-shaped
    molecules) and NestedPPGN's (`orig_adj`) included;
  * `perf_fields` equal to `bench.py`'s on `tests/test_bench_fields.py`'s
    three cases, on a line without bytes (`roofline_frac` is `mfu`) and
    on the twin's lines (FLOPs, bytes and the replay's bytes);
  * the peak table: H100 SXM, H100 PCIe, an unknown card and the CPU;
  * each of the ten lines against the one `bench.py` builds (its
    `run_secondary` run with `bench_model` caught, and its flagship
    spec and model): the graphs, the spec's fields, the batch after the
    copy lines' bucketing bit for bit, the model config's fields, the
    loss, `n_iter` and the real edges;
  * `python -m escgnn_tpu_torch.bench --device cpu` under BENCH_SMOKE=1
    BENCH_ONLY=flagship, in a fresh interpreter: one line, the flagship
    metric, every field of `bench.py`'s plus `device` "cpu", `mfu`,
    `hbm_bw_frac`, `roofline_frac` and `vs_baseline` null, the bytes
    fields counted.

`bench.py`'s featurizers fork 8 workers; here they run in the test
process (JAX is loaded, and a fork after XLA starts its threads can
hang), and so do the twin's (`num_workers=0`): the workers only split
the graphs, each graph's features are the same.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as B
import escgnn_tpu.featurize.transform as j_transform
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.featurize.spd import attach_attn_bias as j_attach_attn_bias
from escgnn_tpu.train.loop import l1_graph_loss as j_l1_graph_loss
from escgnn_tpu_torch import bench as T
from escgnn_tpu_torch.data.batching import batch_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench.py's graph sets (its `main`, bench.py:683-704), by the twin's keys
_JAX_SETS = {
    "zinc": lambda n: B.make_zinc_like_graphs(num=n),
    "counting": lambda n: B.make_counting_graphs(num=n),
    "gps": lambda n: [j_attach_attn_bias(g)
                      for g in B.make_zinc_like_graphs(num=n, h=3)],
    "ogb": lambda n: B.make_molhiv_like_graphs(num=n),
    "i2": lambda n: B.make_i2gnn_graphs(num=n),
    "ngnn": lambda n: B.make_ngnn_graphs(num=n),
    "nppgn": lambda n: B.make_ngnn_graphs(num=n, h=2, orig_adj=True),
    "ginep": lambda n: B.make_ginep_graphs(num=n),
    "kgnn": lambda n: B.make_kgnn_graphs(num=n),
    "pep": lambda n: B.make_pep_graphs(num=n),
}
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _serial(fn):
    """`fn()` with the JAX package's featurizer kept in this process."""
    serial = j_transform.featurize_many
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_transform, "featurize_many",
                   lambda graphs, cfg, num_workers=0, **kw: serial(
                       graphs, cfg, num_workers=0, **kw))
        return fn()


def jax_set(key: str) -> list:
    """bench.py's graph set `key` at BENCH_SMOKE's count."""
    if ("jax", key) not in _CACHE:
        n = T.GRAPH_SETS[key][2]
        _CACHE["jax", key] = _serial(lambda: _JAX_SETS[key](n))
    return _CACHE["jax", key]


def port_sets() -> dict:
    """The twin's graph sets at BENCH_SMOKE's counts, no workers."""
    if "port" not in _CACHE:
        _CACHE["port"] = T.make_graph_sets(smoke=True, num_workers=0)
    return _CACHE["port"]


def port_line(metric: str):
    return T.bench_line(metric, port_sets(), smoke=True)


def jax_lines() -> dict:
    """bench.py's ten lines at BENCH_SMOKE, by metric: what `bench_model`
    receives from `run_secondary` (caught, nothing timed), and the
    flagship's graphs, `flagship_spec` and `flagship_model`."""
    if "lines" in _CACHE:
        return _CACHE["lines"]
    caught = []

    def bench_model(name, graphs, spec, model, loss_fn, n_iter,
                    node_level=False, real_edges=None, batch_transform=None):
        # the batch now, as bench_model builds it: the copy lines'
        # transforms read bucket sizes that the next line reassigns
        batch = j_pad_and_batch(graphs, spec)
        if batch_transform is not None:
            batch = batch_transform(batch)
        if real_edges is None:
            real_edges = int(np.sum([g.num_edges for g in graphs]))
        caught.append(dict(graphs=graphs, spec=spec, model=model,
                           loss_fn=loss_fn, n_iter=n_iter,
                           real_edges=real_edges, batch=batch))
        return {"value": 1.0}

    gsets = {k: jax_set(k) for k in _JAX_SETS if k != "zinc"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(B, "bench_model", bench_model)
        mp.setattr(B, "SMOKE", True)
        B.run_secondary(gsets)
    graphs = jax_set("zinc")
    # bench.py's main: the flagship's 20 steps per window under
    # BENCH_SMOKE (400 else), 5 windows
    caught.append(dict(graphs=graphs, spec=B.flagship_spec(graphs),
                       model=B.flagship_model(),
                       loss_fn=j_l1_graph_loss,
                       n_iter=20, real_edges=int(np.sum(
                           [g.num_edges for g in graphs])),
                       batch=j_pad_and_batch(graphs, B.flagship_spec(graphs))))
    assert len(caught) == len(T.METRICS)
    _CACHE["lines"] = dict(zip(T.METRICS, caught))
    return _CACHE["lines"]


def jax_arrays(jbatch) -> dict:
    out = {k: np.asarray(v) for k, v in vars(jbatch).items()
           if v is not None and hasattr(v, "shape")}
    out.update({"extras." + k: np.asarray(v)
                for k, v in (jbatch.extras or {}).items()})
    return out


def assert_graphs_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.num_nodes == b.num_nodes
        for f in ("edge_index", "x", "edge_attr", "y", "pos", "enc_idx",
                  "enc_cnt", "enc_offsets"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert np.asarray(x).dtype == np.asarray(y).dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
        assert set(a.extras or {}) == set(b.extras or {})
        for k, v in (a.extras or {}).items():
            assert np.asarray(v).dtype == np.asarray(b.extras[k]).dtype, k
            np.testing.assert_array_equal(v, b.extras[k], err_msg=k)


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------


def test_raw_zinc_graphs_bit_equal():
    assert_graphs_equal(T._raw_zinc_graphs(16, 3), B._raw_zinc_graphs(16, 3))


@pytest.mark.parametrize("key", list(_JAX_SETS))
def test_generators_bit_equal(key):
    """Every graph set the lines batch, at BENCH_SMOKE's count: the same
    graphs, arrays, dtypes and extras as bench.py's."""
    assert_graphs_equal(port_sets()[key], jax_set(key))


def test_graph_sets_follow_bench_counts():
    """The full and BENCH_SMOKE graph counts are bench.py's main's."""
    counts = {k: (v[1], v[2]) for k, v in T.GRAPH_SETS.items()}
    assert counts == {"zinc": (128, 16), "counting": (128, 16),
                      "gps": (32, 8), "ogb": (32, 8), "i2": (16, 4),
                      "ngnn": (16, 4), "nppgn": (16, 4), "ginep": (32, 8),
                      "kgnn": (16, 4), "pep": (16, 2)}
    assert set(T.LINE_SETS) == set(T.METRICS)


# ---------------------------------------------------------------------------
# perf_fields and the peaks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    # tests/test_bench_fields.py's three cases
    dict(times=[1.0], n_iter=10, real_edges=50, fps=2.0, peak=100.0,
         bps=9.0, bw=100.0, bps_opcount=30.0),
    dict(times=[1.0], n_iter=10, real_edges=50, fps=9.0, peak=100.0,
         bps=2.0, bw=100.0),
    dict(times=[1.0, 1.2], n_iter=10, real_edges=50, fps=None, peak=None),
    # FLOPs and a peak, no bytes
    dict(times=[0.61, 0.6, 0.63], n_iter=100, real_edges=12288,
         fps=5.4e9, peak=989.4e12, bw=3.35e12),
    # the twin's lines: FLOPs, the step's bytes (its opcount the same) and
    # the replay's
    dict(times=[0.61, 0.6, 0.63], n_iter=100, real_edges=12288,
         fps=4.29e10, peak=989.4e12, bps=5.417e9, bw=3.35e12,
         bps_opcount=5.417e9, bps_scanbody=5.422e9),
])
def test_perf_fields_equal_bench(kw):
    assert T.perf_fields(**kw) == B.perf_fields(**kw)


def test_perf_fields_without_bytes_is_mfu():
    f = T.perf_fields(times=[0.61, 0.6, 0.63], n_iter=100, real_edges=12288,
                      fps=5.4e9, peak=989.4e12, bw=3.35e12)
    assert f["hbm_bw_frac"] is None and f["bw_frac_source"] is None
    assert f["roofline_frac"] == f["mfu"] > 0
    assert f["binding_resource"] == "flops"
    assert f["bytes_per_step"] is None


@pytest.mark.parametrize("name,flops,bw", [
    ("NVIDIA H100 80GB HBM3", 989.4e12, 3.35e12),
    ("NVIDIA H100 PCIe", 756e12, 2.0e12),
    ("NVIDIA A100-SXM4-80GB", None, None),
    (None, None, None),
])
def test_peak_table(name, flops, bw):
    assert T.peak_bf16_flops(name) == flops
    assert T.peak_hbm_bytes_per_s(name) == bw


def test_cpu_has_no_name_and_no_peak():
    cpu = torch.device("cpu")
    assert T.device_name(cpu) is None and T.device_tag(cpu) == "cpu"
    assert T.peak_bf16_flops(T.device_name(cpu)) is None


def test_metric_names_are_bench_order():
    assert list(T.METRICS) == list(B.ROUND4_MEASURED)


# ---------------------------------------------------------------------------
# the lines against bench.py's
# ---------------------------------------------------------------------------


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("metric", T.METRICS)
def test_line_setup_equals_bench(metric):
    """A line's graphs, spec, batch (after the copy lines' bucketing), the
    model config's fields, the loss, n_iter and the real edges equal
    bench.py's line at BENCH_SMOKE."""
    want, got = jax_lines()[metric], port_line(metric)
    assert_graphs_equal(got.graphs, want["graphs"])
    assert _fields(got.spec) == _fields(want["spec"])
    jb, tb = want["batch"], got.host_batch()
    for attr in ("nodes_per_graph", "edges_per_graph", "nodes_per_seg",
                 "edges_per_seg", "seg_regions"):
        assert getattr(tb, attr) == getattr(jb, attr), attr
    tarr = {k: v.numpy() for k, v in tb.tensors().items()}
    jarr = jax_arrays(jb)
    assert set(tarr) == set(jarr)
    for k, w in jarr.items():
        assert tarr[k].dtype == w.dtype, k
        np.testing.assert_array_equal(tarr[k], w, err_msg=k)
    jcfg = _fields(want["model"].cfg)
    tcfg = _fields(got.config)
    assert {k: tcfg.get(k, "missing") for k in jcfg} == jcfg
    assert got.loss_fn.__name__ == want["loss_fn"].__name__
    assert got.n_iter == want["n_iter"]
    assert got.real_edges == want["real_edges"]
    assert got.windows == (5 if metric == T.FLAGSHIP else 3)


def test_host_batch_is_the_batchers():
    """Without a transform a line's batch is `pad_and_batch`'s arrays."""
    line = port_line(T.GPS_ZINC)
    want = batch_arrays(line.graphs, line.spec)
    got = line.host_batch().tensors()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_line_widths_come_from_the_batch():
    """The port's models take their input widths: NestedPPGN's and
    k123's are the batch's x and edge_attr columns (and k123's `pos`,
    which the copy transform drops)."""
    nppgn = port_line(T.NESTED_PPGN)
    b = nppgn.host_batch()
    assert nppgn.model_kwargs == dict(in_dim=b.x.reshape(b.num_nodes, -1)
                                      .shape[1],
                                      edge_dim=b.edge_attr.reshape(
                                          b.num_edges, -1).shape[1])
    k123 = port_line(T.K123)
    b = k123.host_batch()
    assert k123.model_kwargs == dict(x_dim=b.x.shape[1],
                                     edge_dim=b.edge_attr.shape[1],
                                     has_pos=b.pos is not None)


def test_unknown_metric_raises():
    with pytest.raises(ValueError, match="unknown bench metric"):
        T.bench_line("nope", port_sets())


# ---------------------------------------------------------------------------
# the entry point on the CPU
# ---------------------------------------------------------------------------


def test_main_defaults_to_cuda_and_raises_without_it():
    """Without a card `main()` raises before it builds any graph."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot run")
    with pytest.raises(RuntimeError, match="cuda"):
        T.main([])


def test_main_smoke_flagship_on_cpu(tmp_path):
    """`python -m escgnn_tpu_torch.bench --device cpu` under BENCH_SMOKE=1
    BENCH_ONLY=flagship prints one line: the flagship metric with every
    field of bench.py's lines, `device` "cpu", no peak (mfu, hbm_bw_frac
    and roofline_frac null), no TPU denominator (vs_baseline, vs_r01
    null), a positive FLOP count and the bytes of the counted step (the
    opcount equal to it: no fusion) and of the replay (the pool step's
    copies on top); with BENCH_PROFILE_DIR it writes the profiler's trace
    there."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(BENCH_SMOKE="1", BENCH_ONLY="flagship", OMP_NUM_THREADS="2",
               BENCH_PROFILE_DIR=str(tmp_path / "trace"))
    r = subprocess.run([sys.executable, "-m", "escgnn_tpu_torch.bench",
                        "--device", "cpu"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    lines = [json.loads(ln) for ln in r.stdout.splitlines()]
    assert len(lines) == 1
    line = lines[0]
    assert line["metric"] == T.FLAGSHIP == list(B.ROUND4_MEASURED)[-1]
    want = set(B.perf_fields([1.0], 1, 1, None, None)) | {
        "metric", "unit", "vs_baseline", "vs_r01", "device"}
    assert set(line) == want
    assert line["device"] == "cpu" and line["unit"] == "edges/s"
    assert line["mfu"] is None and line["vs_baseline"] is None
    assert line["vs_r01"] is None and line["windows"] == 5
    assert line["flops_per_step"] > 0
    assert line["bytes_per_step"] > 0
    assert line["bytes_per_step_opcount"] == line["bytes_per_step"]
    assert line["bytes_per_step_scanbody"] > line["bytes_per_step"]
    assert line["bw_frac_source"] == "scanbody"
    assert line["hbm_bw_frac"] is None and line["roofline_frac"] is None
    assert line["binding_resource"] is None
    assert line["value"] > 0 and line["ms_per_step"] > 0
    with open(tmp_path / "trace" / "bench_trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_count_flops_leaves_the_line_as_it_was():
    """The cost count (`utils/cost.py` `count_cost`, which replaced
    `count_flops`) runs one eager step on a copy of the model and the
    optimizer: the line's own model, Adam state and gradients are left as
    they were, and the copy's loss is the next step's (from the same
    state). A copy of the optimizer keeps its clip and frozen tensors."""
    import copy

    from escgnn_tpu_torch.train.loop import adam_with_plateau, train_step
    from escgnn_tpu_torch.utils.cost import count_cost

    line = port_line(T.GPS_ZINC)
    batch = line.host_batch()
    m = line.model("cpu")
    frozen = next(iter(m.parameters()))
    opt = adam_with_plateau(m.parameters(), T.LR, grad_clip=5.0,
                            frozen=[frozen])
    train_step(m, opt, batch, line.loss_fn)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    moments = {id(p): {k: v.clone() for k, v in s.items()}
               for p, s in opt.state.items()}
    grads = {k: p.grad.clone() for k, p in m.named_parameters()
             if p.grad is not None}
    step_cost, loss = count_cost(m, opt, batch, line.loss_fn)
    assert step_cost.flops > 0 and step_cost.bytes > 0
    # K1 per layer in the z expansion's backward and in the backward of
    # the dense attention grid's gather back to the nodes, and in the six
    # embedding lookups' backwards
    assert step_cost.by_op["sorted_segment_sum"].calls == 14
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p, s in opt.state.items():
        for k, v in s.items():
            assert torch.equal(v, moments[id(p)][k]), k
    for k, p in m.named_parameters():
        assert (p.grad is None) == (k not in grads), k
        if p.grad is not None:
            assert torch.equal(p.grad, grads[k]), k
    o2 = copy.deepcopy(opt)
    assert o2.grad_clip == 5.0 and len(o2.frozen) == 1
    assert o2.frozen[0] is not frozen and torch.equal(o2.frozen[0], frozen)
    assert float(train_step(m, opt, batch, line.loss_fn)) == loss
