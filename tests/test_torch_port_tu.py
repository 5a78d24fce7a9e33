"""The `run_tu` twin's modules against the JAX package on the CPU.

Bit-equal: the TU data (the synthetic set, the raw text format written
into tmp_path, degree features), the Planetoid data (synthetic and the
raw pickles), `disjoint_union`, `negate_edge_index`, `k_fold` and
`node_split`. The cycle metrics equal sklearn's (through JAX's
`_cls_metrics`) to 1e-12. The trainers run on JAX's initial weights,
carried by `weights.load_flax_variables` (dropout 0): the CV's per-epoch
val loss and test accuracy, each cycle trainer's per-epoch history and
metric tuple, and `run_tu.main`'s log lines against the JAX main in
process, all at rel 1e-4. Each CV fold starts from a fresh draw of its
own seed and a fresh optimizer.
"""

import contextlib
import io
import math
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

import escgnn_tpu.data.planetoid as j_planetoid
import escgnn_tpu.data.tu as j_tu
import escgnn_tpu.models as j_models
import escgnn_tpu.train.cv as j_cv
import escgnn_tpu.train.cycles as j_cycles
import escgnn_tpu.utils.graph as j_graph
from escgnn_tpu_torch import run_tu
from escgnn_tpu_torch.data import planetoid, tu
from escgnn_tpu_torch.data.counting import count_cycles_per_node
from escgnn_tpu_torch.models.registry import get_model
from escgnn_tpu_torch.train import cv, cycles
from escgnn_tpu_torch.utils import graph
from escgnn_tpu_torch.weights import load_flax_variables
from tests.test_planetoid import _write_raw as write_planetoid_raw
from tests.test_torch_port_driver_parity import REPO, load_jax_driver
from tests.test_torch_port_qm9 import _assert_graphs_equal


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rel=1e-4):
    return math.isclose(a, b, rel_tol=rel, abs_tol=1e-6) or (
        math.isnan(a) and math.isnan(b))


def _write_tu_raw(root, name, node_labels: bool):
    raw = os.path.join(root, name, "raw")
    os.makedirs(raw)
    rng = np.random.default_rng(3)
    edges, indicator, off = [], [], 1
    for gi, n in enumerate((5, 3, 6, 4)):
        for a in range(n - 1):
            b = int(rng.integers(a + 1, n))
            edges += [(off + a, off + b), (off + b, off + a)]
        indicator += [gi + 1] * n
        off += n
    with open(os.path.join(raw, f"{name}_A.txt"), "w") as f:
        f.write("\n".join(f"{a}, {b}" for a, b in edges))
    with open(os.path.join(raw, f"{name}_graph_indicator.txt"), "w") as f:
        f.write("\n".join(map(str, indicator)))
    with open(os.path.join(raw, f"{name}_graph_labels.txt"), "w") as f:
        f.write("1\n-1\n-1\n1\n")
    if node_labels:
        with open(os.path.join(raw, f"{name}_node_labels.txt"), "w") as f:
            f.write("\n".join(str(int(v)) for v in
                              rng.integers(0, 3, off - 1) * 2 + 1))


def test_tu_data_bit_equal(tmp_path):
    """The synthetic TU set, degree features, and both raw forms (node
    labels one-hot, and none: degree one-hots through get_tu_dataset);
    a missing dataset falls back to the synthetic set in both."""
    _assert_graphs_equal(tu.synthetic_tu(num_graphs=12, seed=4),
          j_tu.synthetic_tu(num_graphs=12, seed=4))
    _write_tu_raw(str(tmp_path), "TOY", node_labels=True)
    _write_tu_raw(str(tmp_path), "BARE", node_labels=False)
    for name in ("TOY", "BARE"):
        _assert_graphs_equal(tu.load_tu_dataset(str(tmp_path), name),
              j_tu.load_tu_dataset(str(tmp_path), name))
    for name in ("TOY", "BARE", "MISSING"):
        _assert_graphs_equal(tu.get_tu_dataset(name, root=str(tmp_path)),
              j_tu.get_tu_dataset(name, root=str(tmp_path)))
    assert tu.get_tu_dataset("BARE", root=str(tmp_path))[0].x.shape[1] > 1


def test_planetoid_data_bit_equal(tmp_path):
    """The synthetic citation graph of each name, and the raw pickles
    (scipy sparse rows, test.index order) read by get_planetoid; a name
    outside PLANETOID_NAMES is refused (JAX asserts, the port raises
    ValueError)."""
    for name in planetoid.PLANETOID_NAMES:
        _assert_graphs_equal(
            [planetoid.synthetic_planetoid(name, num_nodes=80)],
            [j_planetoid.synthetic_planetoid(name, num_nodes=80)])
    write_planetoid_raw(str(tmp_path), "Cora")
    _assert_graphs_equal(
        [planetoid.get_planetoid("Cora", root=str(tmp_path))],
        [j_planetoid.get_planetoid("Cora", root=str(tmp_path))])
    assert planetoid.get_planetoid("Cora", root=str(tmp_path)).num_nodes == 8
    with pytest.raises(ValueError, match="Planetoid name"):
        planetoid.get_planetoid("cora", root=str(tmp_path))


def test_graph_utils_bit_equal():
    """disjoint_union of raw graphs and negate_edge_index, batched and
    not, equal JAX's."""
    gs = j_tu.synthetic_tu(num_graphs=5, seed=1)
    tgs = tu.synthetic_tu(num_graphs=5, seed=1)
    _assert_graphs_equal([graph.disjoint_union(tgs)],
                         [j_graph.disjoint_union(gs)])
    u = graph.disjoint_union(tgs)
    batch = np.repeat(np.arange(5), [g.num_nodes for g in tgs])
    for b in (None, batch):
        got = graph.negate_edge_index(u.edge_index, b)
        want = j_graph.negate_edge_index(u.edge_index, b)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("folds", [3, 10])
def test_splits_equal_jax(folds):
    labels = np.random.default_rng(folds).integers(0, 3, 57)
    for (a, b, c), (x, y, z) in zip(cv.k_fold(labels, folds),
                                    j_cv.k_fold(labels, folds)):
        for p, q in ((a, x), (b, y), (c, z)):
            np.testing.assert_array_equal(p, q)
    for n, ratio, seed in ((50, 0.3, 1234), (7, 0.5, 0)):
        for p, q in zip(cycles.node_split(n, ratio, seed),
                        j_cycles.node_split(n, ratio, seed)):
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("seed", range(4))
def test_cycle_metrics_equal_sklearn(seed):
    """`_cls_metrics` (accuracy, ROC-AUC, AP per column, one-class
    columns skipped) and `_reg_metrics` equal JAX's, whose classification
    metrics are sklearn's, to 1e-12; ties and an all-degenerate case
    included."""
    rng = np.random.default_rng(seed)
    true = (rng.random((40, 4)) < 0.3).astype(np.float32)
    true[:, 1] = 0.0  # one-class column: skipped
    logits = np.round(rng.normal(size=(40, 4)), 1).astype(np.float32)
    for t, s in ((true, logits), (true[:, 1:2], logits[:, 1:2])):
        got = cycles._cls_metrics(t, s)
        want = j_cycles._cls_metrics(t, s)
        for a, b in zip(got, want):
            assert (math.isnan(a) and math.isnan(b)) or abs(a - b) < 1e-12
    pred = rng.normal(size=(40, 4)).astype(np.float32)
    np.testing.assert_allclose(cycles._reg_metrics(true, pred),
                               j_cycles._reg_metrics(true, pred),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# the trainers on JAX's initial weights
# ---------------------------------------------------------------------------

HIDDEN, LAYERS = 16, 2


class _Capturing:
    """A flax model whose every `init` is recorded (host copies)."""

    def __init__(self, model, record: list):
        self._model, self._record = model, record

    def init(self, *args, **kwargs):
        variables = self._model.init(*args, **kwargs)
        self._record.append(jax.tree.map(np.array, variables))
        return variables

    def __getattr__(self, name):
        return getattr(self._model, name)


def _load(model, variables):
    load_flax_variables(model, variables["params"],
                        variables.get("batch_stats", {}))
    return model


class _NpRecorder:
    """numpy for `escgnn_tpu.train.cv`, recording every `asarray`: its last
    two are the (folds, epochs) val losses and test accuracies."""

    def __init__(self):
        self.arrays = []

    def __getattr__(self, name):
        return getattr(np, name)

    def asarray(self, a, *args, **kwargs):
        out = np.asarray(a, *args, **kwargs)
        self.arrays.append(out)
        return out


@pytest.fixture(scope="module")
def tu_graphs():
    return tu.synthetic_tu(num_graphs=48, seed=2), j_tu.synthetic_tu(
        num_graphs=48, seed=2)


def test_cv_equals_jax_on_its_init(monkeypatch, tu_graphs):
    """3 folds x 3 epochs of BaselineGNN gin0 16 x 2, dropout 0, weight
    decay on, at lr 1e-4: every epoch's val loss and test accuracy, and
    the summary, equal JAX's at rel 1e-4 when each fold starts from JAX's
    init.

    Why lr 1e-4: the biases of the dense layers that feed a BatchNorm
    have a gradient that is 0 in exact arithmetic (~1e-8 here), and Adam
    turns each package's rounding noise there into a step of +-lr of its
    own sign. Train-mode BatchNorm cancels those biases, but the val loss
    reads the running statistics, taken before the step: at lr 1e-2 the
    val loss moves ~1e-3 between the packages, at 1e-3 5e-5, at 1e-4
    3e-6 (measured; the test accuracies agree at every rate). The GPS
    driver's test meets the same effect (test_torch_port_gps_driver.py)."""
    tg, jg = tu_graphs
    inits, rec = [], _NpRecorder()
    monkeypatch.setattr(j_cv, "np", rec)
    kw = dict(folds=3, epochs=3, batch_size=16, lr=1e-4,
              lr_decay_factor=0.5, lr_decay_step_size=2, weight_decay=1e-3,
              seed=0)
    jres = j_cv.cross_validation_with_val_set(
        jg, lambda: _Capturing(j_models.get_model(
            "BaselineGNN", conv="gin0", hidden=HIDDEN, num_layers=LAYERS,
            out_dim=2, dropout=0.0), inits), **kw)
    want_val, want_acc = rec.arrays[-2:]
    assert len(inits) == 3
    monkeypatch.setattr(cv, "fold_model",
                        lambda factory, seed: _load(factory(None),
                                                    inits[seed]))
    res = cv.cross_validation_with_val_set(
        tg, lambda g: get_model(
            "BaselineGNN", conv="gin0", hidden=HIDDEN, num_layers=LAYERS,
            out_dim=2, dropout=0.0, in_dim=tg[0].x.shape[1], device="cpu",
            generator=g), device="cpu", **kw)
    assert res.val_losses.shape == want_val.shape == (3, 3)
    np.testing.assert_allclose(res.val_losses, want_val, rtol=1e-4)
    np.testing.assert_allclose(res.test_accs, want_acc, rtol=1e-4)
    for k in ("val_loss", "test_acc_mean", "test_acc_std"):
        assert _close(getattr(res, k), getattr(jres, k)), k
    assert res.val_losses[0, -1] != res.val_losses[0, 0]


def test_cv_draws_fresh_weights_and_optimizer_per_fold(monkeypatch,
                                                       tu_graphs):
    """Each fold's model starts from a fresh draw of its own seed (seed +
    fold), never from the previous fold's trained weights, and gets a
    new Adam with no state."""
    tg, _ = tu_graphs
    starts, opts = [], []
    fold_model = cv.fold_model
    make_step = cv.make_pool_train_step

    def recording_fold_model(factory, seed):
        m = fold_model(factory, seed)
        starts.append((seed, {k: v.clone()
                              for k, v in m.state_dict().items()}))
        return m

    def recording_step(model, opt, *args):
        opts.append((opt, len(opt.state)))
        return make_step(model, opt, *args)

    monkeypatch.setattr(cv, "fold_model", recording_fold_model)
    monkeypatch.setattr(cv, "make_pool_train_step", recording_step)

    def factory(g):
        return get_model("BaselineGNN", conv="gin", hidden=8,
                         num_layers=2, out_dim=2, in_dim=tg[0].x.shape[1],
                         device="cpu", generator=g)

    cv.cross_validation_with_val_set(tg, factory, folds=3, epochs=2,
                                     batch_size=16, seed=5, device="cpu")
    assert [s for s, _ in starts] == [5, 6, 7]
    for seed, state in starts:
        fresh = factory(torch.Generator().manual_seed(seed)).state_dict()
        for k, v in fresh.items():
            assert torch.equal(state[k], v), (seed, k)
    assert not torch.equal(starts[0][1]["lin1.weight"],
                           starts[1][1]["lin1.weight"])
    assert len({id(o) for o, _ in opts}) == 3
    assert all(n == 0 for _, n in opts)


def _cycle_case(mode, tg, jg):
    """(port graph(s), JAX graph(s), per-node cycle counts): the graphs
    for reg_gc, their disjoint union for the single-graph trainers."""
    cyc = [count_cycles_per_node(g.num_nodes, g.edge_index).astype(
        np.float32) for g in tg]
    if mode == "reg_gc":
        return tg, jg, cyc
    return (graph.disjoint_union(tg), j_graph.disjoint_union(jg),
            np.concatenate(cyc))


@pytest.mark.parametrize("mode,multi_layer", [
    ("class", False), ("reg", True), ("reg_gc", True)])
def test_cycle_trainers_equal_jax_on_its_init(monkeypatch, mode,
                                              multi_layer, tu_graphs):
    """Two epochs of each trainer (BaselineGNN gin0 16 x 2 node-level with
    JK, dropout 0; deep supervision in the regression modes) from JAX's
    init: every epoch's loss and val/test metric, and the metric tuple at
    the best epoch, at rel 1e-4.

    Under `class` the AP is held through the logits it is computed from:
    each eval's logits equal JAX's at 1e-5 and the port's metrics equal
    JAX's (sklearn's) on the port's logits to 1e-12. Its ~400 test nodes
    hold logits ~1e-3 apart, and pairs closer than the packages' f32
    rounding (2e-6) rank in another order, which moves the AP by ~1e-3."""
    tg, jg = tu_graphs
    if mode == "class":
        seen = {"jax": [], "port": []}
        jcls, tcls = j_cycles._cls_metrics, cycles._cls_metrics

        def recording(which, fn):
            def metrics(true, logits):
                seen[which].append((true, logits))
                return fn(true, logits)

            return metrics

        monkeypatch.setattr(j_cycles, "_cls_metrics", recording("jax", jcls))
        monkeypatch.setattr(cycles, "_cls_metrics", recording("port", tcls))
    t_in, j_in, cyc = _cycle_case(mode, tg, jg)
    fields = dict(conv="gin0", hidden=HIDDEN, num_layers=LAYERS,
                  out_dim=4, classify=False, node_level=True, jk=True,
                  multi_layer=multi_layer, dropout=0.0)
    inits = []
    jmodel = _Capturing(j_models.get_model("BaselineGNN", **fields), inits)
    # lr 1e-3: the evals read the running statistics (see the CV test)
    kw = dict(epochs=2, lr=1e-3, lr_decay_step_size=1, weight_decay=1e-4,
              seed=3)
    j_fn = {"class": j_cycles.train_val_cycles,
            "reg": j_cycles.train_val_cycles_regression,
            "reg_gc": j_cycles.train_val_cycles_regression_GC}[mode]
    t_fn = {"class": cycles.train_val_cycles,
            "reg": cycles.train_val_cycles_regression,
            "reg_gc": cycles.train_val_cycles_regression_GC}[mode]
    extra = dict(batch_size=16) if mode == "reg_gc" else {}
    jres = j_fn(j_in, cyc, jmodel, **kw, **extra)
    in_dim = tg[0].x.shape[1]
    model = _load(get_model("BaselineGNN", **fields, in_dim=in_dim,
                            device="cpu"), inits[0])
    res = t_fn(t_in, cyc, model, **kw, **extra)
    assert len(res.history) == len(jres.history) == 2
    for a, b in zip(res.history, jres.history):
        assert set(a) == set(b)
        for k in a:
            if mode != "class" or k in ("epoch", "train_loss"):
                assert _close(a[k], b[k]), (k, res.history, jres.history)
    if mode == "class":
        assert len(seen["jax"]) == len(seen["port"]) == 4
        for (jt, jl), (tt, tl) in zip(seen["jax"], seen["port"]):
            np.testing.assert_array_equal(tt, jt)
            np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
            for a, b in zip(tcls(tt, tl), jcls(tt, tl)):
                assert (math.isnan(a) and math.isnan(b)) or abs(
                    a - b) < 1e-12
        assert res.history[-1]["train_loss"] < res.history[0]["train_loss"]
        return
    for a, b in zip(res.test_metrics, jres.test_metrics):
        assert _close(a, b), (res.test_metrics, jres.test_metrics)
    assert _close(res.best_val, jres.best_val)


def test_single_graph_refuses_short_labels():
    g = tu.synthetic_tu(num_graphs=1)[0]
    model = get_model("BaselineGNN", conv="gin0", hidden=8, num_layers=2,
                      out_dim=2, classify=False, node_level=True,
                      in_dim=g.x.shape[1], device="cpu")
    with pytest.raises(ValueError, match="real rows"):
        cycles.train_val_cycles(g, np.zeros((g.num_nodes + 3, 2)), model,
                                epochs=1)


# ---------------------------------------------------------------------------
# the run_tu twin against the JAX run_tu.py main
# ---------------------------------------------------------------------------

ARGS = ["--dataset", "NONE", "--hidden", str(HIDDEN), "--layers",
        str(LAYERS), "--epochs", "3", "--batch_size", "32"]
NUMBER = re.compile(r"-?\d+\.(\d+)(?:e(-?\d+))?")


def _log_numbers(res_dir):
    """(first word, [(value, one unit of its last printed digit)]) of each
    log.txt line; the result line's duration_s (its last number) left
    out."""
    out = []
    for ln in open(os.path.join(res_dir, "log.txt")).read().splitlines():
        nums = [(float(m.group(0)), 10.0 ** (-len(m.group(1))
                                             + int(m.group(2) or 0)))
                for m in NUMBER.finditer(ln)]
        out.append((ln.split(" ")[0], nums[:-1] if ln.startswith("{")
                    else nums))
    return out


def _run_jax_main(monkeypatch, flags, res_dir):
    """The JAX run_tu.py main with dropout 0 in its models; returns the
    flax variables of every init."""
    mod = load_jax_driver("run_tu")
    inits = []
    get = j_models.get_model

    def get_capturing(name, **kw):
        if name == "BaselineGNN":
            kw["dropout"] = 0.0
        return _Capturing(get(name, **kw), inits)

    monkeypatch.setattr(mod, "get_model", get_capturing)
    monkeypatch.setattr(j_models, "get_model", get_capturing)
    monkeypatch.setattr(sys, "argv", [os.path.join(REPO, "run_tu.py"),
                                      *flags, "--res_dir", str(res_dir)])
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main()
    monkeypatch.undo()
    return inits


@pytest.mark.parametrize("extra", [
    ["--folds", "3", "--weight_decay", "1e-3", "--lr_decay_step_size", "2",
     "--lr", "1e-4"],
    ["--use_cycle", "reg_gc", "--multi_layer", "--dropout", "0", "--lr",
     "1e-4"],
])
def test_main_equals_jax_main(monkeypatch, tmp_path, extra):
    """run_tu.main's log.txt lines (each fold's best val loss and test
    accuracy and the summary; or each cycle epoch and the result) equal
    the JAX main's on its init at rel 1e-4 (or one unit of the printed
    last digit), on the synthetic TU set, at lr 1e-4 (see
    test_cv_equals_jax_on_its_init)."""
    flags = ARGS + extra + ["--data_dir", str(tmp_path / "TU")]
    inits = _run_jax_main(monkeypatch, flags, tmp_path / "jres")
    if "--use_cycle" in extra:
        build = run_tu.cycle_model
        monkeypatch.setattr(run_tu, "cycle_model", lambda *a: _load(
            build(*a), inits[0]))
    else:
        monkeypatch.setattr(cv, "fold_model", lambda factory, seed: _load(
            factory(torch.Generator()), inits[seed]))
        monkeypatch.setattr(run_tu, "cv_model_factory", _no_dropout(
            run_tu.cv_model_factory))
    out = run_tu.main(flags + ["--device", "cpu", "--res_dir",
                               str(tmp_path / "tres")])
    want = _log_numbers(tmp_path / "jres")
    got = _log_numbers(tmp_path / "tres")
    assert len(got) == len(want) >= 4
    for (wk, wv), (gk, gv) in zip(want, got):
        assert wk == gk and len(wv) == len(gv) >= 2, (want, got)
        for (a, unit), (b, _) in zip(gv, wv):
            # rel 1e-4, or one unit of the line's last printed digit
            assert abs(a - b) <= max(1e-4 * abs(b), unit) * (1 + 1e-9), (
                want, got)
    assert os.path.exists(os.path.join(out["res_dir"], "result.json"))
    assert os.path.exists(os.path.join(out["res_dir"], "config.json"))


def _no_dropout(factory_of):
    """`cv_model_factory` whose BaselineGNN has dropout 0 (the JAX run
    above is patched the same way)."""

    def patched(args, num_classes, in_dim, device):
        def factory(generator):
            return get_model(
                "BaselineGNN", conv=args.conv, hidden=args.hidden,
                num_layers=args.layers, out_dim=num_classes,
                pool=args.pool, nested=args.nested, in_dim=in_dim,
                dropout=0.0, device=device, generator=generator)

        return factory

    return patched


def test_flags_and_defaults_are_the_jax_drivers(monkeypatch):
    """Every flag of the JAX run_tu.py with its default, type and
    choices, plus `--device` (default cuda)."""
    import argparse

    class Stop(Exception):
        pass

    def capture(self, *args, **kwargs):
        raise Stop(self)

    mod = load_jax_driver("run_tu")
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Stop) as stop:
        mod.main()
    monkeypatch.undo()
    jparser = stop.value.args[0]
    parser = run_tu.build_parser()

    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         a.choices, a.nargs)
                for a in p._actions if a.dest != "help"}

    want = flags(jparser)
    got = flags(parser)
    assert got.pop("device")[1] == "cuda"
    assert got == want


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot run")


def test_main_defaults_to_cuda_and_refuses_planetoid_cv(no_card, tmp_path):
    """Without `--device`, main raises before it writes anything; the
    Planetoid graphs need a cycle mode (argparse error, nothing
    written)."""
    with pytest.raises(RuntimeError, match="cuda"):
        run_tu.main(["--res_dir", str(tmp_path / "res"), "--data_dir",
                     str(tmp_path / "TU")])
    with pytest.raises(SystemExit):
        run_tu.main(["--dataset", "Cora", "--device", "cpu", "--res_dir",
                     str(tmp_path / "res")])
    assert os.listdir(tmp_path) == []
