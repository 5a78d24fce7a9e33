"""The OGB driver twin `escgnn_tpu_torch.run_ogb_mol` and its data, on
the CPU.

  * The synthetic ogbg-mol and ogbg-ppa generators, their splits, the
    return-probability features and the batches that carry them are
    bit-equal to the JAX package's on the same seeds; the raw-directory
    reader gives the JAX reader's graphs on a directory the test writes.
  * The twin's `main()` at a tiny size with `--device cpu`: its log,
    checkpoints, `--continue_from`, `--ensemble_eval`, `--dump_worst`,
    ogbg-ppa's cross-entropy and accuracy; the unported models raise
    with their ROADMAP queue.
  * At `--drop_ratio 0` the twin tracks the JAX `run_ogb_mol.py` main,
    run in this process on the same data with its flax init carried into
    the twin: per-epoch loss and val ROC-AUC at rel 1e-4 over 2 epochs.
"""

import gzip
import json
import math
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from escgnn_tpu.data import molecules as jmol
from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.rw import attach_return_prob as j_attach_rp
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu_torch import run_ogb_mol
from escgnn_tpu_torch.data import molecules as tmol
from escgnn_tpu_torch.data.batching import BatchSpec, batch_arrays
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.featurize.rw import attach_return_prob
from escgnn_tpu_torch.weights import load_flax_variables
from tests.test_torch_port_driver_parity import load_jax_driver

TINY = ["--num_graphs", "60", "--emb_dim", "16", "--num_layer", "2",
        "--batch_size", "8", "--num_workers", "0", "--device", "cpu"]
LINE = re.compile(r"epoch (\d{3}) loss (\S+) val (\S+) (\S+)")
FIELDS = ("num_nodes", "edge_index", "x", "edge_attr", "y")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_graphs(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in FIELDS:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert set(a.extras or {}) == set(b.extras or {})
        for k in a.extras or {}:
            np.testing.assert_array_equal(a.extras[k], b.extras[k])


@pytest.mark.parametrize("case", [
    ("synthetic_ogb_mol", dict(num_graphs=30, seed=3)),
    ("synthetic_ogb_mol", dict(num_graphs=30, seed=4, num_tasks=5,
                               nan_frac=0.3, label_kind="tri")),
    ("synthetic_ppa", dict(num_graphs=12, seed=2)),
])
def test_generators_bit_equal(case):
    name, kw = case
    _same_graphs(getattr(tmol, name)(**kw), getattr(jmol, name)(**kw))


def test_splits_bit_equal(tmp_path):
    """ppa_splits and the synthetic branch of ogb_mol_splits."""
    got, real_t = tmol.ppa_splits(str(tmp_path), num_graphs=20, seed=1)
    want, real_j = jmol.ppa_splits(str(tmp_path), num_graphs=20, seed=1)
    assert real_t is real_j is False
    for k in want:
        _same_graphs(got[k], want[k])
    kw = dict(num_graphs=20, seed=2, num_tasks=3, label_kind="tri")
    got, real_t = tmol.ogb_mol_splits(str(tmp_path), "ogbg-molpcba", **kw)
    want, real_j = jmol.ogb_mol_splits(str(tmp_path), "ogbg-molpcba", **kw)
    assert real_t is real_j is False
    for k in want:
        _same_graphs(got[k], want[k])


def test_return_prob_and_its_batch_bit_equal():
    """attach_return_prob, then the featurized graphs and the padded
    uniform/dedup batch with the 'rp' node extra, equal JAX's."""
    raw_t = [attach_return_prob(g, 6)
             for g in tmol.synthetic_ogb_mol(8, seed=5)]
    raw_j = [j_attach_rp(g, 6) for g in jmol.synthetic_ogb_mol(8, seed=5)]
    _same_graphs(raw_t, raw_j)
    tg = featurize_many(raw_t, EscConfig(h=2, use_rd=True, self_loop=True))
    jg = j_featurize_many(raw_j, JEscConfig(h=2, use_rd=True, self_loop=True))
    got = batch_arrays(tg[:4], BatchSpec.uniform(tg, 4, enc_layout="dedup"))
    want = j_pad_and_batch(jg[:4], JBatchSpec.uniform(jg, 4,
                                                     enc_layout="dedup"))
    np.testing.assert_array_equal(got["extras.rp"], want.extras["rp"])
    np.testing.assert_array_equal(got["y"], want.y)
    np.testing.assert_array_equal(got["edge_attr"], want.edge_attr)


def _write_raw_dir(root, rng):
    """A 6-graph OGB raw directory: int node and edge features, 2 label
    columns with empty fields (unlabeled), a scaffold split."""
    raw, split = root / "raw", root / "split" / "scaffold"
    raw.mkdir(parents=True)
    split.mkdir(parents=True)
    n_nodes = rng.integers(3, 7, 6)
    edges, n_edges = [], []
    for n in n_nodes:
        a = np.arange(n - 1)
        ei = np.concatenate([np.stack([a, a + 1]), np.stack([a + 1, a])], 1)
        edges.append(ei.T)
        n_edges.append(ei.shape[1])

    def put(path, rows):
        with gzip.open(path, "wt") as f:
            for r in rows:
                f.write(",".join(str(v) for v in r) + "\n")

    put(raw / "num-node-list.csv.gz", [[n] for n in n_nodes])
    put(raw / "num-edge-list.csv.gz", [[e] for e in n_edges])
    put(raw / "edge.csv.gz", np.concatenate(edges).tolist())
    put(raw / "node-feat.csv.gz",
        rng.integers(0, 5, (int(n_nodes.sum()), 9)).tolist())
    put(raw / "edge-feat.csv.gz",
        rng.integers(0, 2, (int(sum(n_edges)), 3)).tolist())
    labels = [[int(rng.integers(0, 2)), "" if g % 3 == 0 else 1]
              for g in range(6)]
    put(raw / "graph-label.csv.gz", labels)
    for name, idx in (("train", [0, 1, 2]), ("valid", [3]),
                      ("test", [4, 5])):
        put(split / f"{name}.csv.gz", [[i] for i in idx])


def test_load_ogb_graph_dir(tmp_path):
    """The raw reader on a directory written here gives the JAX reader's
    graphs (empty label fields read as NaN), and ogb_mol_splits finds it
    and refuses a --num_tasks other than the labels' width."""
    root = tmp_path / "ogbg_moltoy"
    _write_raw_dir(root, np.random.default_rng(0))
    got = tmol.load_ogb_graph_dir(str(root))
    want = jmol.load_ogb_graph_dir(str(root))
    for k in ("train", "val", "test"):
        _same_graphs(got[k], want[k])
    assert np.isnan(got["train"][0].y[1]) and not np.isnan(
        got["train"][1].y[1])
    splits, real = tmol.ogb_mol_splits(str(tmp_path), "ogbg-moltoy",
                                       num_tasks=2)
    assert real and [len(splits[k]) for k in ("train", "val", "test")] == [
        3, 1, 2]
    with pytest.raises(ValueError, match="num_tasks 1"):
        tmol.ogb_mol_splits(str(tmp_path), "ogbg-moltoy", num_tasks=1)


def test_main_logs_checkpoints_resumes_and_ensembles(tmp_path):
    """3 epochs with a checkpoint each epoch, the ensemble over the saved
    checkpoints and the 4 worst test graphs; then a resume from epoch 2
    runs epoch 3 only, from the saved weights."""
    res = tmp_path / "res"
    argv = TINY + ["--epochs", "3", "--log_steps", "1", "--synth_label",
                   "tri", "--ensemble_eval", "--dump_worst", "4",
                   "--data_dir", str(tmp_path / "data"), "--res_dir",
                   str(res)]
    out = run_ogb_mol.main(argv)
    lines = (res / "log.txt").read_text().splitlines()
    assert len(lines) == 3 and all(ln.endswith("s)") for ln in lines)
    assert all("[ckpt]" in ln for ln in lines) and "*" in lines[0]
    assert [e["epoch"] for e in out["epochs"]] == [1, 2, 3]
    assert all(e["steps"] == 6 for e in out["epochs"])
    assert all(math.isfinite(e["loss"]) for e in out["epochs"])
    assert 0.0 <= out["best_val"] <= 1.0 and 0.0 <= out["ensemble"] <= 1.0
    assert sorted(os.listdir(res / "ckpt")) == ["1.pt", "2.pt", "3.pt"]
    worst = json.loads((res / "worst.json").read_text())
    assert len(worst) == 4
    assert [w["loss"] for w in worst] == sorted(
        (w["loss"] for w in worst), reverse=True)
    assert os.path.exists(res / "config.json")

    resumed = run_ogb_mol.main(argv[:argv.index("--ensemble_eval")]
                               + ["--continue_from", "2", "--data_dir",
                                  str(tmp_path / "data"), "--res_dir",
                                  str(res)])
    assert [e["epoch"] for e in resumed["epochs"]] == [3]
    assert math.isfinite(resumed["epochs"][0]["loss"])


def test_main_ppa_and_ragged(tmp_path):
    """ogbg-ppa: 37 classes through cross-entropy, scored by accuracy;
    and the ragged layout (segment aggregation, width encoding) with
    return probabilities and set2set pooling."""
    out = run_ogb_mol.main(TINY + [
        "--dataset", "ogbg-ppa", "--epochs", "1", "--data_dir",
        str(tmp_path / "d"), "--res_dir", str(tmp_path / "ppa")])
    assert out["metric"] == "acc" and 0.0 <= out["best_val"] <= 1.0
    assert math.isfinite(out["epochs"][0]["loss"])
    out = run_ogb_mol.main(TINY + [
        "--layout", "ragged", "--use_rp", "4", "--graph_pooling", "set2set",
        "--epochs", "1", "--data_dir", str(tmp_path / "d"), "--res_dir",
        str(tmp_path / "ragged")])
    assert out["spec"].uniform_nodes == 0 and out["spec"].enc_width > 0
    assert math.isfinite(out["epochs"][0]["loss"])


@pytest.mark.parametrize("flags,exc,match", [
    (["--model", "GINEPlus"], NotImplementedError, "8.5"),
    (["--dataset", "ogbg-ppa", "--dump_worst", "3"], ValueError,
     "dump_worst"),
])
def test_unported_flags_raise(tmp_path, flags, exc, match):
    with pytest.raises(exc, match=match):
        run_ogb_mol.main(TINY + flags + ["--res_dir", str(tmp_path)])


def test_default_device_needs_a_card(tmp_path):
    """Without a card the default device raises; nothing runs on the CPU
    unless it is named."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        run_ogb_mol.main(argv + ["--res_dir", str(tmp_path)])


def _epochs(res_dir):
    lines = (res_dir / "log.txt").read_text().splitlines()
    return [(float(m.group(2)), float(m.group(4)))
            for m in map(LINE.match, lines) if m]


def test_twin_tracks_the_jax_driver(monkeypatch, tmp_path):
    """`--drop_ratio 0`, 2 epochs of 6 steps: the JAX main runs in this
    process (sys.argv patched), its flax init is captured and loaded into
    the twin's model; both log lines' loss and val ROC-AUC agree at rel
    1e-4 (or 1e-5 absolute, one unit of the lines' fifth decimal)."""
    flags = [a for a in TINY if a not in ("--device", "cpu")] + [
        "--epochs", "2", "--drop_ratio", "0", "--synth_label", "tri"]
    mod = load_jax_driver("run_ogb_mol")
    captured = {}

    class Capturing(mod.OgbGNN):
        def init(self, *args, **kwargs):
            variables = super().init(*args, **kwargs)
            captured["variables"] = jax.tree.map(np.array, variables)
            return variables

    monkeypatch.setattr(mod, "OgbGNN", Capturing)
    monkeypatch.setattr(sys, "argv", ["run_ogb_mol.py", *flags,
                                      "--data_dir", str(tmp_path / "jd"),
                                      "--res_dir", str(tmp_path / "jres")])
    mod.main()
    variables = captured["variables"]
    build = run_ogb_mol.build_model

    def build_with_jax_init(*args, **kwargs):
        model = build(*args, **kwargs)
        load_flax_variables(model, variables["params"],
                            variables["batch_stats"])
        return model

    monkeypatch.setattr(run_ogb_mol, "build_model", build_with_jax_init)
    out = run_ogb_mol.main(flags + ["--device", "cpu", "--data_dir",
                                    str(tmp_path / "td"), "--res_dir",
                                    str(tmp_path / "tres")])
    want, got = _epochs(tmp_path / "jres"), _epochs(tmp_path / "tres")
    assert len(want) == len(got) == 2
    for (jl, jv), (tl, tv), e in zip(want, got, out["epochs"]):
        assert math.isclose(tl, jl, rel_tol=1e-4, abs_tol=1e-5), (got, want)
        assert math.isclose(tv, jv, rel_tol=1e-4, abs_tol=1e-5), (got, want)
        assert f"{e['loss']:.5f}" == f"{tl:.5f}"
    assert want[-1][0] != want[0][0]
