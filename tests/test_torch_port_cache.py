"""The port's featurization cache, process pool and ZINC pickle reader
against the JAX package, on the CPU.

A cache written by either package is read by the other, bit for bit,
under the same file name; `featurize_many` across processes equals the
in-process result; the reference's ZINC artifact (a tiny pickle written
here in its format) parses as JAX parses it.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from escgnn_tpu.data.container import GraphData as JGraphData
from escgnn_tpu.data.molecules import load_zinc_pickle as j_load_zinc_pickle
from escgnn_tpu.data.molecules import synthetic_zinc as j_synthetic_zinc
from escgnn_tpu.data.molecules import zinc_splits as j_zinc_splits
from escgnn_tpu.featurize.cache import cached_featurize as j_cached_featurize
from escgnn_tpu.featurize.cache import load_graphs as j_load_graphs
from escgnn_tpu.featurize.cache import save_graphs as j_save_graphs
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.data.molecules import load_zinc_pickle, synthetic_zinc
from escgnn_tpu_torch.data.molecules import zinc_splits
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.featurize.cache import (
    cache_path,
    cached_featurize,
    load_graphs,
    save_graphs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIELDS = ("edge_index", "x", "edge_attr", "y", "pos", "enc_idx", "enc_cnt",
           "enc_offsets")


def _assert_same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_same_graphs(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.num_nodes == w.num_nodes
        for f in _FIELDS:
            _assert_same(getattr(g, f), getattr(w, f), f"graph {i} {f}")
        assert (g.extras is None) == (w.extras is None)
        for k in (w.extras or {}):
            if isinstance(w.extras[k], int):
                assert g.extras[k] == w.extras[k] and isinstance(
                    g.extras[k], int), k
            else:
                _assert_same(g.extras[k], w.extras[k], f"graph {i} extra {k}")


def _with_extras(graphs, cls):
    """The featurized graphs again as `cls`, with a node-aligned array, a
    dense matrix and an int scalar in `extras` (the v2 format's part)."""
    rng = np.random.default_rng(5)
    out = []
    for g in graphs:
        n = g.num_nodes
        out.append(cls(
            num_nodes=n, edge_index=g.edge_index, x=g.x,
            edge_attr=g.edge_attr, y=g.y,
            pos=rng.normal(size=(n, 3)).astype(np.float32),
            enc_idx=g.enc_idx, enc_cnt=g.enc_cnt, enc_offsets=g.enc_offsets,
            extras={"node_feat": rng.normal(size=(n, 2)).astype(np.float32),
                    "adj": rng.integers(0, 3, (n, n)).astype(np.int32),
                    "num_hops": int(rng.integers(1, 5))}))
    return out


@pytest.fixture(scope="module")
def zinc_pair():
    return (j_featurize_many(j_synthetic_zinc(6, seed=11), JEscConfig(h=3)),
            featurize_many(synthetic_zinc(6, seed=11), EscConfig(h=3)))


@pytest.mark.parametrize("extras", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_bit_equal_across_packages(zinc_pair, tmp_path, writer, extras):
    """save_graphs of one package -> load_graphs of the other: every field,
    enc_offsets and extras bit-equal (dtype included)."""
    jg, tg = zinc_pair
    if extras:
        jg, tg = _with_extras(jg, JGraphData), _with_extras(tg, GraphData)
    path = str(tmp_path / "split.v2.npz")
    if writer == "jax":
        j_save_graphs(path, jg)
        got, want = load_graphs(path), j_load_graphs(path)
    else:
        save_graphs(path, tg)
        got, want = j_load_graphs(path), load_graphs(path)
    _assert_same_graphs(got, want)
    _assert_same_graphs(load_graphs(path), tg if writer == "port" else jg)
    assert os.listdir(tmp_path) == ["split.v2.npz"]  # no tmp file left


def test_cached_featurize_same_file_name_and_hit(tmp_path):
    """Both packages' cached_featurize name the file alike, each reads the
    other's, and a hit never calls the build function."""
    cfg, jcfg = EscConfig(h=2), JEscConfig(h=2)
    assert cfg.cache_key() == jcfg.cache_key() == "esc_h2_rd_sl"
    for c, j in ((EscConfig(h=3, use_rd=False), JEscConfig(h=3, use_rd=False)),
                 (EscConfig(self_loop=False), JEscConfig(self_loop=False))):
        assert c.cache_key() == j.cache_key()
    name = f"train_n4_s0_{cfg.cache_key()}"
    built = featurize_many(synthetic_zinc(4, seed=2), cfg)
    got = cached_featurize(str(tmp_path), name, lambda: built)
    assert os.listdir(tmp_path) == [os.path.basename(
        cache_path(str(tmp_path), name))] == [f"{name}.v2.npz"]

    def must_not_build():
        raise AssertionError("a cache hit called the build function")

    jgot = j_cached_featurize(str(tmp_path), name, must_not_build)
    _assert_same_graphs(got, built)
    _assert_same_graphs(cached_featurize(str(tmp_path), name, must_not_build),
                        jgot)


def test_cached_featurize_sweeps_stale_tmp_files(tmp_path):
    """A miss deletes tmp files of writers that died over an hour ago and
    leaves a fresh one (a live writer's) alone."""
    name = "val"
    path = cache_path(str(tmp_path), name)
    stale, live = f"{path}.tmp.111.npz", f"{path}.tmp.222.npz"
    for p in (stale, live):
        open(p, "wb").close()
    old = os.path.getmtime(stale) - 7200
    os.utime(stale, (old, old))
    cached_featurize(str(tmp_path), name,
                     lambda: featurize_many(synthetic_zinc(2), EscConfig(h=2)))
    assert not os.path.exists(stale)
    assert os.path.exists(live) and os.path.exists(path)


_POOL_RUN = r"""
import pickle, sys
import numpy as np
import torch
from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.data.molecules import synthetic_zinc
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
# a graph big enough (1440 encoded edges) for the native core's OpenMP team
rng = np.random.default_rng(0)
upper = np.triu(rng.random((160, 160)) < 0.05, k=1)
a, b = np.nonzero(upper | upper.T)
graphs = synthetic_zinc(20, seed=6) + [
    GraphData(num_nodes=160, edge_index=np.stack([a, b]).astype(np.int32))]
cfg = EscConfig(h=2)
torch.randn(256, 256) @ torch.randn(256, 256)  # torch's team runs first
serial = featurize_many(graphs, cfg, num_workers=0)  # and the core's
pooled = featurize_many(graphs, cfg, num_workers=2)
with open(sys.argv[1], "wb") as f:
    pickle.dump((serial, pooled), f)
"""


def test_featurize_many_process_pool_equals_in_process(tmp_path):
    """num_workers=2 (forked workers, after the parent has run OpenMP
    teams in torch and in the native core) gives the in-process result,
    in order. The pool runs in its own interpreter under a 120 s timeout,
    so a hang fails the test instead of stalling the run."""
    out = tmp_path / "graphs.pkl"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _POOL_RUN, str(out)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    with open(out, "rb") as f:
        serial, pooled = pickle.load(f)
    assert len(serial) == 21 and serial[-1].num_edges >= 1024
    _assert_same_graphs(pooled, serial)
    _assert_same_graphs(serial[:20], featurize_many(
        synthetic_zinc(20, seed=6), EscConfig(h=2)))


def _reference_zinc_pickle(path):
    """(train, val, test) lists of {'x', 'A', 'y'} dicts in the reference's
    layout: x one-hot (n, 28), A (4, n, n) one-hot bond types with zeros
    off the bonds, y a (1,) target."""
    rng = np.random.default_rng(3)
    splits = []
    for k in (3, 2, 2):
        raw = []
        for _ in range(k):
            n = int(rng.integers(5, 9))
            x = np.eye(28, dtype=np.float32)[rng.integers(0, 28, n)]
            A = np.zeros((4, n, n), np.float32)
            for a in range(n - 1):
                t = int(rng.integers(0, 4))
                A[t, a, a + 1] = A[t, a + 1, a] = 1.0
            raw.append({"x": x, "A": A,
                        "y": rng.normal(size=(1,)).astype(np.float32)})
        splits.append(raw)
    with open(path, "wb") as f:
        pickle.dump(tuple(splits), f)


def test_load_zinc_pickle_and_splits_equal_jax(tmp_path):
    """load_zinc_pickle on a test-written reference pickle equals JAX's;
    zinc_splits finds it under <data_dir>/ZINC.pkl (is_real) as JAX's
    does."""
    path = tmp_path / "ZINC.pkl"
    _reference_zinc_pickle(path)
    got, want = load_zinc_pickle(str(path)), j_load_zinc_pickle(str(path))
    assert set(got) == set(want) == {"train", "val", "test"}
    for name in want:
        _assert_same_graphs(got[name], want[name])
    splits, is_real = zinc_splits(str(tmp_path), num_graphs=10, seed=0)
    jsplits, j_real = j_zinc_splits(str(tmp_path), num_graphs=10, seed=0)
    assert is_real and j_real
    for name in jsplits:
        _assert_same_graphs(splits[name], jsplits[name])
