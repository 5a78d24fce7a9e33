"""The GPS slice's data path against the JAX package, on the CPU: the
sampled BFS and `max_nodes_per_hop`, the SPD bias, the positional
encodings, the AQSOL / PCQM4Mv2 / contact / ogbl datasets, the batcher's
`attn_bias` and link-pair fields on both layouts, the config module
(against `escgnn_tpu.config`, which reads YAML through PyYAML), and the
link loss and ranking metrics. Inputs come from numpy seeds; every
array must be bit-equal.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import escgnn_tpu.config as jconfig
from escgnn_tpu.data import contact as jcontact
from escgnn_tpu.data import molecules as jmol
from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.container import GraphData as JGraphData
from escgnn_tpu.featurize import bfs as jbfs
from escgnn_tpu.featurize import posenc as jposenc
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.spd import attach_attn_bias as j_attach_attn_bias
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu.train import metrics as jmetrics
from escgnn_tpu_torch import config
from escgnn_tpu_torch.data import contact, molecules
from escgnn_tpu_torch.data.batching import BatchSpec, batch_arrays, pad_and_batch
from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.featurize import bfs, posenc
from escgnn_tpu_torch.featurize.escgnn import EscConfig
from escgnn_tpu_torch.featurize.spd import SPD_CAP, attach_attn_bias
from escgnn_tpu_torch.featurize.transform import featurize_many
from escgnn_tpu_torch.train import metrics
from tests.conftest import random_graph
from tests.test_torch_port_qm9 import _assert_graphs_equal, _jax_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "gps", "*.yaml")))


def _graphs(cls, num=6, seed=0, max_n=14):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        n, ei = random_graph(rng, max_n=max_n)
        out.append(cls(num_nodes=n, edge_index=ei,
                       x=rng.integers(0, 20, n).astype(np.int32)[:, None],
                       edge_attr=rng.integers(1, 4, ei.shape[1]).astype(
                           np.int32),
                       y=rng.normal(size=(1,)).astype(np.float32)))
    return out


@pytest.mark.parametrize("cap", [1, 2, 4])
def test_sampled_hop_distance_matrix_bit_equal(cap):
    """The per-hop frontier subsample (derived per (seed, root, hop))
    gives JAX's matrix on graphs with frontiers above the cap."""
    rng = np.random.default_rng(cap)
    for seed in range(4):
        n, ei = random_graph(rng, max_n=20)
        want = jbfs.sampled_hop_distance_matrix(n, ei, 3, cap, seed)
        got = bfs.sampled_hop_distance_matrix(n, ei, 3, cap, seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_max_nodes_per_hop_featurization_bit_equal():
    """`EscConfig.max_nodes_per_hop`: the cache key (`_mnph<n>` suffix)
    and the sampled encodings are JAX's, and sampling changes them."""
    jcfg = JEscConfig(h=3, max_nodes_per_hop=2)
    cfg = EscConfig(h=3, max_nodes_per_hop=2)
    assert cfg.cache_key() == jcfg.cache_key() == "esc_h3_rd_sl_mnph2"
    assert EscConfig(h=3).cache_key() == JEscConfig(h=3).cache_key()
    got = featurize_many(_graphs(GraphData, max_n=18), cfg)
    want = j_featurize_many(_graphs(JGraphData, max_n=18), jcfg)
    _assert_graphs_equal(got, want)
    full = featurize_many(_graphs(GraphData, max_n=18), EscConfig(h=3))
    assert any(not np.array_equal(a.enc_cnt, b.enc_cnt)
               for a, b in zip(got, full))


def test_attn_bias_and_posenc_bit_equal():
    """SPD bias (cap 100, unreachable = 101), LapPE with its sign rule and
    eigenvalues, RWSE, degree, the heat-kernel diagonal and the
    electrostatic encoding equal JAX's on disconnected random graphs."""
    assert SPD_CAP == 100
    for g, jg in zip(_graphs(GraphData, seed=3), _graphs(JGraphData, seed=3)):
        a, b = attach_attn_bias(g), j_attach_attn_bias(jg)
        assert a.extras["attn_bias"].dtype == np.int16
        np.testing.assert_array_equal(a.extras["attn_bias"],
                                      b.extras["attn_bias"])
        for name, kw in (("attach_lap_pe", dict(k=5)),
                         ("attach_rwse", dict(k=6)),
                         ("attach_degree", {}),
                         ("attach_heat_kernel_diag", {}),
                         ("attach_electrostatic", {})):
            ta = getattr(posenc, name)(a, **kw)
            tb = getattr(jposenc, name)(b, **kw)
            assert set(ta.extras) == set(tb.extras)
            for k in ta.extras:
                assert ta.extras[k].dtype == tb.extras[k].dtype, k
                np.testing.assert_array_equal(ta.extras[k], tb.extras[k],
                                              err_msg=k)


@pytest.mark.parametrize("name", ["aqsol", "pcqm4mv2", "contact", "ogbl"])
def test_gps_datasets_bit_equal(tmp_path, name):
    """The synthetic AQSOL, PCQM4Mv2 (subset, full, inference), contact
    (shuffle, num-atoms) and ogbl splits equal JAX's."""
    d = str(tmp_path)
    if name == "aqsol":
        cases = [(molecules.aqsol_splits(d, 40, 1),
                  jmol.aqsol_splits(d, 40, 1))]
    elif name == "pcqm4mv2":
        cases = [(molecules.pcqm4mv2_splits(d, s, 60, 2),
                  jmol.pcqm4mv2_splits(d, s, 60, 2))
                 for s in ("subset", "full", "inference")]
    elif name == "contact":
        cases = [(contact.contact_splits(d, s, 30, 3),
                  jcontact.contact_splits(d, s, 30, 3))
                 for s in ("shuffle", "num-atoms")]
    else:
        cases = [(contact.ogbl_splits(d, "ogbl-collab", 120, 4),
                  jcontact.ogbl_splits(d, "ogbl-collab", 120, 4))]
    for (got, real), (want, jreal) in cases:
        assert real is jreal is False
        assert set(got) == set(want)
        for split in got:
            _assert_graphs_equal(got[split], want[split])
            for a, b in zip(got[split], want[split]):
                for k in a.extras or {}:
                    np.testing.assert_array_equal(a.extras[k], b.extras[k])


@pytest.mark.parametrize("layout", ["width", "uniform_dedup"])
def test_attn_bias_and_pairs_batch_bit_equal(layout):
    """Contact graphs with the ESC encoding, the SPD bias and labeled
    pairs: `attn_bias` stacked into (G, M, M) and `pair_index` /
    `pair_label` / `pair_graph` / `pair_mask` under the `num_pairs`
    budget equal the JAX batcher's, a short last batch included."""
    tg = [attach_attn_bias(g) for g in featurize_many(
        contact.synthetic_contact(7, seed=5), EscConfig(h=2))]
    jg = [j_attach_attn_bias(g) for g in j_featurize_many(
        jcontact.synthetic_contact(7, seed=5), JEscConfig(h=2))]
    if layout == "width":
        spec, jspec = BatchSpec.from_graphs(tg, 4), JBatchSpec.from_graphs(
            jg, 4)
    else:
        spec = BatchSpec.uniform(tg, 4, enc_layout="dedup")
        jspec = JBatchSpec.uniform(jg, 4, enc_layout="dedup")
    assert spec.num_pairs == jspec.num_pairs > 0
    assert spec.max_nodes_per_graph == jspec.max_nodes_per_graph
    for lo, hi in ((0, 4), (4, 7)):
        got = batch_arrays(tg[lo:hi], spec)
        want = _jax_arrays(j_pad_and_batch(jg[lo:hi], jspec))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        M = spec.max_nodes_per_graph
        assert got["extras.attn_bias"].shape == (4, M, M)
        assert got["extras.pair_mask"].sum() == sum(
            g.extras["pair_index"].shape[1] for g in tg[lo:hi])


OVERRIDES = [
    ["optim.base_lr", "1e-3"], ["optim.base_lr", "0.002"],
    ["dataset.attn_bias", "true"], ["model.use_lap_pe", "yes"],
    ["run_multiple_splits", "[0, 1]"], ["pretrained.dir", "null"],
    ["train.epochs", "7", "model.dim_h", "32", "dataset.esc.h", "2"],
    ["metric", "auc", "model.san_gamma", "1.0e-4"],
]


@pytest.mark.parametrize("opts", OVERRIDES, ids=["-".join(o) for o in
                                                  OVERRIDES])
def test_load_cfg_equals_jax_for_every_config(opts):
    """The port's `load_cfg` (its own YAML reader) resolves every
    configs/gps/*.yaml under each override form to JAX's `Cfg`, types
    included (PyYAML's YAML 1.1 rules: '1e-3' a string coerced to the
    default's float, 'yes' True, '[0, 1]' a list, 'null' None)."""
    assert len(CONFIGS) == 24
    for path in CONFIGS:
        got = config.load_cfg(path, opts).to_plain()
        want = jconfig.load_cfg(path, opts).to_plain()
        assert got == want, path
        assert repr(got) == repr(want), path


def test_yaml_reader_and_writer_against_pyyaml(tmp_path):
    """Scalars and documents read as `yaml.safe_load` reads them; the
    dumped config.yaml reads back through `yaml.safe_load` to the
    resolved dict."""
    for text in ("1e-3", "1.0e-3", "1.e-3", "0.002", "017", "0x1f", "0b11",
                 "1_000", "1:30", "+5", "-0", "yes", "On", "off", "~", "",
                 "null", "[]", "{}", "[0, 'a b', 1e5, no]", "'x''y'",
                 '"a\\tb"', ".inf", "-.inf", "hello world", "a: 1",
                 "a:\n  b: [1, 2]  # c\n  c: 'd'\n"):
        assert config.parse_yaml(text) == yaml.safe_load(text), text
    cfg = config.load_cfg(CONFIGS[0], ["out_dir", "it's here",
                                       "optim.min_lr", "1e-9"])
    config.dump_cfg(cfg, str(tmp_path))
    with open(tmp_path / "config.yaml") as f:
        assert yaml.safe_load(f) == cfg.to_plain()
    with pytest.raises(KeyError, match="unknown config key"):
        config.load_cfg(None, ["model.nope", "1"])


def test_agg_runs_equals_jax():
    runs = [{"best_val_mae": 0.5, "best_epoch": 3, "note": "x"},
            {"best_val_mae": 0.25, "best_epoch": 5, "note": "y"}]
    assert config.agg_runs(runs) == jconfig.agg_runs(runs)


def test_link_loss_and_ranking_metrics_equal_jax():
    """`link_pair_loss` on a padded contact batch (padding pairs masked)
    equals JAX's; `eval_mrr` (stable argsort: a tie ranks the positive
    first) and `graph_link_mrr` (all nodes but the true tail as
    negatives; {} for a graph without positives) equal JAX's on the same
    scores, ties included."""
    tg = contact.synthetic_contact(3, seed=6)
    jg = jcontact.synthetic_contact(3, seed=6)
    spec, jspec = BatchSpec.from_graphs(tg, 4), JBatchSpec.from_graphs(jg, 4)
    tb = pad_and_batch(tg, spec, device="cpu")
    jb = j_pad_and_batch(jg, jspec)
    emb = np.random.default_rng(0).normal(
        size=(spec.num_nodes, 8)).astype(np.float32)
    got = metrics.link_pair_loss(torch.from_numpy(emb), tb)
    want = jmetrics.link_pair_loss(jnp.asarray(emb), jb)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    rng = np.random.default_rng(1)
    pos = np.round(rng.normal(size=12), 1)
    neg = np.round(rng.normal(size=(12, 9)), 1)
    neg[0, :3] = pos[0]  # ties with the positive
    a, b = metrics.eval_mrr(pos, neg), jmetrics.eval_mrr(pos, neg)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for g in tg:
        n = g.num_nodes
        scores = np.round(rng.normal(size=(n + 3, n + 3)), 1)
        pi, pl = g.extras["pair_index"], g.extras["pair_label"]
        assert metrics.graph_link_mrr(scores, pi, pl, n) == \
            jmetrics.graph_link_mrr(scores, pi, pl, n)
        assert metrics.graph_link_mrr(scores, pi, np.zeros_like(pl), n) == {}
