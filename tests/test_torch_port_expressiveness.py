"""The expressiveness slice of the port (SR25, EXP/CEXP, CSL) against the
JAX package, on the CPU: the graph loaders and generators, the k-fold
split, the classification loss and eval steps, and the SR25 collision
count with flax weights carried over.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.csl import generate_csl as j_generate_csl
from escgnn_tpu.data.planar_sat import load_planar_sat as j_load_planar_sat
from escgnn_tpu.data.sr import load_sr_graphs as j_load_sr_graphs
from escgnn_tpu.data.sr import parse_graph6 as j_parse_graph6
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu.models.nested_gin_eff import NestedGINEff as JNestedGINEff
from escgnn_tpu.models.nested_gin_eff import NestedGINEffConfig as JConfig
from escgnn_tpu.train.loop import ce_graph_loss as j_ce_graph_loss
from escgnn_tpu.train.loop import make_accuracy_step as j_make_accuracy_step
from escgnn_tpu.train.loop import (
    make_pergraph_correct_step as j_make_pergraph_correct_step,
)
from escgnn_tpu_torch import run_csl, run_sr
from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.data.csl import generate_csl
from escgnn_tpu_torch.data.planar_sat import load_planar_sat
from escgnn_tpu_torch.data.sr import load_sr_graphs, parse_graph6
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff, NestedGINEffConfig
from escgnn_tpu_torch.train.loop import (
    ce_graph_loss,
    make_accuracy_step,
    make_pergraph_correct_step,
)
from escgnn_tpu_torch.weights import load_flax_variables
from tests.test_torch_port_driver_parity import load_jax_driver


def _assert_graphs_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.num_nodes == b.num_nodes
        for f in ("edge_index", "x", "y"):
            va, vb = getattr(a, f), getattr(b, f)
            assert (va is None) == (vb is None), f
            if va is not None:
                assert va.dtype == vb.dtype, f
                np.testing.assert_array_equal(va, vb, err_msg=f)


def test_graph6_and_sr25_equal():
    got, want = load_sr_graphs(), j_load_sr_graphs()
    _assert_graphs_equal(got, want)
    assert len(got) == 15 and all(g.num_nodes == 25 for g in got)
    # the short header and the 3-byte '~' header (K63: 1953 bits set)
    for line in (b"DQc", b"Bw", b"~??~" + b"~" * 326):
        n, ei = parse_graph6(line)
        jn, jei = j_parse_graph6(line)
        assert n == jn
        np.testing.assert_array_equal(ei, jei)
    assert n == 63 and ei.shape == (2, 63 * 62)


@pytest.mark.parametrize("name", ["EXP", "CEXP"])
def test_planar_sat_equal(name):
    got, want = load_planar_sat(name), j_load_planar_sat(name)
    _assert_graphs_equal(got, want)
    assert len(got) == 1200
    assert {int(g.y[0]) for g in got} == {0, 1}


def test_csl_and_k_folds_equal():
    got, want = generate_csl(seed=3), j_generate_csl(seed=3)
    _assert_graphs_equal(got, want)
    labels = np.asarray([int(g.y[0]) for g in got])
    jax_csl = load_jax_driver("run_csl")
    for k in (2, 5, 10):
        folds = run_csl.k_fold_indices(labels, k, seed=7)
        jfolds = jax_csl.k_fold_indices(labels, k, seed=7)
        assert len(folds) == len(jfolds) == k
        for a, b in zip(folds, jfolds):
            np.testing.assert_array_equal(a, b)
    assert sorted(np.concatenate(folds).tolist()) == list(range(150))


def test_ce_graph_loss_matches_jax():
    """Masked softmax cross-entropy over real graphs at 1e-6, padding
    graphs (mask False) left out."""
    rng = np.random.default_rng(0)
    out = rng.normal(size=(6, 10)).astype(np.float32) * 3
    y = rng.integers(0, 10, (6, 1)).astype(np.int64)
    mask = np.array([1, 1, 1, 1, 0, 0], bool)

    class B:
        pass

    tb, jb = B(), B()
    tb.y, tb.graph_mask = torch.from_numpy(y), torch.from_numpy(mask)
    jb.y, jb.graph_mask = jnp.asarray(y), jnp.asarray(mask)
    got = ce_graph_loss(torch.from_numpy(out), tb).item()
    want = float(j_ce_graph_loss(jnp.asarray(out), jb))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.fixture(scope="module")
def csl_model():
    """A CSL width batch (12 graphs of 3 classes, 2 padding slots) and a
    flax init of the CSL model (hidden 16, 2 layers, 10 classes)."""
    idx = [0, 1, 2, 15, 16, 17, 30, 31, 32, 45, 46, 47]
    tg = featurize_many([generate_csl()[i] for i in idx], EscConfig(h=2))
    jg = j_featurize_many([j_generate_csl()[i] for i in idx], JEscConfig(h=2))
    jspec = JBatchSpec.from_graphs(jg, 14)
    jbatch = jax.tree.map(jnp.asarray, j_pad_and_batch(jg, jspec))
    cfg = dict(hidden=16, num_layers=2, graph_pred=True, pool="add",
               use_x_embedding_jk=False, out_dim=10)
    jmodel = JNestedGINEff(JConfig(**cfg))
    variables = jax.jit(jmodel.init)(jax.random.key(1), jbatch)
    model = NestedGINEff(NestedGINEffConfig(**cfg), device="cpu")
    load_flax_variables(model, jax.tree.map(np.asarray, variables["params"]),
                        jax.tree.map(np.asarray, variables["batch_stats"]))
    return dict(jmodel=jmodel, variables=variables, jbatch=jbatch,
                model=model,
                batch=pad_and_batch(tg, BatchSpec.from_graphs(tg, 14),
                                    device="cpu"))


def test_accuracy_and_pergraph_steps_match_jax(csl_model):
    """`make_accuracy_step` and `make_pergraph_correct_step` (running BN
    statistics, device tensors) against JAX's on the same weights and
    batch: the counts equal, the per-graph verdicts equal, and the model
    left in `eval()`. The logits agree at rtol/atol 1e-5 (f32 sums in
    another order), so the argmax is compared only where JAX's top two
    logits are more than 1e-4 apart (all of them here)."""
    s = csl_model
    v, jb = s["variables"], s["jbatch"]
    logits = np.asarray(s["jmodel"].apply(v, jb))
    top2 = np.sort(logits, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 1e-4).all()
    jc, jt = j_make_accuracy_step(s["jmodel"])(v["params"],
                                              v["batch_stats"], jb)
    jcorrect, jmask = j_make_pergraph_correct_step(s["jmodel"])(
        v["params"], v["batch_stats"], jb)
    model, b = s["model"], s["batch"]
    model.train()
    c, t = make_accuracy_step(model)(b)
    assert isinstance(c, torch.Tensor) and not model.training
    assert (int(c), int(t)) == (int(jc), int(jt)) and int(t) == 12
    correct, mask = make_pergraph_correct_step(model)(b)
    np.testing.assert_array_equal(correct.numpy(), np.asarray(jcorrect))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    with torch.no_grad():
        model.eval()
        np.testing.assert_allclose(model(b).numpy(), logits, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_sr25_collisions_equal_jax_on_carried_weights(monkeypatch, seed):
    """The SR25 check at 8 layers x 64 on the real graphs: the JAX model's
    init (seeds 0 and 1, as the JAX record) carried into `run_sr.sr_model`;
    the port's embeddings scaled as the count scales them agree with
    JAX's at 1e-4, and the collision count (pairs closer than 1e-2)
    equals JAX's: 10 of 105 in f32 for both seeds, where the JAX
    package's record, taken on a TPU, is 0/105."""
    monkeypatch.setattr(run_sr, "FEATURIZE_WORKERS", 0)
    feats = j_featurize_many(j_load_sr_graphs(),
                             JEscConfig(h=3, use_rd=True, self_loop=True))
    jbatch = jax.tree.map(jnp.asarray, j_pad_and_batch(
        feats, JBatchSpec.from_graphs(feats, batch_size=len(feats))))
    jmodel = JNestedGINEff(JConfig(hidden=64, num_layers=8, graph_pred=True,
                                   pool="add", use_x_embedding_jk=False,
                                   out_dim=64))
    variables = jax.jit(jmodel.init)(jax.random.key(seed), jbatch)
    jemb = np.asarray(jax.jit(jmodel.apply)(variables, jbatch))
    jemb = jemb[np.asarray(jbatch.graph_mask)]

    model = run_sr.sr_model(64, 8, seed=seed, device="cpu")
    load_flax_variables(model, jax.tree.map(np.asarray, variables["params"]),
                        jax.tree.map(np.asarray, variables["batch_stats"]))
    emb = run_sr.sr_embeddings(model, run_sr.sr_batch(3, None, "cpu")).numpy()
    scale = np.abs(jemb).mean()
    np.testing.assert_allclose(emb / scale, jemb / scale, rtol=0, atol=1e-4)
    assert run_sr.count_collisions(emb) == run_sr.count_collisions(jemb)
    assert run_sr.count_collisions(jemb) == (10, 105)
