"""The QM9 slice of the port against the JAX package, on the CPU: the
dataset module, node-type extras through the batcher and the pools, the
QM9 NestedGIN_eff fields with flax weights carried over, and one pool
epoch with extras. Inputs come from numpy seeds (synthetic QM9) and the
gdb9.sdf fixture under tests/fixtures/qm9_root.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.prefetch import stacked_batch_pools as j_stacked_pools
from escgnn_tpu.data import qm9 as jqm9
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu.models.nested_gin_eff import NestedGINEff as JNestedGINEff
from escgnn_tpu.models.nested_gin_eff import NestedGINEffConfig as JConfig
from escgnn_tpu.train.loop import TrainState
from escgnn_tpu.train.loop import adam_with_plateau as j_adam
from escgnn_tpu.train.loop import make_pool_train_step as j_make_pool_train_step
from escgnn_tpu_torch.data import qm9
from escgnn_tpu_torch.data.batching import BatchSpec, batch_arrays, pad_and_batch
from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.data.prefetch import pool_entry, stacked_batch_pools
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff, NestedGINEffConfig
from escgnn_tpu_torch.run_qm9 import mse_loss
from escgnn_tpu_torch.train.loop import adam_with_plateau, make_pool_train_step
from escgnn_tpu_torch.weights import flax_to_state_dict, load_flax_variables

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                    "qm9_root")
RAW = os.path.join(ROOT, "qm9", "raw")
CFG = dict(hidden=16, num_layers=2, act="relu", graph_pred=True, pool="mean",
           use_x_embedding_jk=False, head_order="dropout_act",
           concat_pos=True, node_add_embed_vocab=5, edge_float_attr=True)
LR = 1e-3


def _assert_graphs_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.num_nodes == b.num_nodes
        for f in ("edge_index", "x", "edge_attr", "y", "pos", "enc_idx",
                  "enc_cnt", "enc_offsets"):
            va, vb = getattr(a, f), getattr(b, f)
            assert (va is None) == (vb is None), f
            if va is not None:
                assert np.asarray(va).dtype == np.asarray(vb).dtype, f
                np.testing.assert_array_equal(va, vb, err_msg=f)
        assert set(a.extras or {}) == set(b.extras or {})
        for k in a.extras or {}:
            assert a.extras[k].dtype == b.extras[k].dtype
            np.testing.assert_array_equal(a.extras[k], b.extras[k])


def test_synthetic_qm9_and_splits_equal(tmp_path):
    _assert_graphs_equal(qm9.synthetic_qm9(12, seed=5),
                         jqm9.synthetic_qm9(12, seed=5))
    got, real = qm9.qm9_splits(str(tmp_path), num_graphs=7, seed=2)
    want, jreal = jqm9.qm9_splits(str(tmp_path), num_graphs=7, seed=2)
    assert (real, jreal) == (False, False)
    _assert_graphs_equal(got, want)
    np.testing.assert_array_equal(qm9.QM9_CONVERSION, jqm9.QM9_CONVERSION)


def test_sdf_fixture_parse_equal():
    """The V2000 parser (aromaticity, hybridisation, explicit H counts,
    the uncharacterized skip list) and the real branch of qm9_splits."""
    sdf, csv = os.path.join(RAW, "gdb9.sdf"), os.path.join(RAW, "gdb9.sdf.csv")
    skip = os.path.join(RAW, "uncharacterized.txt")
    got = qm9.load_qm9_sdf(sdf, csv, skip_path=skip)
    _assert_graphs_equal(got, jqm9.load_qm9_sdf(sdf, csv, skip_path=skip))
    assert got and got[0].x.shape[1] == 13
    assert qm9.load_uncharacterized(skip) == jqm9.load_uncharacterized(skip)
    with open(sdf) as f:
        text = f.read()
    for a, b in zip(qm9.parse_sdf_v2000(text), jqm9.parse_sdf_v2000(text)):
        assert a[:2] == b[:2] and a[3] == b[3]
        np.testing.assert_array_equal(a[2], b[2])
    got, real = qm9.qm9_splits(ROOT)
    want, _ = jqm9.qm9_splits(ROOT)
    assert real
    _assert_graphs_equal(got, want)


def _featurized(n=10, seed=3):
    """QM9 graphs as the driver prepares them: featurized with self-loop
    fill 1.0, then distance-extended; the JAX package's and the port's."""
    tg = featurize_many(qm9.synthetic_qm9(n, seed=seed), EscConfig(h=2),
                        self_loop_fill=1.0)
    jg = j_featurize_many(jqm9.synthetic_qm9(n, seed=seed), JEscConfig(h=2),
                          self_loop_fill=1.0)
    tg = [qm9.append_distance_edge_attr(g) for g in tg]
    jg = [jqm9.append_distance_edge_attr(g) for g in jg]
    for g in tg:
        g.y = g.y[:1].astype(np.float32)
    for g in jg:
        g.y = g.y[:1].astype(np.float32)
    return tg, jg


def test_distance_edge_attr_equal():
    tg, jg = _featurized()
    _assert_graphs_equal(tg, jg)
    assert tg[0].edge_attr.shape[1] == 5
    # self loops (appended by the ESC transform) are at distance 0
    loops = tg[0].edge_index[0] == tg[0].edge_index[1]
    assert loops.any() and (tg[0].edge_attr[loops, 4] == 0).all()


def _jax_arrays(jbatch) -> dict:
    out = {k: np.asarray(v) for k, v in vars(jbatch).items()
           if v is not None and hasattr(v, "shape")}
    out.update({"extras." + k: np.asarray(v)
                for k, v in (jbatch.extras or {}).items()})
    return out


@pytest.mark.parametrize("layout", ["uniform_dedup", "width"])
def test_batch_with_node_type_extras_bit_equal(layout):
    """Node-aligned extras padded like x on the uniform (g * n_u offsets)
    and the width layout, equal to the JAX batcher bit for bit, and on
    the batch as `extras` tensors."""
    tg, jg = _featurized()
    if layout == "width":
        spec = BatchSpec.from_graphs(tg, 4)
        jspec = JBatchSpec.from_graphs(jg, 4)
    else:
        spec = BatchSpec.uniform(tg, 4, enc_layout="dedup")
        jspec = JBatchSpec.uniform(jg, 4, enc_layout="dedup")
    for lo in (0, 8):  # a full batch and a short, padded one
        got = batch_arrays(tg[lo:lo + 4], spec)
        want = _jax_arrays(j_pad_and_batch(jg[lo:lo + 4], jspec))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    b = pad_and_batch(tg[:4], spec, device="cpu")
    assert set(b.extras) == {"node_type"}
    assert b.tensors()["extras.node_type"] is b.extras["node_type"]
    assert b.extras["node_type"].shape == (spec.num_nodes,)


def _edge_graphs(cls, extra_key=None):
    """Two graphs with an edge-aligned extra "w" (more edges than nodes),
    plus `extra_key` when given."""
    rng = np.random.default_rng(0)
    out = []
    for n, m in ((5, 8), (7, 11)):
        ex = {"w": rng.normal(size=m).astype(np.float32)}
        if extra_key:
            ex[extra_key] = np.zeros(n, np.int32)
        out.append(cls(num_nodes=n,
                       edge_index=rng.integers(0, n, (2, m)).astype(np.int32),
                       x=np.ones((n, 1), np.float32), extras=ex))
    return out


def test_edge_aligned_extras_and_refused_keys():
    """Edge-aligned extras ride the receiver sort like edge_attr (equal
    to JAX); a copy-level key without its copy budget is skipped, as the
    JAX batcher skips it, and so is a k-set key without its k-set
    budget; the pair extras raise with their queue."""
    from escgnn_tpu.data.container import GraphData as JGraphData

    tg, jg = _edge_graphs(GraphData), _edge_graphs(JGraphData)
    spec = BatchSpec.from_graphs(tg, 2)
    got = batch_arrays(tg, spec)
    want = _jax_arrays(j_pad_and_batch(jg, JBatchSpec.from_graphs(jg, 2)))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["extras.w"], want["extras.w"])
    assert not np.array_equal(got["extras.w"][:8], tg[0].extras["w"])
    copy_t = _edge_graphs(GraphData, "node_to_subgraph")
    copy_j = _edge_graphs(JGraphData, "node_to_subgraph")
    got = batch_arrays(copy_t, BatchSpec.from_graphs(copy_t, 2))
    want = _jax_arrays(j_pad_and_batch(copy_j,
                                       JBatchSpec.from_graphs(copy_j, 2)))
    assert set(got) == set(want) and "extras.node_to_subgraph" not in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    kset_t = _edge_graphs(GraphData, "kset2_iso")
    kset_j = _edge_graphs(JGraphData, "kset2_iso")
    got = batch_arrays(kset_t, BatchSpec.from_graphs(kset_t, 2))
    want = _jax_arrays(j_pad_and_batch(kset_j,
                                       JBatchSpec.from_graphs(kset_j, 2)))
    assert set(got) == set(want) and not any("kset" in k for k in got)
    with pytest.raises(NotImplementedError, match="queue 8.3"):
        batch_arrays(_edge_graphs(GraphData, "pair_index"), spec)


def _jax_mse(out, batch):
    err = (out - batch.y) ** 2
    m = batch.graph_mask.astype(err.dtype)[:, None]
    return jnp.sum(err * m) / jnp.maximum(jnp.sum(m), 1.0)


@pytest.fixture(scope="module")
def qm9_model():
    tg, jg = _featurized(n=8)
    spec = BatchSpec.uniform(tg, 8, enc_layout="dedup")
    jspec = JBatchSpec.uniform(jg, 8, enc_layout="dedup")
    jbatch = jax.tree.map(jnp.asarray, j_pad_and_batch(jg, jspec))
    jmodel = JNestedGINEff(JConfig(**CFG))
    variables = jax.jit(jmodel.init)(jax.random.key(0), jbatch)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])

    def apply(p, train):
        return jmodel.apply({"params": p, "batch_stats": variables[
            "batch_stats"]}, jbatch, deterministic=True,
            use_running_average=not train,
            mutable=["batch_stats"] if train else False)

    out_eval = np.asarray(jax.jit(lambda p: apply(p, False))(params))
    (loss, out_train), grads = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (_jax_mse(o, jbatch), o))(apply(p, True)[0]),
        has_aux=True))(params)
    return dict(tg=tg, jg=jg, spec=spec, jspec=jspec, jmodel=jmodel,
                params=params, stats=stats, out_eval=out_eval,
                out_train=np.asarray(out_train), loss=float(loss),
                grads=jax.tree.map(np.asarray, grads),
                batch=pad_and_batch(tg, spec, device="cpu"))


def _port_model(s):
    model = NestedGINEff(NestedGINEffConfig(**CFG), in_dim=11,
                         edge_attr_dim=5, device="cpu")
    load_flax_variables(model, s["params"], s["stats"])
    return model


def test_qm9_model_forward_and_grads(qm9_model):
    """The flax `node_type_embedding` (5, 14) loads with no new rule;
    eval and train outputs at rtol 1e-5 (atol 1e-5), the MSE loss at rtol
    1e-5, every gradient at rtol 1e-4 / atol 1e-5."""
    s = qm9_model
    assert s["params"]["node_type_embedding"]["embedding"].shape == (5, 14)
    model = _port_model(s)
    b = s["batch"]
    model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(b).numpy(), s["out_eval"],
                                   rtol=1e-5, atol=1e-5)
    model.train()
    out = model(b)
    np.testing.assert_allclose(out.detach().numpy(), s["out_train"],
                               rtol=1e-5, atol=1e-5)
    loss = mse_loss(out, b)
    np.testing.assert_allclose(loss.item(), s["loss"], rtol=1e-5)
    loss.backward()
    want = flax_to_state_dict(s["grads"], {})
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_pool_epoch_with_extras_matches_jax(qm9_model):
    """One epoch over a 2-batch stacked pool whose batches carry
    `extras["node_type"]`: the port's pool step copies each batch, extras
    included, into its static buffers (the CUDA graph's inputs on a card)
    and steps on them; per-step losses against JAX's jitted pool step at
    rtol 1e-5 on the first step and 1e-4 on the second. A pool without
    the extras is refused."""
    s = qm9_model
    tg, jg = s["tg"], s["jg"]
    spec = BatchSpec.uniform(tg, 4, enc_layout="dedup")
    jspec = JBatchSpec.uniform(jg, 4, enc_layout="dedup")
    pools, n = stacked_batch_pools(tg, spec, k=1, seed=0, device="cpu")
    jpools, jn, _ = j_stacked_pools(jg, jspec, k=1, seed=0)
    assert n == jn == 2
    np.testing.assert_array_equal(pools[0].extras["node_type"].numpy(),
                                  np.asarray(jpools[0].extras["node_type"]))
    order = [1, 0]
    state = TrainState.create(jax.tree.map(jnp.asarray, s["params"]),
                              jax.tree.map(jnp.asarray, s["stats"]),
                              j_adam(LR))
    _, jlosses = j_make_pool_train_step(s["jmodel"], _jax_mse)(
        state, jpools[0], jnp.asarray(order, jnp.int32), jax.random.key(0))
    model = _port_model(s)
    step = make_pool_train_step(model, adam_with_plateau(model.parameters(),
                                                         LR), mse_loss,
                                pools[0])
    assert set(step.static.extras) == {"node_type"}
    losses = step(pools[0], order).numpy()
    jlosses = np.asarray(jlosses)
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    np.testing.assert_array_equal(
        step.static.extras["node_type"].numpy(),
        pool_entry(pools[0], order[-1]).extras["node_type"].numpy())
    bare = dataclasses.replace(pools[0], extras=None)
    with pytest.raises(ValueError, match="shape"):
        step(bare, order)
