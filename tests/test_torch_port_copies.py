"""The copy family of the PyTorch port against the JAX package, on the CPU.

Both packages featurize the same numpy-seeded synthetic ZINC molecules
(5 graphs, h 2) and batch them; compared:

  * the node, pair and edge copy transforms, bit for bit;
  * the ragged and copy-uniform batches (`BatchSpec.copy_uniform`) field
    by field, a full batch and a short padded one, bit for bit;
  * `bucketize_copy_batch` with demotion and `make_bucket_transform`,
    bit for bit, and the reference's TypeError without a large budget;
  * NGNN (mean and root pooling, node level), I2GNN (every pair-copy
    pooling and the mean-context / double-pooling / pooling-MLP
    variants) on carried flax weights: f32 logits at rtol 1e-5 of the
    largest logit, in both BatchNorm modes; bf16 at the JAX package's
    bf16 tolerance (rtol 3e-2, `tests/test_playbook_r5.py`);
    NestedPPGN is `test_torch_port_nested_ppgn.py`'s;
  * one train step (L1 loss, every gradient, the Adam update) at 1e-4;
  * ragged = uniform = bucketed inside the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.molecules import synthetic_zinc as j_synthetic_zinc
from escgnn_tpu.data.uniform_copies import (
    bucketize_copy_batch as j_bucketize,
    make_bucket_transform as j_make_bucket_transform,
    uniformize_dataset as j_uniformize,
)
from escgnn_tpu.featurize import edge_subgraphs as j_edge
from escgnn_tpu.featurize import node_subgraphs as j_node
from escgnn_tpu.featurize import pair_subgraphs as j_pair
from escgnn_tpu.models.i2gnn import I2GNN as JI2GNN
from escgnn_tpu.models.i2gnn import I2GNNConfig as JI2GNNConfig
from escgnn_tpu.models.ngnn import NGNN as JNGNN
from escgnn_tpu.models.ngnn import NGNNConfig as JNGNNConfig
from escgnn_tpu.train.loop import adam_with_plateau as j_adam
from escgnn_tpu.train.loop import l1_graph_loss as j_l1_graph_loss
from escgnn_tpu_torch.data.batching import (
    BatchSpec,
    batch_arrays,
    batch_from_arrays,
    pad_and_batch,
)
from escgnn_tpu_torch.data.molecules import synthetic_zinc
from escgnn_tpu_torch.data.uniform_copies import (
    bucketize_copy_batch,
    make_bucket_transform,
    uniformize_dataset,
)
from escgnn_tpu_torch.featurize import edge_subgraphs, node_subgraphs
from escgnn_tpu_torch.featurize import pair_subgraphs
from escgnn_tpu_torch.models.i2gnn import I2GNN, I2GNNConfig
from escgnn_tpu_torch.models.layers import bn_statistics
from escgnn_tpu_torch.models.ngnn import NGNN, NGNNConfig
from escgnn_tpu_torch.train.loop import adam_with_plateau, l1_graph_loss
from escgnn_tpu_torch.weights import flax_to_state_dict, load_flax_variables

LR = 1e-3
BS = 4


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_graph_equal(a, b):
    assert a.num_nodes == b.num_nodes
    for f in ("edge_index", "x", "edge_attr", "y", "pos"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert set(a.extras) == set(b.extras)
    for k, v in a.extras.items():
        assert np.asarray(v).dtype == np.asarray(b.extras[k]).dtype, k
        np.testing.assert_array_equal(v, b.extras[k], err_msg=k)


def _jax_arrays(jbatch) -> dict:
    out = {k: np.asarray(v) for k, v in vars(jbatch).items()
           if v is not None and hasattr(v, "shape")}
    out.update({"extras." + k: np.asarray(v)
                for k, v in (jbatch.extras or {}).items()})
    return out


def _assert_arrays_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


_TRANSFORMS = {
    "node": (j_node.create_node_subgraphs, j_node.NodeSubgraphConfig,
             node_subgraphs.create_node_subgraphs,
             node_subgraphs.NodeSubgraphConfig, dict(h=2, use_rd=True)),
    "node_spd_adj": (j_node.create_node_subgraphs, j_node.NodeSubgraphConfig,
                     node_subgraphs.create_node_subgraphs,
                     node_subgraphs.NodeSubgraphConfig,
                     dict(h=2, node_label="spd", keep_orig_adj=True)),
    "pair": (j_pair.create_pair_subgraphs, j_pair.PairSubgraphConfig,
             pair_subgraphs.create_pair_subgraphs,
             pair_subgraphs.PairSubgraphConfig, dict(h=2, use_rd=True)),
    "edge": (j_edge.create_edge_subgraphs, j_edge.EdgeSubgraphConfig,
             edge_subgraphs.create_edge_subgraphs,
             edge_subgraphs.EdgeSubgraphConfig, dict(h=1, use_rd=True)),
}
_GRAPHS = {}


def _copies(kind):
    """(JAX graphs, port graphs) of one copy transform of 5 molecules."""
    if kind not in _GRAPHS:
        jf, jc, tf, tc, kw = _TRANSFORMS[kind]
        _GRAPHS[kind] = ([jf(g, jc(**kw)) for g in j_synthetic_zinc(5, 3)],
                         [tf(g, tc(**kw)) for g in synthetic_zinc(5, 3)])
    return _GRAPHS[kind]


@pytest.mark.parametrize("kind", list(_TRANSFORMS))
def test_featurizers_bit_equal(kind):
    """Every field, extra and dtype of the copies equals JAX's; the cache
    tags too."""
    jg, tg = _copies(kind)
    for a, b in zip(jg, tg):
        _assert_graph_equal(a, b)
    jf, jc, tf, tc, kw = _TRANSFORMS[kind]
    assert tc(**kw).cache_key() == jc(**kw).cache_key()


_SPEC_FIELDS = ("num_graphs", "num_nodes", "num_edges", "num_segments",
                "num_segments2", "num_original", "max_nodes_per_graph",
                "max_segments_per_graph", "copy_nodes", "copy_edges")


def _specs(kind, layout):
    jg, tg = _copies(kind)
    if layout == "ragged":
        return jg, tg, JBatchSpec.from_graphs(jg, BS), BatchSpec.from_graphs(
            tg, BS)
    jg, tg = j_uniformize(jg), uniformize_dataset(tg)
    return (jg, tg, JBatchSpec.copy_uniform(jg, BS),
            BatchSpec.copy_uniform(tg, BS))


@pytest.mark.parametrize("layout", ["ragged", "uniform"])
@pytest.mark.parametrize("kind", ["node", "pair", "node_spd_adj"])
def test_batches_bit_equal(kind, layout):
    """The spec budgets and every field and extra of a full batch and a
    short padded one (the copy levels, centers, original nodes and the
    dense orig_adj included) equal JAX's."""
    jg, tg, js, ts = _specs(kind, layout)
    if layout == "uniform":
        for a, b in zip(jg, tg):
            _assert_graph_equal(a, b)
    for f in _SPEC_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    for lo, hi in ((0, BS), (3, 5)):
        _assert_arrays_equal(batch_arrays(tg[lo:hi], ts),
                             _jax_arrays(j_pad_and_batch(jg[lo:hi], js)))
    b = pad_and_batch(tg[:BS], ts, device="cpu")
    assert (b.nodes_per_seg, b.edges_per_seg) == (
        (ts.copy_nodes, ts.copy_edges) if layout == "uniform"
        else (None, None))


def test_copy_blocks_refuse_other_layouts():
    """A graph that is not whole copy blocks does not batch under a
    copy-uniform spec."""
    _, tg, _, ts = _specs("node", "uniform")
    g = dataclasses.replace(tg[0], num_nodes=tg[0].num_nodes - 1)
    with pytest.raises(ValueError, match="copy blocks"):
        batch_arrays([g], ts)


@pytest.mark.parametrize("kind", ["node", "pair"])
def test_bucketize_bit_equal(kind):
    """`make_bucket_transform` (its regions and output) and
    `bucketize_copy_batch` with a small-region budget that forces
    demotion equal JAX's bit for bit; without a large budget the
    reference raises TypeError, and so does the port."""
    jg0, tg0 = _copies(kind)
    jg, tg, js, ts = _specs(kind, "uniform")
    jb = j_pad_and_batch(jg[:BS], js)
    tb = batch_from_arrays(batch_arrays(tg[:BS], ts), ts, "cpu")
    jt, jreg = j_make_bucket_transform(jg0, BS)
    tt, treg = make_bucket_transform(tg0, BS)
    assert treg == jreg
    got, want = tt(tb), jt(jb)
    assert got.seg_regions == want.seg_regions
    assert got.nodes_per_seg is None and got.edges_per_seg is None
    _assert_arrays_equal({k: v.numpy() for k, v in got.tensors().items()},
                         _jax_arrays(want))

    (cs, n_s, e_s), _ = treg
    nm = tb.node_mask.numpy().reshape(-1, ts.copy_nodes).sum(1)
    em = tb.edge_mask.numpy().reshape(-1, ts.copy_edges).sum(1)
    smalls = int(((nm <= n_s) & (em <= e_s) & (nm > 0)).sum())
    budget = max(1, smalls // 2)  # half the small copies demote
    got = bucketize_copy_batch(tb, n_s, e_s, cs_budget=budget,
                               cl_budget=1000)
    want = j_bucketize(jb, n_s, e_s, cs_budget=budget, cl_budget=1000)
    assert got.seg_regions == want.seg_regions == (
        (budget, n_s, e_s), (1000, ts.copy_nodes, ts.copy_edges))
    _assert_arrays_equal({k: v.numpy() for k, v in got.tensors().items()},
                         _jax_arrays(want))
    # with every copy small (the small block is the whole block) no copy
    # needs the large region, and a missing cl_budget reaches int(None)
    for fn, batch in ((bucketize_copy_batch, tb), (j_bucketize, jb)):
        with pytest.raises(TypeError):
            fn(batch, ts.copy_nodes, ts.copy_edges, cs_budget=10 ** 6,
               cl_budget=None)


# ---------------------------------------------------------------------------
# models on carried weights
# ---------------------------------------------------------------------------

_INITS = {}
# family -> (flax model, its config, port model, its config)
MODELS = {"ngnn": (JNGNN, JNGNNConfig, NGNN, NGNNConfig),
          "i2gnn": (JI2GNN, JI2GNNConfig, I2GNN, I2GNNConfig)}


def _random_stats(stats, seed=5):
    """Running statistics away from (0, 1), so eval reads them."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key == "mean":
            return rng.normal(0.0, 0.2, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, _np_tree(stats))


def _model_pair(classes, cfg_kw, jb, **port_kw):
    """(flax model, params, stats, port model on the carried state);
    `classes`: (flax model, its config, port model, its config)."""
    jcls, jcfg, tcls, tcfg = classes
    jm = jcls(jcfg(**cfg_kw))
    key = (jcls.__name__, tuple(sorted(cfg_kw.items())))
    if key not in _INITS:
        v = jax.jit(jm.init)(jax.random.key(0), jb)
        _INITS[key] = (_np_tree(v["params"]),
                       _random_stats(v.get("batch_stats", {})))
    params, stats = _INITS[key]
    m = tcls(tcfg(**cfg_kw), device="cpu", **port_kw)
    load_flax_variables(m, params, stats)
    return jm, params, stats, m


def _model_batches(kind, layout):
    """(JAX batch, port batch) of the first BS graphs; `bucketed`: both
    through their package's bucket transform."""
    jg, tg, js, ts = _specs(kind, "ragged" if layout == "ragged"
                            else "uniform")
    jb = j_pad_and_batch(jg[:BS], js)
    tb = pad_and_batch(tg[:BS], ts, device="cpu")
    if layout == "bucketed":
        jg0, tg0 = _copies(kind)
        jb = j_make_bucket_transform(jg0, BS)[0](jb)
        tb = make_bucket_transform(tg0, BS)[0](tb)
    return jax.tree.map(jnp.asarray, jb), tb


def _close(got, want, rtol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=rtol)


def _check_logits(family, cfg_kw, kind, layout, rtol=1e-5, **port_kw):
    jb, tb = _model_batches(kind, layout)
    jm, params, stats, m = _model_pair(MODELS[family], cfg_kw, jb,
                                       **port_kw)
    m.eval()
    for running in (True, False):
        out = jm.apply({"params": params, "batch_stats": stats}, jb,
                       use_running_average=running,
                       mutable=False if running else ["batch_stats"])
        want = np.asarray(out if running else out[0])
        with torch.no_grad(), bn_statistics(m, use_running_average=running):
            got = m(tb).numpy()
        assert got.shape == want.shape
        _close(got, want, rtol)
    return got


NGNN_BASE = dict(num_layers=2, hidden=16, use_rd=True)


@pytest.mark.parametrize("layout", ["ragged", "uniform", "bucketed"])
@pytest.mark.parametrize("variant", [{}, {"subgraph_pooling": "center"},
                                     {"node_level": True}])
def test_ngnn_parity(variant, layout):
    """NGNN logits on carried weights (rtol 1e-5) for mean and root copy
    pooling and the node-level head, on the three layouts."""
    _check_logits("ngnn", dict(NGNN_BASE, **variant), "node", layout)


I2_BASE = dict(num_layers=2, hidden=16, use_rd=True)
I2_VARIANTS = {
    "mean": dict(subgraph2_pooling="mean"),
    "mean_gate": dict(subgraph2_pooling="mean", gate=True),
    "add": dict(subgraph2_pooling="add"),
    "center": dict(subgraph2_pooling="center"),
    "mean-center": dict(subgraph2_pooling="mean-center"),
    "mean-center-side": dict(subgraph2_pooling="mean-center-side",
                             gate=True),
    "context_double_poolnn": dict(subgraph_pooling="mean-context",
                                  double_pooling=True, use_pooling_nn=True,
                                  graph_aggr="add"),
    "add_node_level": dict(subgraph_pooling="add", node_level=True,
                           gate=True, subgraph2_pooling="mean-center-side"),
}


@pytest.mark.parametrize("variant", list(I2_VARIANTS))
def test_i2gnn_parity(variant):
    """I2GNN logits on carried weights (rtol 1e-5) for every pair-copy
    pooling, the gate, mean-context with double pooling and the pooling
    MLPs, and the node-level head, on the uniform layout."""
    _check_logits("i2gnn", dict(I2_BASE, **I2_VARIANTS[variant]), "pair",
                  "uniform")


@pytest.mark.parametrize("layout", ["ragged", "bucketed"])
def test_i2gnn_parity_layouts(layout):
    """The main-path I2GNN (mean-center-side, gated) on the ragged and the
    bucketed layout (rtol 1e-5)."""
    _check_logits("i2gnn", dict(I2_BASE, **I2_VARIANTS["mean-center-side"]),
                  "pair", layout)


@pytest.mark.parametrize("family,kind", [("ngnn", "node"),
                                         ("i2gnn", "pair")])
@pytest.mark.parametrize("layout", ["ragged", "uniform"])
def test_bf16_parity(family, kind, layout):
    """compute_dtype bfloat16 (bf16 messages and aggregation) against the
    JAX package's bf16, at its bf16 tolerance (rtol 3e-2; measured
    1.6e-4 ragged, 1e-7 uniform)."""
    cfg = dict(NGNN_BASE, compute_dtype="bfloat16")
    if family == "i2gnn":
        cfg.update(I2_VARIANTS["mean-center-side"])
    _check_logits(family, cfg, kind, layout, rtol=3e-2)


def test_layouts_agree_inside_the_port():
    """One set of weights, the same graphs: ragged = uniform = bucketed
    train-mode logits for NGNN and I2GNN (rtol 2e-5, as the JAX package's
    `test_uniform_copies.py`), and their L1 gradients (the norm of the
    difference within 1e-4 of the norm of the whole gradient)."""
    for family, kind, cfg in (
            ("ngnn", "node", NGNN_BASE),
            ("i2gnn", "pair", dict(I2_BASE,
                                   **I2_VARIANTS["mean-center-side"]))):
        outs = []
        for layout in ("ragged", "uniform", "bucketed"):
            _, tb = _model_batches(kind, layout)
            cls, ccls = (NGNN, NGNNConfig) if family == "ngnn" else (
                I2GNN, I2GNNConfig)
            m = cls(ccls(**cfg), device="cpu")
            m.train()
            out = m(tb)
            y = torch.linspace(-1.0, 1.0, out.shape[0])[:, None]
            (out - y).abs().mul(tb.graph_mask[:, None]).sum().backward()
            outs.append((out.detach().numpy(),
                         {k: p.grad for k, p in m.named_parameters()}))
        (o0, g0) = outs[0]
        norm = torch.sqrt(sum((v ** 2).sum() for v in g0.values()))
        for o, g in outs[1:]:
            np.testing.assert_allclose(o, o0, rtol=2e-5, atol=2e-5)
            diff = torch.sqrt(sum(((g[k] - v) ** 2).sum()
                                  for k, v in g0.items()))
            assert diff <= 1e-4 * norm, (family, float(diff / norm))


@pytest.mark.parametrize("family,kind,cfg", [
    ("ngnn", "node", NGNN_BASE),
    ("i2gnn", "pair", dict(I2_BASE, **I2_VARIANTS["mean-center-side"])),
])
def test_train_step_grads_and_adam(family, kind, cfg):
    """Train mode on the uniform layout: the L1 loss (rtol 1e-5), every
    gradient (rtol 1e-4, atol 1e-6 of the largest) and the parameters
    after one Adam step (rtol 1e-4; an entry whose JAX gradient is
    rounding noise, under that atol, may move by up to 2 * lr, Adam
    normalising the noise to a full step)."""
    jb, tb = _model_batches(kind, "uniform")
    jm, params, stats, m = _model_pair(MODELS[family], cfg, jb)

    def loss_of(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, jb,
                            use_running_average=False,
                            mutable=["batch_stats"])
        return j_l1_graph_loss(out, jb), mut["batch_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(params)
    tx = j_adam(LR)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    jafter = flax_to_state_dict(
        _np_tree(jax.tree.map(lambda a, b: a + b, params, upd)),
        _np_tree(jstats))
    want_g = flax_to_state_dict(_np_tree(jgrads), {})

    opt = adam_with_plateau(m.parameters(), LR)
    m.train()
    opt.zero_grad()
    loss = l1_graph_loss(m(tb), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got_g = {k: p.grad.numpy().copy() for k, p in m.named_parameters()}
    assert set(got_g) == set(want_g)
    atol = 1e-6 * max(float(w.abs().max()) for w in want_g.values())
    for k, w in want_g.items():
        np.testing.assert_allclose(got_g[k], w.numpy(), rtol=1e-4,
                                   atol=atol, err_msg=k)
    opt.step()
    sd = m.state_dict()
    assert set(sd) == set(jafter)
    for k, w in jafter.items():
        got, want = sd[k].numpy(), w.numpy()
        noise = (np.abs(want_g[k].numpy()) < atol if k in want_g
                 else np.zeros(want.shape, bool))
        assert np.abs(got - want)[noise].max(initial=0.0) <= 2 * LR, k
        np.testing.assert_allclose(got[~noise], want[~noise], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
