"""The PyTorch OgbGNN against the JAX package, in f32 on the CPU.

Both packages batch the same numpy-seeded synthetic ogbg-mol graphs (2
tasks with NaN holes; 6 graphs, emb 16, 2 layers); one flax init per
configuration, its BatchNorm running statistics replaced by random ones,
is carried into the port by `escgnn_tpu_torch.weights`. Compared:

  * eval-mode logits on the running statistics and on the batch's own,
    for each graph pooling, for ppa encoders, return probabilities and
    residual + JK sum, on the dedup batch and the ragged one, at dropout
    0 and 0.5 (rtol 1e-5 of the largest logit);
  * at dropout 0: the NaN-masked BCE, every gradient and one Adam step
    (rtol 1e-4);
  * at dropout 0.5: the exact BatchNorm refresh over a stacked pool and
    eval in both BatchNorm modes after it, for OgbGNN and for
    NestedGIN_eff on the dedup layout (rtol 1e-5);
  * the bf16 conv stack (rtol 1e-5: both round at the same places; the
    differences measured are stated at the test).

Dropout's masks are not JAX's (a torch generator draws them), so its own
semantics are tested alone: inverted scaling, the keep rate within a
binomial bound, the same mask from the same generator state, its place
before each BatchNorm of an MLP, and nothing drawn in eval().
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.molecules import synthetic_ogb_mol as j_synthetic_ogb_mol
from escgnn_tpu.data.molecules import synthetic_ppa as j_synthetic_ppa
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.rw import attach_return_prob as j_attach_rp
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu.models.nested_gin_eff import NestedGINEff as JNestedGINEff
from escgnn_tpu.models.nested_gin_eff import NestedGINEffConfig as JNGConfig
from escgnn_tpu.models.ogb_gnn import OgbGNN as JOgbGNN
from escgnn_tpu.models.ogb_gnn import OgbGNNConfig as JConfig
from escgnn_tpu.train.loop import TrainState, adam_with_plateau as j_adam
from escgnn_tpu.train.loop import make_bn_refresh_step as j_refresh_step
from escgnn_tpu.train.loop import refresh_bn_stats as j_refresh_bn_stats
from escgnn_tpu.train.metrics import masked_bce_with_logits as j_bce
from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.data.molecules import synthetic_ogb_mol, synthetic_ppa
from escgnn_tpu_torch.data.prefetch import stack_split
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.featurize.rw import attach_return_prob
from escgnn_tpu_torch.models.layers import MLP, bn_statistics, dropout
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.models.ogb_gnn import OgbGNN, OgbGNNConfig
from escgnn_tpu_torch.train import loop as tloop
from escgnn_tpu_torch.train.loop import (
    adam_with_plateau,
    bce_graph_loss,
    make_pool_refresh_step,
)
from escgnn_tpu_torch.weights import flax_to_state_dict, load_flax_variables

LR = 1e-3
BASE = dict(num_tasks=2, num_layers=2, emb_dim=16)
POOLINGS = ["sum", "mean", "max", "attention", "combine", "set2set", "sort"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _graphs(kind):
    esc = dict(h=2, use_rd=True, self_loop=True)
    if kind == "ppa":
        raw_j, raw_t = j_synthetic_ppa(6, seed=1), synthetic_ppa(6, seed=1)
    else:
        raw_j = j_synthetic_ogb_mol(6, seed=0, num_tasks=2, nan_frac=0.3)
        raw_t = synthetic_ogb_mol(6, seed=0, num_tasks=2, nan_frac=0.3)
    if kind == "rp":
        raw_j = [j_attach_rp(g, 4) for g in raw_j]
        raw_t = [attach_return_prob(g, 4) for g in raw_t]
    return (j_featurize_many(raw_j, JEscConfig(**esc)),
            featurize_many(raw_t, EscConfig(**esc)))


def _batches(kind, layout="uniform", batch_size=6):
    """(JAX batch, port batch) of one kind of graphs, the first
    `batch_size` of them."""
    jg, tg = _graphs(kind)
    if layout == "uniform":
        js = JBatchSpec.uniform(jg, batch_size, enc_layout="dedup")
        ts = BatchSpec.uniform(tg, batch_size, enc_layout="dedup")
    else:
        js = JBatchSpec.from_graphs(jg, batch_size)
        ts = BatchSpec.from_graphs(tg, batch_size)
    jb = jax.tree.map(jnp.asarray, j_pad_and_batch(jg[:batch_size], js))
    return jb, pad_and_batch(tg[:batch_size], ts, device="cpu"), (jg, tg,
                                                                  js, ts)


@pytest.fixture(scope="module")
def mol():
    return _batches("mol")


def _random_stats(stats, seed=5):
    """Running statistics away from (0, 1), so eval reads them."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key == "mean":
            return rng.normal(0.0, 0.2, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, _np_tree(stats))


_INITS = {}


def _init(cfg_kw, jb):
    """The flax model and its variables; dropout has no parameters, so
    configurations that differ only in it share one init."""
    jm = JOgbGNN(JConfig(**cfg_kw))
    key = (tuple(sorted((k, v) for k, v in cfg_kw.items() if k != "dropout")),
           tuple(jb.node_mask.shape))
    if key not in _INITS:
        v = jm.init(jax.random.key(0), jb)
        _INITS[key] = (_np_tree(v["params"]), _random_stats(v["batch_stats"]))
    return (jm, *_INITS[key])


def _port(cfg_kw, params, stats):
    m = OgbGNN(OgbGNNConfig(**cfg_kw), device="cpu")
    load_flax_variables(m, params, stats)
    return m


def _jax_logits(jm, params, stats, jb, running: bool):
    out = jm.apply({"params": params, "batch_stats": stats}, jb,
                   deterministic=True, use_running_average=running,
                   mutable=False if running else ["batch_stats"])
    return np.asarray(out if running else out[0])


def _port_logits(m, tb, running: bool):
    m.eval()
    with torch.no_grad(), bn_statistics(m, use_running_average=running):
        return m(tb).numpy()


def _close(got, want, rtol=1e-5):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol,
                               atol=rtol)


def _check_eval_parity(cfg_kw, jb, tb):
    jm, params, stats = _init(cfg_kw, jb)
    m = _port(cfg_kw, params, stats)
    for running in (True, False):
        _close(_port_logits(m, tb, running),
               _jax_logits(jm, params, stats, jb, running))


@pytest.mark.parametrize("drop", [0.0, 0.5])
@pytest.mark.parametrize("pool", POOLINGS)
def test_eval_parity_per_pooling(mol, pool, drop):
    """Eval logits for each graph pooling on the dedup batch, on the
    running statistics and on the batch's own (rtol 1e-5)."""
    jb, tb, _ = mol
    _check_eval_parity(dict(BASE, graph_pooling=pool, dropout=drop), jb, tb)


@pytest.mark.parametrize("drop", [0.0, 0.5])
@pytest.mark.parametrize("variant", ["ppa", "rp", "residual_jk_sum",
                                     "ragged"])
def test_eval_parity_variants(variant, drop):
    """ppa encoders (node constant, linear edge encoder on 7 floats, 37
    classes), return probabilities (use_rp 4), residual + JK sum, and the
    ragged layout (segment aggregation, gathered virtual node, the width
    encoding), at rtol 1e-5."""
    kind = variant if variant in ("ppa", "rp") else "mol"
    layout = "ragged" if variant == "ragged" else "uniform"
    jb, tb, _ = _batches(kind, layout)
    cfg_kw = dict(BASE, dropout=drop, graph_pooling="attention")
    if variant == "ppa":
        cfg_kw.update(num_tasks=37, ppa_encoders=True)
    elif variant == "rp":
        cfg_kw.update(use_rp=3)
    elif variant == "residual_jk_sum":
        cfg_kw.update(residual=True, jk="sum")
    _check_eval_parity(cfg_kw, jb, tb)


def test_loss_grads_and_adam_step(mol):
    """At dropout 0, train mode: the masked BCE (rtol 1e-5), every
    gradient (rtol 1e-4, atol 1e-6 of the largest gradient of the model)
    and the parameters and running statistics after one Adam step (rtol
    1e-4, atol 1e-6). A parameter whose JAX gradient is rounding noise
    (under that atol: a bias that feeds a BatchNorm) may move by up to
    2 * lr either way: Adam normalises the noise to a full step."""
    jb, tb, _ = mol
    cfg_kw = dict(BASE, dropout=0.0, graph_pooling="mean")
    jm, params, stats = _init(cfg_kw, jb)

    def loss_of(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, jb,
                            deterministic=False, use_running_average=False,
                            mutable=["batch_stats"])
        return j_bce(out, jb), mut["batch_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(params)
    tx = j_adam(LR)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    jafter = flax_to_state_dict(
        _np_tree(jax.tree.map(lambda a, b: a + b, params, upd)),
        _np_tree(jstats))
    want_g = flax_to_state_dict(_np_tree(jgrads), {})

    m = _port(cfg_kw, params, stats)
    opt = adam_with_plateau(m.parameters(), LR)
    m.train()
    opt.zero_grad()
    loss = bce_graph_loss(m(tb), tb)
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
        if k in want_g and float(want_g[k].abs().max()) < atol:
            assert np.abs(sd[k].numpy() - w.numpy()).max() <= 2 * LR, k
        else:
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def _stacked(extra):
    """Two batches of 3 graphs: JAX batches and the port's stacked pool."""
    jg, tg, _, _ = extra
    js = JBatchSpec.uniform(jg, 3, enc_layout="dedup")
    ts = BatchSpec.uniform(tg, 3, enc_layout="dedup")
    jbs = [jax.tree.map(jnp.asarray, j_pad_and_batch(jg[i:i + 3], js))
           for i in (0, 3)]
    return jbs, stack_split(tg, ts, device="cpu"), pad_and_batch(
        tg[:3], ts, device="cpu")


def _refresh_then_eval(jm, params, stats, jbs, port, stacked, tb0):
    """The exact refresh over both batches (statistics at rtol 1e-4: each
    batch's moments are recovered from one momentum update, which divides
    the f32 rounding of the update by 0.1), then eval of batch 0 in both
    BatchNorm modes, JAX against the port: rtol 1e-5 on the batch's own
    statistics, 1e-4 on the refreshed ones (their ~1e-5 rounding passes
    through every BatchNorm, the head's over 3 graphs)."""
    state = TrainState.create(params, stats, j_adam(LR))
    state = j_refresh_bn_stats(j_refresh_step(jm), state, jbs)
    make_pool_refresh_step(port)(stacked)
    want = flax_to_state_dict({}, _np_tree(state.batch_stats))
    sd = port.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for running in (True, False):
        _close(_port_logits(port, tb0, running),
               _jax_logits(jm, _np_tree(state.params),
                           _np_tree(state.batch_stats), jbs[0], running),
               rtol=1e-4 if running else 1e-5)


def test_dropout_refresh_and_eval_parity(mol):
    """OgbGNN at dropout 0.5 (z MLP on the expanded edges): the refresh
    forward runs in eval(), so no mask is drawn, and its statistics and
    both eval modes equal JAX's."""
    jbs, stacked, tb0 = _stacked(mol[2])
    cfg_kw = dict(BASE, dropout=0.5, graph_pooling="mean")
    jm, params, stats = _init(cfg_kw, jbs[0])
    port = _port(cfg_kw, params, stats)
    state = port.rng.get_state()
    _refresh_then_eval(jm, params, stats, jbs, port, stacked, tb0)
    assert torch.equal(port.rng.get_state(), state)


def test_nested_gin_eff_dropout_eval_parity(mol):
    """NestedGIN_eff at dropout 0.5 on the dedup layout (JAX runs the z
    MLP on the edges there too): refresh and eval in both BatchNorm modes
    (rtol 1e-5); no mask drawn outside train()."""
    jbs, stacked, tb0 = _stacked(mol[2])
    cfg_kw = dict(hidden=16, num_layers=2, dropout=0.5, graph_pred=True,
                  out_dim=2, head_order="dropout_act")
    jm = JNestedGINEff(JNGConfig(**cfg_kw))
    v = jm.init(jax.random.key(0), jbs[0])
    params, stats = _np_tree(v["params"]), _random_stats(v["batch_stats"])
    port = NestedGINEff(NestedGINEffConfig(**cfg_kw), in_dim=9, device="cpu")
    load_flax_variables(port, params, stats)
    assert port.generators() == [port.rng]
    state = port.rng.get_state()
    _refresh_then_eval(jm, params, stats, jbs, port, stacked, tb0)
    assert torch.equal(port.rng.get_state(), state)


def test_bf16_conv_stack(mol):
    """compute_dtype bfloat16 against JAX's bf16 stack at dropout 0, eval
    on the running statistics and on the batch's own, each on a fresh
    model: within 1e-5 of the largest logit. Both round the conv inputs
    and the one-hot aggregation to bf16 at the same places and promote
    the GIN update back to f32; the differences measured on this input
    are 4.5e-7 (running) and 2.9e-7 (batch). The stack did run in bf16:
    its logits differ from the f32 model's."""
    jb, tb, _ = mol
    cfg_kw = dict(BASE, dropout=0.0, compute_dtype="bfloat16")
    jm, params, stats = _init(cfg_kw, jb)
    f32 = dict(cfg_kw, compute_dtype="float32")
    for running in (True, False):
        got = _port_logits(_port(cfg_kw, params, stats), tb, running)
        assert got.dtype == np.float32
        _close(got, _jax_logits(jm, params, stats, jb, running))
        assert not np.array_equal(
            got, _port_logits(_port(f32, params, stats), tb, running))


def test_dropout_semantics():
    """Inverted scaling (kept entries x / keep, the rest 0), the keep
    rate within 5 standard deviations of its binomial mean, the same mask
    from the same generator state, and identity in eval or at rate 0."""
    g = torch.Generator().manual_seed(0)
    x = torch.full((200, 500), 3.0)
    state = g.get_state()
    y = dropout(x, 0.3, g, training=True)
    scaled = torch.tensor(3.0) / 0.7
    assert set(torch.unique(y).tolist()) == {0.0, scaled.item()}
    n, keep = x.numel(), 0.7
    kept = int((y != 0).sum())
    assert abs(kept - n * keep) < 5 * np.sqrt(n * keep * (1 - keep))
    g.set_state(state)
    assert torch.equal(dropout(x, 0.3, g, training=True), y)
    assert not torch.equal(dropout(x, 0.3, g, training=True), y)
    assert dropout(x, 0.3, g, training=False) is x
    assert dropout(x, 0.0, g, training=True) is x
    assert torch.equal(dropout(x, 1.0, g, training=True), torch.zeros_like(x))


def test_mlp_dropout_precedes_each_batchnorm():
    """flax's MLP order, Dropout -> BN -> act in every block (first with
    pre_act): at rate 1 each BatchNorm sees zeros, so the output is
    act(bias of the last BN) on every row; in eval() the generator is not
    touched."""
    g = torch.Generator().manual_seed(1)
    mlp = MLP(4, (5, 3), F.relu, pre_act=True, dropout=1.0, rng=g,
              generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mlp.MaskedBatchNorm_2.bias.copy_(torch.tensor([0.5, -1.0, 2.0]))
    out = mlp.train()(torch.randn(7, 4))
    torch.testing.assert_close(out, F.relu(mlp.MaskedBatchNorm_2.bias)
                               .expand(7, 3).detach())
    state = g.get_state()
    mlp.eval()(torch.randn(7, 4))
    assert torch.equal(g.get_state(), state)


def test_rni_and_generators(mol):
    """`rni` adds U(-1, 1) noise in train() only; a model lists its
    generator only when it draws (dropout > 0 or rni), and the pool
    step's snapshot puts the generator back."""
    _, tb, _ = mol
    m = OgbGNN(OgbGNNConfig(**BASE, dropout=0.0, rni=True), device="cpu")
    assert m.generators() == [m.rng]
    assert OgbGNN(OgbGNNConfig(**BASE, dropout=0.0),
                  device="cpu").generators() == []
    with torch.no_grad():
        m.eval()
        assert torch.equal(m(tb), m(tb))
        opt = adam_with_plateau(m.parameters(), LR)
        snap = tloop._snapshot(m, opt)
        m.train()
        a = m(tb)
        assert not torch.equal(a, m(tb))
        tloop._restore_in_place(m, opt, snap)
        torch.testing.assert_close(m(tb), a, rtol=0, atol=0)


def _two_level(jb, tb):
    """The ragged batch as a two-level one: each graph's nodes split into
    two copies by the parity of their local index (a copy's root is its
    first node), both copies of graph g pointing at g."""
    nl, ng = np.asarray(tb.node_local), np.asarray(tb.node_graph)
    seg = (2 * ng + nl % 2).astype(np.int32)
    G = tb.num_graphs
    sg = np.repeat(np.arange(G, dtype=np.int32), 2)
    sm = np.ones(2 * G, bool)
    jb2 = jb.replace(node_segment=jnp.asarray(seg),
                     segment_graph=jnp.asarray(sg),
                     segment_mask=jnp.asarray(sm))
    tb2 = dataclasses.replace(tb, node_segment=torch.from_numpy(seg),
                              segment_graph=torch.from_numpy(sg),
                              segment_mask=torch.from_numpy(sm))
    return jb2, tb2


@pytest.mark.parametrize("subpool", ["sum", "mean", "max", "attention",
                                     "center", "combine"])
def test_two_level_subgraph_pooling(subpool):
    """OgbGNN's subgraph pooling over a two-level copy batch, then mean
    graph pooling over the copy rows: eval logits in both BatchNorm modes
    at rtol 1e-5; the virtual node reaches each copy's root only under
    center pooling."""
    jb, tb, _ = _batches("mol", "ragged")
    jb2, tb2 = _two_level(jb, tb)
    _check_eval_parity(dict(BASE, dropout=0.0, graph_pooling="mean",
                            subgraph_pooling=subpool), jb2, tb2)


def test_pool_step_trains_with_dropout(mol):
    """Two eager pool epochs at dropout 0.5: the train-mode forwards draw
    from the model's generator (its state moves), the loss is finite."""
    _, _, (jg, tg, js, ts) = mol
    m = OgbGNN(OgbGNNConfig(**BASE, dropout=0.5), device="cpu")
    opt = adam_with_plateau(m.parameters(), LR)
    pool = stack_split(tg, BatchSpec.uniform(tg, 3, enc_layout="dedup"),
                       device="cpu")
    step = tloop.make_pool_train_step(m, opt, bce_graph_loss, pool)
    state = m.rng.get_state()
    losses = torch.cat([step(pool, [0, 1]), step(pool, [1, 0])])
    assert torch.isfinite(losses).all()
    assert not torch.equal(m.rng.get_state(), state)


def test_weight_rules():
    """The loader's OgbGNN rules: a FeatureSumEncoder table `emb_<i>/
    embedding` is the parameter `emb_<i>`; a 3-D conv kernel (width, in,
    out) is permuted to (out, in, width); `mlp_virtualnode_<i>` keeps its
    name while a top-level `MLP_<i>` still moves into its conv."""
    k3 = np.arange(5 * 2 * 3, dtype=np.float32).reshape(5, 2, 3)
    k2 = np.arange(6, dtype=np.float32).reshape(2, 3)
    sd = flax_to_state_dict({
        "gnn_node": {"node_encoder": {"emb_3": {"embedding": k2}},
                     "mlp_virtualnode_0": {"TorchDense_0": {"kernel": k2}}},
        "conv1d_params2": {"kernel": k3},
        "MLP_0": {"TorchDense_0": {"kernel": k2}},
    }, {})
    assert set(sd) == {"gnn_node.node_encoder.emb_3",
                       "gnn_node.mlp_virtualnode_0.TorchDense_0.weight",
                       "conv1d_params2.weight", "conv1.mlp.TorchDense_0.weight"}
    assert torch.equal(sd["gnn_node.node_encoder.emb_3"], torch.tensor(k2))
    assert torch.equal(sd["conv1d_params2.weight"],
                       torch.tensor(k3).permute(2, 1, 0))
    assert torch.equal(sd["conv1.mlp.TorchDense_0.weight"],
                       torch.tensor(k2).T)


def test_flag_perturb_equals_jax(mol):
    """FLAG's input hook: a numpy-drawn (N, emb_dim) `perturb` added to h0
    gives JAX's eval logits in both BatchNorm modes (rtol 1e-5) and JAX's
    gradient with respect to the perturbation (within 1e-4 of its norm);
    a zero perturbation equals none, bit for bit."""
    jb, tb, _ = mol
    cfg_kw = dict(BASE, dropout=0.0)
    jm, params, stats = _init(cfg_kw, jb)
    m = _port(cfg_kw, params, stats)
    p = np.random.default_rng(9).normal(
        size=(tb.num_nodes, BASE["emb_dim"])).astype(np.float32)

    def j_obj(q):
        return jnp.sum(jm.apply({"params": params, "batch_stats": stats}, jb,
                                perturb=q) ** 2)

    want_g = np.asarray(jax.grad(j_obj)(jnp.asarray(p)))
    q = torch.tensor(p, requires_grad=True)
    m.eval()
    (m(tb, perturb=q) ** 2).sum().backward()
    assert np.linalg.norm(q.grad.numpy() - want_g) <= 1e-4 * np.linalg.norm(
        want_g)
    with torch.no_grad():
        assert torch.equal(m(tb, perturb=torch.zeros_like(q)), m(tb))
    # batch statistics last: that pass updates the running ones
    for running in (True, False):
        want = jm.apply({"params": params, "batch_stats": stats}, jb,
                        use_running_average=running, perturb=jnp.asarray(p),
                        mutable=False if running else ["batch_stats"])
        want = np.asarray(want if running else want[0])
        with torch.no_grad(), bn_statistics(m, use_running_average=running):
            _close(m(tb, perturb=torch.from_numpy(p)).numpy(), want)


def test_skip_node_encoder_equals_jax(mol):
    """`skip_node_encoder`: h0 is the raw float x (emb_dim = its 9
    columns), no node encoder exists on either side, and the eval logits
    equal JAX's at rtol 1e-5."""
    jb, tb, _ = mol
    cfg_kw = dict(BASE, emb_dim=9, dropout=0.0, skip_node_encoder=True)
    jb = jb.replace(x=jb.x.astype(jnp.float32))
    tb = dataclasses.replace(tb, x=tb.x.to(torch.float32))
    jm, params, stats = _init(cfg_kw, jb)
    assert "node_encoder" not in params["gnn_node"]
    m = _port(cfg_kw, params, stats)
    assert not any("node_encoder" in k for k in m.state_dict())
    for running in (True, False):
        _close(_port_logits(m, tb, running),
               _jax_logits(jm, params, stats, jb, running))
