"""The PyTorch NestedGIN_eff against the JAX package, in f32 on the CPU.

One flax init per variant (module-scoped) is carried into the port with
`escgnn_tpu_torch.weights`; both packages then run the same batch, made
from numpy on a seed. Compared: eval- and train-mode outputs, the loss,
every parameter gradient, the updated BatchNorm statistics, and the
parameters after 3 Adam steps. JAX runs its plain CPU path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.container import GraphData as JGraphData
from escgnn_tpu.data.molecules import synthetic_zinc as j_synthetic_zinc
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu.models.nested_gin_eff import NestedGINEff as JNestedGINEff
from escgnn_tpu.models.nested_gin_eff import NestedGINEffConfig as JConfig
from escgnn_tpu.train.loop import (
    PlateauScheduler as JPlateauScheduler,
    TrainState,
    adam_with_plateau as j_adam,
    l1_graph_loss as j_l1_graph,
    l1_node_loss as j_l1_node,
    make_train_step,
)
from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.data.molecules import synthetic_zinc
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff, NestedGINEffConfig
from escgnn_tpu_torch.train.loop import (
    PlateauScheduler,
    adam_with_plateau,
    eval_step,
    get_learning_rate,
    l1_graph_loss,
    l1_node_loss,
    set_learning_rate,
    train_step,
)
from escgnn_tpu_torch.weights import flax_to_state_dict, load_flax_variables
from tests.conftest import random_graph

LR = 5e-4
ADAM_STEPS = 3

ZINC = dict(
    hidden=32, num_layers=2, act="elu", graph_pred=True, pool="add",
    use_x_embedding_jk=False, head_order="dropout_act",
    node_embed_vocab=100, node_embed_dim=8,
    edge_embed_vocab=100, edge_embed_dim=8,
)
COUNTING = dict(hidden=32, num_layers=2)


def _zinc_graphs():
    return (j_featurize_many(j_synthetic_zinc(6, seed=3), JEscConfig(h=3)),
            featurize_many(synthetic_zinc(6, seed=3), EscConfig(h=3)))


def _counting_graphs():
    rng = np.random.default_rng(11)
    jg, tg = [], []
    for _ in range(5):
        n, ei = random_graph(rng, max_n=10)
        x = rng.normal(size=(n, 3)).astype(np.float32)
        y = rng.normal(size=(n, 1)).astype(np.float32)
        jg.append(JGraphData(num_nodes=n, edge_index=ei, x=x, y=y))
        tg.append(GraphData(num_nodes=n, edge_index=ei, x=x, y=y))
    from escgnn_tpu.featurize.transform import esc_transform as j_t
    from escgnn_tpu_torch.featurize import esc_transform as t_t

    cfg_j, cfg_t = JEscConfig(h=2), EscConfig(h=2)
    return [j_t(g, cfg_j) for g in jg], [t_t(g, cfg_t) for g in tg]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _run_jax(cfg_kw, jgraphs, node_level, steps=ADAM_STEPS):
    """Everything the tests compare, from the JAX package."""
    spec = JBatchSpec.uniform(jgraphs, len(jgraphs), enc_layout="dedup")
    batch = jax.tree.map(jnp.asarray, j_pad_and_batch(jgraphs, spec))
    model = JNestedGINEff(JConfig(**cfg_kw))
    variables = jax.jit(model.init)(jax.random.key(0), batch)
    params, stats = variables["params"], variables["batch_stats"]
    loss_fn = j_l1_node if node_level else j_l1_graph

    def apply(p, train):
        return model.apply(
            {"params": p, "batch_stats": stats}, batch,
            deterministic=True, use_running_average=not train,
            mutable=["batch_stats"] if train else False,
        )

    out_eval = jax.jit(lambda p: apply(p, False))(params)

    def loss_of(p):
        out, mut = apply(p, True)
        return loss_fn(out, batch), (out, mut)

    (loss, (out_train, mut)), grads = jax.jit(
        jax.value_and_grad(loss_of, has_aux=True))(params)
    res = dict(
        params=_np_tree(params), stats=_np_tree(stats),
        out_eval=np.asarray(out_eval), out_train=np.asarray(out_train),
        new_stats=_np_tree(mut["batch_stats"]), loss=float(loss),
        grads=_np_tree(grads),
    )
    # the jitted step donates (deletes) the state it is given
    state = TrainState.create(params, stats, j_adam(LR))
    step = make_train_step(model, loss_fn)
    for _ in range(steps):
        state, _ = step(state, batch, jax.random.key(1))
    res.update(params_after=_np_tree(state.params),
               stats_after=_np_tree(state.batch_stats))
    return res


def _port_model(cfg_kw, tbatch, jres):
    model = NestedGINEff(NestedGINEffConfig(**cfg_kw),
                         in_dim=tbatch.x.shape[1], device="cpu")
    load_flax_variables(model, jres["params"], jres["stats"])
    return model


@pytest.fixture(scope="module", params=["zinc", "counting"])
def variant(request):
    if request.param == "zinc":
        jg, tg = _zinc_graphs()
        cfg_kw, node_level = ZINC, False
    else:
        jg, tg = _counting_graphs()
        cfg_kw, node_level = COUNTING, True
    spec = BatchSpec.uniform(tg, len(tg), enc_layout="dedup")
    tbatch = pad_and_batch(tg, spec, device="cpu")
    jres = _run_jax(cfg_kw, jg, node_level)
    return dict(cfg_kw=cfg_kw, node_level=node_level, tbatch=tbatch,
                jres=jres, tgraphs=tg,
                loss_fn=l1_node_loss if node_level else l1_graph_loss)


def _named_grads(model):
    return {k: p.grad.detach().numpy() for k, p in model.named_parameters()}


def test_outputs_eval_and_train(variant):
    """Eval (running BN stats) and train (batch stats) outputs; rtol/atol
    1e-5: the same f32 math, summed in another order."""
    jres, tb = variant["jres"], variant["tbatch"]
    model = _port_model(variant["cfg_kw"], tb, jres)
    model.eval()
    with torch.no_grad():
        out_eval = model(tb).numpy()
    np.testing.assert_allclose(out_eval, jres["out_eval"], rtol=1e-5, atol=1e-5)
    model.train()
    with torch.no_grad():
        out_train = model(tb).numpy()
    np.testing.assert_allclose(out_train, jres["out_train"], rtol=1e-5,
                               atol=1e-5)


def test_loss_grads_and_batch_stats(variant):
    """Loss (rtol 1e-5), every parameter gradient (rtol 1e-4, atol 1e-5:
    f32 sums in another order, through up to a dozen layers) and the
    BatchNorm running statistics after one train-mode forward (rtol
    1e-5, atol 1e-6)."""
    jres, tb = variant["jres"], variant["tbatch"]
    model = _port_model(variant["cfg_kw"], tb, jres)
    model.train()
    loss = variant["loss_fn"](model(tb), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jres["loss"], rtol=1e-5)
    want = flax_to_state_dict(jres["grads"], {})
    got = _named_grads(model)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    want_stats = flax_to_state_dict({}, jres["new_stats"])
    sd = model.state_dict()
    for k, v in want_stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def _noise_atol(key: str):
    """Tolerance for tensors that carry Adam's response to f32 noise.

    A bias of a Linear that feeds a BatchNorm has an exactly-zero
    gradient, so both packages compute rounding noise, which Adam
    normalizes to a step of up to lr in either direction: such a bias
    may differ by 2 * steps * lr. The BatchNorm's output does not see the
    bias (it subtracts the mean), but its running mean does, through the
    momentum-0.1 update: 0.1 * 2 * steps * lr. None for other tensors."""
    bound = 2 * ADAM_STEPS * LR
    fed_by_linear = "TorchDense_" in key or key.startswith("lin1.")
    if key.endswith(".bias") and fed_by_linear:
        return bound
    if key.endswith(".running_mean") and not key.startswith(
            "z_embedding.MaskedBatchNorm_0."):
        return 0.1 * bound
    return None


def test_adam_steps(variant):
    """Parameters and running statistics after 3 train steps of Adam at
    lr 5e-4 on the same batch: rtol 1e-4, atol 2e-6, except where Adam
    amplifies f32 noise (see `_noise_atol`)."""
    jres, tb = variant["jres"], variant["tbatch"]
    model = _port_model(variant["cfg_kw"], tb, jres)
    opt = adam_with_plateau(model.parameters(), LR)
    for _ in range(ADAM_STEPS):
        train_step(model, opt, tb, variant["loss_fn"])
    want = flax_to_state_dict(jres["params_after"], jres["stats_after"])
    sd = model.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        atol = _noise_atol(k)
        if atol is not None:
            assert np.abs(sd[k].numpy() - v.numpy()).max() <= atol, k
        else:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=2e-6, err_msg=k)


def test_eval_step_mae(variant):
    """eval_step's (sum |err|, count) equals the JAX eval outputs' MAE
    terms (rtol 1e-5)."""
    jres, tb = variant["jres"], variant["tbatch"]
    model = _port_model(variant["cfg_kw"], tb, jres)
    s, n = eval_step(model, tb, node_level=variant["node_level"])
    mask = (tb.node_mask if variant["node_level"] else tb.graph_mask).numpy()
    want = (np.abs(jres["out_eval"] - tb.y.numpy()) * mask[:, None]).sum()
    np.testing.assert_allclose(float(s), want, rtol=1e-5)
    assert float(n) == mask.sum() * jres["out_eval"].shape[-1]


def test_flagship_bf16_forward():
    """The flagship config (bf16 conv stacks) at small width: train-mode
    outputs against JAX at rtol/atol 3e-2 — both round activations to
    bf16 at the same places (8 mantissa bits, ~4e-3 per rounding), but
    sums in another order can round the other way before the next
    layer."""
    jg, tg = _zinc_graphs()
    cfg_kw = dict(ZINC, compute_dtype="bfloat16")
    spec_j = JBatchSpec.uniform(jg, len(jg), enc_layout="dedup")
    jbatch = jax.tree.map(jnp.asarray, j_pad_and_batch(jg, spec_j))
    jmodel = JNestedGINEff(JConfig(**cfg_kw))
    variables = jax.jit(jmodel.init)(jax.random.key(0), jbatch)
    want, _ = jax.jit(lambda v: jmodel.apply(
        v, jbatch, deterministic=True, use_running_average=False,
        mutable=["batch_stats"]))(variables)
    tb = pad_and_batch(tg, BatchSpec.uniform(tg, len(tg), enc_layout="dedup"),
                       device="cpu")
    model = NestedGINEff(NestedGINEffConfig(**cfg_kw), device="cpu")
    load_flax_variables(model, _np_tree(variables["params"]),
                        _np_tree(variables["batch_stats"]))
    model.train()
    with torch.no_grad():
        got = model(tb)
    assert got.dtype == torch.float32
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale,
                               rtol=3e-2, atol=3e-2)


def test_loader_is_strict(variant):
    """A flax tree with a leaf missing, or an extra one, is refused."""
    jres, tb = variant["jres"], variant["tbatch"]
    model = NestedGINEff(NestedGINEffConfig(**variant["cfg_kw"]),
                         in_dim=tb.x.shape[1], device="cpu")
    params = dict(jres["params"])
    params.pop("lin2")
    with pytest.raises(ValueError, match="lin2"):
        load_flax_variables(model, params, jres["stats"])
    params = dict(jres["params"], extra={"kernel": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="extra"):
        load_flax_variables(model, params, jres["stats"])


def test_unported_options_raise():
    """The sharded modes build (halo together with an edge or data axis
    is refused), a sharded view shares the model's parameters; dropout >
    0 and the QM9 fields build, and `edge_float_attr` asks for the
    edge_attr width."""
    base = NestedGINEffConfig(hidden=8, num_layers=1)
    for kw in (dict(halo_axis="x"), dict(edge_shard_axis="x"),
               dict(edge_shard_axis="m", data_axis="d")):
        m = NestedGINEff(dataclasses.replace(base, **kw), device="cpu")
        assert all(getattr(m.cfg, k) == v for k, v in kw.items())
    with pytest.raises(ValueError, match="halo_axis"):
        NestedGINEff(dataclasses.replace(base, halo_axis="x",
                                         edge_shard_axis="y"), device="cpu")
    plain = NestedGINEff(base, device="cpu")
    view = plain.sharded_view(edge_shard_axis="model")
    assert view.cfg.edge_shard_axis == "model" and plain.cfg == base
    assert all(a is b for a, b in zip(view.parameters(), plain.parameters()))
    dropped = NestedGINEff(dataclasses.replace(base, dropout=0.1),
                           device="cpu")
    assert dropped.generators() == [dropped.rng]
    assert NestedGINEff(base, device="cpu").generators() == []
    qm9 = dataclasses.replace(base, concat_pos=True, node_add_embed_vocab=5,
                              edge_float_attr=True)
    with pytest.raises(ValueError, match="edge_attr_dim"):
        NestedGINEff(qm9, in_dim=11, device="cpu")
    model = NestedGINEff(qm9, in_dim=11, edge_attr_dim=5, device="cpu")
    assert tuple(model.node_type_embedding.weight.shape) == (5, 14)
    assert model.conv1.lin_edge.in_features == 8 + 5


def test_segment_layout_forward_and_grads():
    """The counting variant on a `from_graphs` batch (no uniform blocks:
    GINE aggregates with the masked segment sum) against JAX: train-mode
    output (rtol/atol 1e-5) and gradients (rtol 1e-4, atol 1e-5)."""
    jg, tg = _counting_graphs()
    jspec = JBatchSpec.from_graphs(jg, len(jg), enc_layout="dedup")
    jbatch = jax.tree.map(jnp.asarray, j_pad_and_batch(jg, jspec))
    jmodel = JNestedGINEff(JConfig(**COUNTING))
    variables = jax.jit(jmodel.init)(jax.random.key(0), jbatch)

    def loss_of(p):
        out, _ = jmodel.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, jbatch,
            deterministic=True, use_running_average=False,
            mutable=["batch_stats"])
        return j_l1_node(out, jbatch), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        variables["params"])
    tb = pad_and_batch(tg, BatchSpec.from_graphs(tg, len(tg),
                                                 enc_layout="dedup"),
                       device="cpu")
    assert tb.nodes_per_graph is None
    model = NestedGINEff(NestedGINEffConfig(**COUNTING), in_dim=3,
                         device="cpu")
    load_flax_variables(model, _np_tree(variables["params"]),
                        _np_tree(variables["batch_stats"]))
    model.train()
    out = model(tb)
    l1_node_loss(out, tb).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    want_g = flax_to_state_dict(_np_tree(grads), {})
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_plateau_scheduler_and_learning_rate():
    """The plateau scheduler follows the JAX one on the same metric
    sequence, and its rate reaches the optimizer."""
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 0.91, 0.92, 0.93, 0.8, 0.85,
               0.86, 0.87, 0.88]
    js, ts = JPlateauScheduler(patience=2), PlateauScheduler(patience=2)
    opt = adam_with_plateau([torch.nn.Parameter(torch.zeros(2))], LR)
    jlr = LR
    for m in metrics:
        jlr = js.step(m, jlr)
        set_learning_rate(opt, ts.step(m, get_learning_rate(opt)))
        assert get_learning_rate(opt) == pytest.approx(jlr, rel=1e-12)
    assert jlr < LR
