"""The PyTorch PPGN_eff and the counting dataset against the JAX package,
on the CPU.

The counting graphs and their targets must be bit-equal. For the model,
one flax init per batch layout (module-scoped) is carried into the port
with `escgnn_tpu_torch.weights`; both packages then run the same batch.
Compared in f32: eval- and train-mode outputs (padding rows included),
the loss, every parameter gradient, the BatchNorm statistics, and the
parameters after one Adam step, under both pool impls and the z impls
"countmat", "gather" and "pallas" (the kernels' plain versions here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data import counting as j_counting
from escgnn_tpu.data import graphlets as j_graphlets
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu.models.ppgn import PPGN as JPPGN
from escgnn_tpu.models.ppgn import PPGNConfig as JPPGNConfig
from escgnn_tpu.ops import zemb as j_zemb
from escgnn_tpu.train.loop import TrainState, make_train_step
from escgnn_tpu.train.loop import adam_with_plateau as j_adam
from escgnn_tpu.train.loop import l1_node_loss as j_l1_node
from escgnn_tpu_torch.data import counting, graphlets
from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.models.ppgn import PPGN, PPGNConfig
from escgnn_tpu_torch.ops import zemb
from escgnn_tpu_torch.train.loop import adam_with_plateau, l1_node_loss, train_step
from escgnn_tpu_torch.utils import trace
from escgnn_tpu_torch.weights import flax_to_state_dict, load_flax_variables
from tests.conftest import random_graph

LR = 5e-4
ESC = dict(h=2, use_rd=True, self_loop=True)
PPGN_KW = dict(emb_dim=16, num_rb_layers=2, node_level=True, use_esc=True)


@pytest.mark.parametrize("task", ["cycle", "graphlet"])
def test_counting_graphs_and_targets_bit_equal(task):
    """generate_counting_graphs and normalize_targets equal the JAX
    package's, dtype included, for the same config."""
    kw = dict(num_graphs=12, seed=3, task=task)
    js = j_counting.generate_counting_graphs(
        j_counting.CountingDatasetConfig(**kw))
    ts = counting.generate_counting_graphs(counting.CountingDatasetConfig(**kw))
    for split in js:
        assert len(js[split]) == len(ts[split])
        for a, b in zip(js[split], ts[split]):
            assert a.num_nodes == b.num_nodes
            for f in ("edge_index", "x", "y"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
    jn, jmean, jstd = j_counting.normalize_targets(js, 1)
    tn, tmean, tstd = counting.normalize_targets(ts, 1)
    assert (jmean, jstd) == (tmean, tstd)
    for split in jn:
        for a, b in zip(jn[split], tn[split]):
            assert a.y.dtype == b.y.dtype and a.y.shape == b.y.shape
            np.testing.assert_array_equal(a.y, b.y)
    assert counting.TARGET_COLUMNS == j_counting.TARGET_COLUMNS


def test_count_functions_bit_equal():
    """The per-node cycle and graphlet counts (fast and slow graphlet
    oracles) equal the JAX package's on random graphs."""
    rng = np.random.default_rng(7)
    for _ in range(6):
        n, ei = random_graph(rng, max_n=11)
        np.testing.assert_array_equal(
            counting.count_cycles_per_node(n, ei),
            j_counting.count_cycles_per_node(n, ei))
        want = j_graphlets.count_graphlets_per_node(n, ei)
        np.testing.assert_array_equal(
            graphlets.count_graphlets_per_node(n, ei), want)
        np.testing.assert_array_equal(
            graphlets.count_graphlets_per_node_slow(n, ei), want)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def count_graphs():
    cfg = dict(num_graphs=10, seed=0)
    js, _, _ = j_counting.normalize_targets(
        j_counting.generate_counting_graphs(
            j_counting.CountingDatasetConfig(**cfg)), 0)
    ts, _, _ = counting.normalize_targets(
        counting.generate_counting_graphs(
            counting.CountingDatasetConfig(**cfg)), 0)
    return (j_featurize_many(js["train"][:4], JEscConfig(**ESC)),
            featurize_many(ts["train"][:4], EscConfig(**ESC)))


def _specs(layout, jg, tg):
    if layout == "width":  # the bench's batch (bench.py:484-501)
        return JBatchSpec.from_graphs(jg, 4), BatchSpec.from_graphs(tg, 4)
    # run_graphcount.py's batch
    return (JBatchSpec.uniform(jg, 4, enc_layout="dedup"),
            BatchSpec.uniform(tg, 4, enc_layout="dedup"))


@pytest.fixture(scope="module", params=["width", "dedup"])
def layout(request, count_graphs):
    """Everything the tests compare, from the JAX package, for one batch
    layout. The width batch runs JAX impl "gather" with the backward
    matmul in f32; the dedup batch carries the host count matrix."""
    jg, tg = count_graphs
    jspec, spec = _specs(request.param, jg, tg)
    jbatch = jax.tree.map(jnp.asarray, j_pad_and_batch(jg, jspec))
    tbatch = pad_and_batch(tg, spec, device="cpu")
    max_nodes = max(spec.max_nodes_per_graph, spec.uniform_nodes)
    cfg_kw = dict(PPGN_KW, max_nodes=max_nodes)
    model = JPPGN(JPPGNConfig(**cfg_kw))
    if request.param == "width":
        j_zemb.set_impl("gather")
        j_zemb.set_backward_matmul_dtype(jnp.float32)
    try:
        variables = jax.jit(model.init)(jax.random.key(0), jbatch)
        params, stats = variables["params"], variables["batch_stats"]

        def apply(p, train):
            return model.apply(
                {"params": p, "batch_stats": stats}, jbatch,
                use_running_average=not train,
                mutable=["batch_stats"] if train else False)

        def loss_of(p):
            out, mut = apply(p, True)
            return j_l1_node(out, jbatch), (out, mut)

        out_eval = jax.jit(lambda p: apply(p, False))(params)
        (loss, (out_train, mut)), grads = jax.jit(
            jax.value_and_grad(loss_of, has_aux=True))(params)
        res = dict(
            params=_np_tree(params), stats=_np_tree(stats),
            out_eval=np.asarray(out_eval), out_train=np.asarray(out_train),
            loss=float(loss), grads=_np_tree(grads),
            new_stats=_np_tree(mut["batch_stats"]))
        # the jitted step donates (deletes) the state it is given
        state = TrainState.create(params, stats, j_adam(LR))
        state, _ = make_train_step(model, j_l1_node)(
            state, jbatch, jax.random.key(1))
        res.update(params_after=_np_tree(state.params),
                   stats_after=_np_tree(state.batch_stats))
    finally:
        j_zemb.set_backward_matmul_dtype(jnp.bfloat16)
        j_zemb.set_impl("countmat")
    return dict(name=request.param, cfg_kw=cfg_kw, tbatch=tbatch, jres=res)


def _port_model(layout, **kw):
    model = PPGN(PPGNConfig(**dict(layout["cfg_kw"], **kw)), device="cpu")
    load_flax_variables(model, layout["jres"]["params"],
                        layout["jres"]["stats"])
    return model


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """On CPU tensors no wrapper launches its kernel."""
    yield
    assert (trace.counter("k3.launches"),
            trace.counter("k4.launches")) == (0, 0)


@pytest.mark.parametrize("pool_impl", ["xla", "pallas"])
@pytest.mark.parametrize("impl", ["countmat", "gather", "pallas"])
def test_ppgn_forward_grads_and_stats(layout, pool_impl, impl):
    """Eval and train outputs on every row (rtol/atol 1e-5), the loss
    (rtol 1e-5), every gradient (rtol 1e-4, atol 1e-5 of the largest:
    f32 sums in another order, through a dozen layers; the biases that
    feed a BatchNorm have zero gradients, f32 noise on both sides) and
    the BatchNorm statistics after one train-mode forward (rtol 1e-5,
    atol 1e-6)."""
    jres, tb = layout["jres"], layout["tbatch"]
    if layout["name"] == "dedup" and impl != "countmat":
        # without the host count matrix, so that the z impl reduces the
        # unique rows over the compacted table
        tb = dataclasses.replace(tb, enc_countmat=None)
    N = layout["cfg_kw"]["max_nodes"]
    if layout["name"] == "width":
        # padding nodes lie past the dense grid: the trash slot and the
        # clamped gather are exercised
        assert (tb.node_local[~tb.node_mask] >= N).all()
    model = _port_model(layout, pool_impl=pool_impl)
    zemb.set_impl(impl)
    try:
        model.eval()
        with torch.no_grad():
            out_eval = model(tb)
        model.train()
        out = model(tb)
        loss = l1_node_loss(out, tb)
        loss.backward()
    finally:
        zemb.set_impl("countmat")
    np.testing.assert_allclose(out_eval.numpy(), jres["out_eval"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), jres["out_train"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.item(), jres["loss"], rtol=1e-5)
    want = flax_to_state_dict(jres["grads"], {})
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    gmax = max(np.abs(v.numpy()).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), rtol=1e-4,
                                   atol=1e-5 * gmax, err_msg=k)
    sd = model.state_dict()
    for k, v in flax_to_state_dict({}, jres["new_stats"]).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_ppgn_adam_step(layout):
    """Parameters and running statistics after one train step of Adam at
    lr 5e-4 from the same init: rtol 1e-4, atol 2e-6, except the biases
    that feed a BatchNorm (z_embedding_{0,1}.bias): their gradient is
    exactly zero, both packages compute f32 noise, and Adam normalizes it
    to a step of up to lr in either direction (atol 2 lr)."""
    jres, tb = layout["jres"], layout["tbatch"]
    model = _port_model(layout, pool_impl="pallas")
    opt = adam_with_plateau(model.parameters(), LR)
    train_step(model, opt, tb, l1_node_loss)
    want = flax_to_state_dict(jres["params_after"], jres["stats_after"])
    sd = model.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        if k.startswith("z_embedding_") and k.endswith(".bias"):
            assert np.abs(sd[k].numpy() - v.numpy()).max() <= 2 * LR, k
        else:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=2e-6, err_msg=k)


def test_ppgn_bf16_forward(count_graphs):
    """The bench precision (bf16 regular blocks, f32 head) on the width
    batch with both kernels' plain versions: train-mode outputs against
    JAX at rtol/atol 3e-2 of the output scale — both round activations
    to bf16 at the same places (~4e-3 per rounding), but sums taken in
    another order can round the other way before the next block."""
    jg, tg = count_graphs
    jspec, spec = _specs("width", jg, tg)
    jbatch = jax.tree.map(jnp.asarray, j_pad_and_batch(jg, jspec))
    cfg_kw = dict(PPGN_KW, max_nodes=spec.max_nodes_per_graph,
                  compute_dtype="bfloat16")
    jmodel = JPPGN(JPPGNConfig(**cfg_kw))
    variables = jax.jit(jmodel.init)(jax.random.key(0), jbatch)
    want, _ = jax.jit(lambda v: jmodel.apply(
        v, jbatch, use_running_average=False, mutable=["batch_stats"]))(
            variables)
    model = PPGN(PPGNConfig(pool_impl="pallas", **cfg_kw), device="cpu")
    load_flax_variables(model, _np_tree(variables["params"]),
                        _np_tree(variables["batch_stats"]))
    zemb.set_impl("pallas")
    try:
        with torch.no_grad():
            got = model.train()(pad_and_batch(tg, spec, device="cpu"))
    finally:
        zemb.set_impl("countmat")
    assert got.dtype == torch.float32
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale,
                               rtol=3e-2, atol=3e-2)


def test_ppgn_loader_is_strict(layout):
    """The flax PPGN tree fills every model tensor under the flax names
    (`rb{i}.mlp{1,2}.conv{j}`, `z_bn_{i}`, ...); a missing or an extra
    leaf is refused."""
    jres = layout["jres"]
    model = PPGN(PPGNConfig(**layout["cfg_kw"]), device="cpu")
    sd = flax_to_state_dict(jres["params"], jres["stats"])
    assert set(sd) == set(model.state_dict())
    assert "rb1.mlp2.conv1.weight" in sd and "z_bn_0.running_var" in sd
    params = dict(jres["params"])
    params.pop("fc1")
    with pytest.raises(ValueError, match="fc1"):
        load_flax_variables(model, params, jres["stats"])
    params = dict(jres["params"], extra={"kernel": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="extra"):
        load_flax_variables(model, params, jres["stats"])


def test_ppgn_config_is_checked():
    """Every JAX config field exists here, and unknown impls raise."""
    assert ({f.name for f in dataclasses.fields(PPGNConfig)}
            == {f.name for f in dataclasses.fields(JPPGNConfig)})
    with pytest.raises(ValueError):
        PPGN(PPGNConfig(pool_impl="triton"), device="cpu")
    with pytest.raises(ValueError):
        PPGN(PPGNConfig(compute_dtype="float16"), device="cpu")
