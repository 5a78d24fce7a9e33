"""The port's pool step, BN refresh and pool eval against the JAX
package's jitted pool functions, in f32 on the CPU.

One flax init is carried into the port (`weights.py`); both packages
build their own stacked pool from the same graphs and seed (equal, see
test_torch_port_pools.py) and run the same epochs in the same fixed
order. On the CPU the port's pool step runs eager train steps; the CUDA
graph that replaces them on a card is checked by `chip_smoke.py`
`[pool_graph]`.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.molecules import synthetic_zinc as j_synthetic_zinc
from escgnn_tpu.data.prefetch import stacked_batch_pools as j_stacked_pools
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu.models.nested_gin_eff import NestedGINEff as JNestedGINEff
from escgnn_tpu.models.nested_gin_eff import NestedGINEffConfig as JConfig
from escgnn_tpu.train.loop import (
    TrainState,
    adam_with_plateau as j_adam,
    l1_graph_loss as j_l1_graph,
    make_pool_eval_step as j_make_pool_eval_step,
    make_pool_refresh_step as j_make_pool_refresh_step,
    make_pool_train_step as j_make_pool_train_step,
    set_learning_rate as j_set_learning_rate,
)
from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.molecules import synthetic_zinc
from escgnn_tpu_torch.data.prefetch import pool_entry, stacked_batch_pools
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.train.loop import (
    ClippedAdam,
    adam_with_plateau,
    bn_stats,
    eval_step,
    get_learning_rate,
    l1_graph_loss,
    make_pool_eval_step,
    make_pool_refresh_step,
    make_pool_train_step,
    set_learning_rate,
)
from escgnn_tpu_torch.weights import flax_to_state_dict, load_flax_variables
from tests.test_torch_port_model import LR, _noise_atol

CFG = dict(
    hidden=16, num_layers=2, act="elu", graph_pred=True, pool="add",
    use_x_embedding_jk=False, head_order="dropout_act",
    node_embed_vocab=100, node_embed_dim=8,
    edge_embed_vocab=100, edge_embed_dim=8,
)
ORDER_1, ORDER_2 = [2, 0, 1], [1, 2, 0]
CLIP = 0.05  # well under the first batch's gradient norm (checked)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """12 graphs in 3 batches of 4; each package's pool (k=1, seed 0) and
    one flax init."""
    jg = j_featurize_many(j_synthetic_zinc(12, seed=4), JEscConfig(h=2))
    tg = featurize_many(synthetic_zinc(12, seed=4), EscConfig(h=2))
    jspec = JBatchSpec.uniform(jg, 4, enc_layout="dedup")
    spec = BatchSpec.uniform(tg, 4, enc_layout="dedup")
    jpools, n, _ = j_stacked_pools(jg, jspec, k=1, seed=0)
    pools, _, _ = stacked_batch_pools(tg, spec, k=1, seed=0,
                                     device="cpu")
    jmodel = JNestedGINEff(JConfig(**CFG))
    first = jax.tree.map(lambda a: a[0], jpools[0])
    variables = jax.jit(jmodel.init)(jax.random.key(0), first)
    return dict(jmodel=jmodel, jpool=jpools[0], pool=pools[0], n=n,
                params=_np_tree(variables["params"]),
                stats=_np_tree(variables["batch_stats"]))


def _port_model(s):
    model = NestedGINEff(NestedGINEffConfig(**CFG), device="cpu")
    load_flax_variables(model, s["params"], s["stats"])
    return model


def _global_grad_norm(s) -> float:
    model = _port_model(s)
    model.train()
    b = pool_entry(s["pool"], ORDER_1[0])
    l1_graph_loss(model(b), b).backward()
    return float(torch.sqrt(sum((p.grad ** 2).sum()
                                for p in model.parameters())))


@pytest.mark.parametrize("grad_clip", [0.0, CLIP])
def test_pool_epochs_match_jax(setup, grad_clip):
    """Two epochs over the 3-batch pool in fixed orders, the learning rate
    halved between them (set_learning_rate on both sides). Per-step losses
    at rtol 1e-5 on the first step and 1e-4 after; parameters and running
    statistics after the first epoch at rtol 1e-4, atol 2e-6, except where
    Adam amplifies f32 noise (`_noise_atol`). With clipping the first
    batch's gradient norm is far above the clip, so every step clips."""
    s = setup
    if grad_clip:
        assert _global_grad_norm(s) > 5 * grad_clip
    state = TrainState.create(jax.tree.map(jnp.asarray, s["params"]),
                              jax.tree.map(jnp.asarray, s["stats"]),
                              j_adam(LR, grad_clip=grad_clip))
    jstep = j_make_pool_train_step(s["jmodel"], j_l1_graph)
    state, jl1 = jstep(state, s["jpool"], jnp.asarray(ORDER_1),
                       jax.random.key(1))
    after_1 = flax_to_state_dict(_np_tree(state.params),
                                 _np_tree(state.batch_stats))
    state = j_set_learning_rate(state, LR / 2)
    state, jl2 = jstep(state, s["jpool"], jnp.asarray(ORDER_2),
                       jax.random.key(1))

    model = _port_model(s)
    opt = adam_with_plateau(model.parameters(), LR, grad_clip=grad_clip)
    step = make_pool_train_step(model, opt, l1_graph_loss, s["pool"])
    l1 = step(s["pool"], np.asarray(ORDER_1))
    assert l1.shape == (3,)
    sd = copy.deepcopy(model.state_dict())
    set_learning_rate(opt, LR / 2)
    assert get_learning_rate(opt) == LR / 2
    l2 = step(s["pool"], ORDER_2)

    got = torch.cat([l1, l2]).numpy()
    want = np.concatenate([np.asarray(jl1), np.asarray(jl2)])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert set(sd) == set(after_1)
    for k, v in after_1.items():
        atol = _noise_atol(k)
        if atol is not None:
            assert np.abs(sd[k].numpy() - v.numpy()).max() <= atol, k
        else:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=2e-6, err_msg=k)


def test_pool_refresh_matches_jax(setup):
    """The exact-average refresh over the pool's 3 batches, from the init
    statistics: every running statistic at rtol 1e-5 (atol 1e-6: the
    moments are recovered from one momentum update, which scales the
    update's rounding by 10)."""
    s = setup
    want = j_make_pool_refresh_step(s["jmodel"])(s["stats"], s["params"],
                                                 s["jpool"])
    want = flax_to_state_dict({}, _np_tree(want))
    model = _port_model(s)
    make_pool_refresh_step(model)(s["pool"])
    got = bn_stats(model)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert not torch.equal(got[k], torch.ones_like(got[k]))


@pytest.mark.parametrize("bn_mode", ["running", "batch"])
def test_pool_eval_matches_jax(setup, bn_mode):
    """(sum |err|, count) over the pool at rtol 1e-5, in both BN modes;
    "batch" normalizes with each batch's statistics and leaves the running
    statistics as they were."""
    s = setup
    e, c = j_make_pool_eval_step(s["jmodel"], node_level=False,
                                 bn_mode=bn_mode)(s["params"], s["stats"],
                                                  s["jpool"])
    model = _port_model(s)
    before = bn_stats(model)
    ge, gc = make_pool_eval_step(model, node_level=False,
                                 bn_mode=bn_mode)(s["pool"])
    np.testing.assert_allclose(float(ge), float(e), rtol=1e-5)
    assert float(gc) == float(c)
    after = bn_stats(model)
    assert all(torch.equal(before[k], after[k]) for k in before)
    other = make_pool_eval_step(model, node_level=False,
                                bn_mode="batch" if bn_mode == "running"
                                else "running")(s["pool"])[0]
    assert not np.isclose(float(other), float(ge), rtol=1e-3)


def test_batch_statistics_run_in_eval_mode(setup):
    """BatchNorm's statistics mode is its own flag: batch-mode eval and
    the refresh run every module in `eval()` (JAX's deterministic=True,
    so a ported dropout stays off) with BN on batch statistics. The
    batch-mode error equals a `train()` forward's on a copy (rtol 1e-6);
    the running statistics and each BN's mode are put back; `train()` and
    `eval()` still set BN's mode by default."""
    from escgnn_tpu_torch.models.layers import (
        MaskedBatchNorm,
        set_use_running_average,
    )

    s = setup
    model = _port_model(s)
    b = pool_entry(s["pool"], 0)
    seen = []
    for m in model.modules():
        m.register_forward_pre_hook(lambda mod, args: seen.append(mod.training))
    bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    model.eval()
    assert all(m.use_running_average for m in bns)
    before = bn_stats(model)
    err, _ = eval_step(model, b, node_level=False, bn_mode="batch")
    assert seen and not any(seen)
    assert not model.training and all(m.use_running_average for m in bns)
    after = bn_stats(model)
    assert all(torch.equal(before[k], after[k]) for k in before)
    ref = copy.deepcopy(model).train()
    with torch.no_grad():
        want = l1_graph_loss(ref(b), b) * b.graph_mask.sum()
    np.testing.assert_allclose(float(err), float(want), rtol=1e-6)

    seen.clear()
    make_pool_refresh_step(model)(s["pool"])
    assert seen and not any(seen) and not model.training
    assert not all(torch.equal(before[k], v)
                   for k, v in bn_stats(model).items())
    # the flag alone switches the statistics, whatever `training` says
    model.train()
    assert not any(m.use_running_average for m in bns)
    prev = set_use_running_average(model, True)
    assert model.training and prev == [False] * len(bns)
    with torch.no_grad():
        np.testing.assert_allclose(
            model(b).numpy(), copy.deepcopy(model).eval()(b).numpy(),
            rtol=1e-6)


def test_eval_step_refuses_unknown_bn_mode(setup):
    model = _port_model(setup)
    with pytest.raises(ValueError, match="bn_mode"):
        eval_step(model, pool_entry(setup["pool"], 0), bn_mode="frozen")


def test_learning_rate_tensor_filled_in_place():
    """A device-tensor learning rate (the capturable optimizer's) is
    filled in place, so a captured step reads the new rate; a float one
    is replaced."""
    p = torch.nn.Parameter(torch.zeros(3))
    lr = torch.tensor(1e-3)
    opt = ClippedAdam([p], lr)
    set_learning_rate(opt, 2.5e-4)
    assert opt.param_groups[0]["lr"] is lr
    assert get_learning_rate(opt) == pytest.approx(2.5e-4, rel=1e-7)
    opt_f = adam_with_plateau([p], 1e-3)
    set_learning_rate(opt_f, 2.5e-4)
    assert opt_f.param_groups[0]["lr"] == 2.5e-4
    assert opt_f.grad_clip == 0.0
