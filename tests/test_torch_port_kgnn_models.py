"""KGNN (k1 / k12 / k13 / k123) of the PyTorch port against the JAX
package, on the CPU, on carried flax weights (drawn with numpy,
`test_torch_port_zoo.py` `numpy_variables`): the forward at rtol 1e-5 of
the largest output and every gradient of the MSE loss at rtol 1e-4 (atol
1e-6 of the largest), in f32, on the batches of
`test_torch_port_kgnn.py` (synthetic QM9 molecules, h-2 node copies with
their k-set graphs for the nested models).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.models.kgnn_models import KGNN as JKGNN
from escgnn_tpu.models.kgnn_models import KGNNConfig as JKGNNConfig
from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.models.kgnn_models import KGNN, KGNNConfig
from escgnn_tpu_torch.weights import flax_to_state_dict, load_flax_variables
from tests.test_torch_port_kgnn import BS, _kset_graphs
from tests.test_torch_port_zoo import jax_run, numpy_variables


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


MODELS = {"k1_GNN": (), "k12_GNN": (2,), "k13_GNN": (3,),
          "k123_GNN": (2, 3)}


def _cfg(levels):
    nested = bool(levels)
    return dict(levels=levels, use_rd=nested, use_pos=True, nested=nested)


def _model_pair(levels, tb_graph, jb):
    jm = JKGNN(JKGNNConfig(**_cfg(levels)))
    params = numpy_variables(jm, jb)["params"]
    m = KGNN(KGNNConfig(**_cfg(levels)), x_dim=tb_graph.x.shape[1],
             edge_dim=tb_graph.edge_attr.shape[1],
             has_pos=tb_graph.pos is not None, device="cpu")
    load_flax_variables(m, params, {})
    return jm, params, m


def _mse(out, y, graph_mask):
    m = graph_mask[:, None]
    return ((out - y) ** 2 * m).sum() / m.sum()


@pytest.mark.parametrize("name", list(MODELS))
def test_kgnn_forward_and_gradients(name):
    """Logits at rtol 1e-5 (of the largest) and every MSE-loss gradient at
    rtol 1e-4 (atol 1e-6 of the largest gradient) on carried weights."""
    levels = MODELS[name]
    jg, tg = _kset_graphs(levels)
    js, ts = JBatchSpec.from_graphs(jg, BS), BatchSpec.from_graphs(tg, BS)
    jb = jax.tree.map(jnp.asarray, j_pad_and_batch(jg[:BS], js))
    tb = pad_and_batch(tg[:BS], ts, device="cpu")
    jm, params, m = _model_pair(levels, tg[0], jb)
    y = np.random.default_rng(2).normal(size=(BS, 1)).astype(np.float32)

    def loss_of(p):
        out = jm.apply({"params": p}, jb)
        return _mse(out, jnp.asarray(y),
                    jb.graph_mask.astype(jnp.float32)), out

    (jloss, want_out), jgrads = jax_run(
        jax.value_and_grad(loss_of, has_aux=True), params)
    want_out = np.asarray(want_out)
    out = m(tb)
    loss = _mse(out, torch.from_numpy(y), tb.graph_mask.float())
    loss.backward()
    scale = np.abs(want_out).max()
    np.testing.assert_allclose(out.detach().numpy() / scale,
                               want_out / scale, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jgrads), {})
    got = {k: p.grad for k, p in m.named_parameters()}
    assert set(got) == set(want)
    gmax = max(float(v.abs().max()) for v in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6 * gmax, err_msg=k)
