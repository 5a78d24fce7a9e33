"""GINE+ of the PyTorch port against the JAX package, on the CPU.

Compared, on numpy-seeded synthetic OGB molecules:
  * `make_multihop_edges` (k 1, 2, 3), bit for bit, and the batches of
    its graphs (ragged and uniform), bit for bit;
  * `GINEPlusNetwork` on carried flax variables (drawn with numpy: eps
    and the virtual node's v0, which JAX starts at 0, too), on the ragged
    and the
    uniform layout, k 1 and 3, with the virtual node: every conv's output
    (the history mixing of each layer) and the logits at rtol 1e-5 of
    their largest entry, in eval mode at dropout 0.65 and in both
    BatchNorm modes;
  * dropout's draws: train-mode forwards differ, eval is deterministic.
Nested pooling, gradients and bf16 are
`test_torch_port_gine_plus_train.py`'s.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.molecules import synthetic_ogb_mol as j_synthetic_ogb
from escgnn_tpu.featurize import node_subgraphs as j_node
from escgnn_tpu.featurize.multihop import make_multihop_edges as j_multihop
from escgnn_tpu.models.gine_plus import GINEPlusConfig as JGINEPlusConfig
from escgnn_tpu.models.gine_plus import GINEPlusNetwork as JGINEPlusNetwork
from escgnn_tpu_torch.data.batching import BatchSpec, batch_arrays, pad_and_batch
from escgnn_tpu_torch.data.molecules import synthetic_ogb_mol
from escgnn_tpu_torch.featurize import node_subgraphs
from escgnn_tpu_torch.featurize.multihop import make_multihop_edges
from escgnn_tpu_torch.models.gine_plus import GINEPlusConfig, GINEPlusNetwork
from escgnn_tpu_torch.models.layers import bn_statistics
from escgnn_tpu_torch.weights import load_flax_variables
from tests.test_torch_port_zoo import jax_run, numpy_variables

BS = 4
BASE = dict(hidden=16, num_layers=3, out_dim=2, virtual_node=True)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_GRAPHS = {}


def _graphs(k, nested=False):
    """(JAX graphs, port graphs): 6 molecules with their k-hop edges
    (`nested`: of their h-1 node copies)."""
    key = (k, nested)
    if key not in _GRAPHS:
        jg, tg = j_synthetic_ogb(6, seed=2), synthetic_ogb_mol(6, seed=2)
        if nested:
            jg = [j_node.create_node_subgraphs(
                g, j_node.NodeSubgraphConfig(h=1)) for g in jg]
            tg = [node_subgraphs.create_node_subgraphs(
                g, node_subgraphs.NodeSubgraphConfig(h=1)) for g in tg]
        _GRAPHS[key] = ([j_multihop(g, k) for g in jg],
                        [make_multihop_edges(g, k) for g in tg])
    return _GRAPHS[key]


def _jax_arrays(jbatch) -> dict:
    out = {k: np.asarray(v) for k, v in vars(jbatch).items()
           if v is not None and hasattr(v, "shape")}
    out.update({"extras." + k: np.asarray(v)
                for k, v in (jbatch.extras or {}).items()})
    return out


@pytest.mark.parametrize("k", [1, 2, 3])
def test_multihop_edges_and_batches_bit_equal(k):
    """The multihop edge lists, their distances and bond rows, and the
    ragged and uniform batches of them equal JAX's."""
    jg, tg = _graphs(k)
    for a, b in zip(jg, tg):
        for f in ("edge_index", "edge_attr", "x"):
            assert getattr(a, f).dtype == getattr(b, f).dtype, f
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.extras["edge_distance"].dtype == np.int16
        np.testing.assert_array_equal(a.extras["edge_distance"],
                                      b.extras["edge_distance"])
        assert b.extras["edge_distance"].max() <= k
    for ctor in ("from_graphs", "uniform"):
        js = getattr(JBatchSpec, ctor)(jg, BS)
        ts = getattr(BatchSpec, ctor)(tg, BS)
        got = batch_arrays(tg[:BS], ts)
        want = _jax_arrays(j_pad_and_batch(jg[:BS], js))
        assert set(got) == set(want)
        for key, w in want.items():
            np.testing.assert_array_equal(got[key], w, err_msg=key)


_INITS = {}


def _setup(cfg_kw, layout="ragged", k=3, nested=False):
    """(flax model, variables, JAX batch, port model on the carried
    state, port batch); the variables (`numpy_variables`) are cached per
    config."""
    jg, tg = _graphs(k, nested)
    ctor = "uniform" if layout == "uniform" else "from_graphs"
    jb = jax.tree.map(jnp.asarray, j_pad_and_batch(
        jg[:BS], getattr(JBatchSpec, ctor)(jg, BS)))
    tb = pad_and_batch(tg[:BS], getattr(BatchSpec, ctor)(tg, BS),
                       device="cpu")
    cfg = dict(BASE, k=k, **cfg_kw)
    jm = JGINEPlusNetwork(JGINEPlusConfig(**cfg))
    key = (tuple(sorted(cfg.items())), layout, nested)
    if key not in _INITS:
        v = numpy_variables(jm, jb)
        _INITS[key] = (v["params"], v["batch_stats"])
    params, stats = _INITS[key]
    m = GINEPlusNetwork(GINEPlusConfig(**cfg), device="cpu")
    load_flax_variables(m, params, stats)
    return jm, {"params": params, "batch_stats": stats}, jb, m, tb


def _close(got, want, rtol, what=""):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float32) / scale,
                               np.asarray(want, np.float32) / scale,
                               rtol=rtol, atol=rtol, err_msg=what)


def _conv_outputs(m, tb):
    """Logits and each conv's output of a port forward."""
    outs = {}
    hooks = [getattr(m, f"conv{i}").register_forward_hook(
        lambda mod, inp, out, i=i: outs.__setitem__(i, out.detach()))
        for i in range(m.cfg.num_layers)]
    try:
        logits = m(tb).detach()
    finally:
        for h in hooks:
            h.remove()
    return logits, outs


def _check_eval(cfg_kw, layout, k=3, nested=False, rtol=1e-5,
                modes=(True,)):
    """Eval-mode conv outputs and logits against JAX's, under each BN
    statistics mode of `modes` (True: the running statistics)."""
    jm, v, jb, m, tb = _setup(cfg_kw, layout, k, nested)
    m.eval()
    for running in modes:
        out, inter = jax_run(functools.partial(
            jm.apply, use_running_average=running,
            mutable=["intermediates", "batch_stats"],
            capture_intermediates=True), v, jb)
        with torch.no_grad(), bn_statistics(m, use_running_average=running):
            got, convs = _conv_outputs(m, tb)
        inter = inter["intermediates"]
        for i in range(m.cfg.num_layers):
            _close(convs[i].numpy(),
                   np.asarray(inter[f"conv{i}"]["__call__"][0]), rtol,
                   f"conv{i} running={running}")
        _close(got.numpy(), np.asarray(out), rtol, f"logits {running}")


@pytest.mark.parametrize("layout", ["ragged", "uniform"])
@pytest.mark.parametrize("k", [1, 3])
def test_gine_plus_layers_and_logits(layout, k):
    """Each layer's conv output and the logits on carried weights (rtol
    1e-5), eval mode at dropout 0.65, on the running statistics, and for
    k 3 on the batch's own too."""
    _check_eval(dict(dropout=0.65), layout, k,
                modes=(True, False) if k == 3 else (True,))


def test_gine_plus_dropout_draws():
    """In train mode each forward draws new masks from the model's
    generator (and only from it); eval mode draws none."""
    _, _, _, m, tb = _setup(dict(dropout=0.65), "ragged", 3)
    assert m.generators() == [m.rng]
    m.train()
    with torch.no_grad():
        a, b = m(tb), m(tb)
    assert not torch.equal(a, b)
    m.eval()
    state = m.rng.get_state()
    with torch.no_grad():
        c, d = m(tb), m(tb)
    assert torch.equal(c, d) and torch.equal(state, m.rng.get_state())
