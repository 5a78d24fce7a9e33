"""NestedPPGN of the PyTorch port against the JAX package, on the CPU.

Both packages make node-rooted subgraph copies with the original
adjacency of the same numpy-seeded synthetic OGB molecules (4 graphs,
h 2), bit-equal, and batch them (ragged, bit-equal); on carried flax
weights the graph-level logits and log-softmax and the per-subgraph head
agree at rtol 1e-5 of the largest logit, the bf16 block stacks at the
JAX package's bf16 tolerance (rtol 3e-2), and one L1 step's loss and
gradients at 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.molecules import synthetic_ogb_mol as j_synthetic_ogb
from escgnn_tpu.featurize import node_subgraphs as j_node
from escgnn_tpu.models.nested_ppgn import NestedPPGN as JNestedPPGN
from escgnn_tpu.models.nested_ppgn import NestedPPGNConfig as JNPPGNConfig
from escgnn_tpu.train.loop import l1_graph_loss as j_l1_graph_loss
from escgnn_tpu_torch.data.batching import (
    BatchSpec,
    batch_arrays,
    pad_and_batch,
)
from escgnn_tpu_torch.data.molecules import synthetic_ogb_mol
from escgnn_tpu_torch.featurize import node_subgraphs
from escgnn_tpu_torch.models.nested_ppgn import NestedPPGN, NestedPPGNConfig
from escgnn_tpu_torch.train.loop import l1_graph_loss
from escgnn_tpu_torch.weights import flax_to_state_dict
from tests.test_torch_port_copies import (
    _assert_arrays_equal,
    _assert_graph_equal,
    _close,
    _jax_arrays,
    _model_pair,
    _np_tree,
)

CLASSES = (JNestedPPGN, JNPPGNConfig, NestedPPGN, NestedPPGNConfig)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------

_NPPGN = {}


def _nppgn_batches():
    """(JAX batch, port batch, M, in_dim, edge_dim) of 3 node-rooted copy
    sets of OGB molecules with the original adjacency, ragged."""
    if not _NPPGN:
        kw = dict(h=2, use_rd=True, keep_orig_adj=True)
        jg = [j_node.create_node_subgraphs(g, j_node.NodeSubgraphConfig(**kw))
              for g in j_synthetic_ogb(4, seed=0, num_tasks=2)]
        tg = [node_subgraphs.create_node_subgraphs(
            g, node_subgraphs.NodeSubgraphConfig(**kw))
            for g in synthetic_ogb_mol(4, seed=0, num_tasks=2)]
        for a, b in zip(jg, tg):
            _assert_graph_equal(a, b)
        M = max(int(np.bincount(g.extras["node_to_subgraph"]).max())
                for g in tg)
        js, ts = JBatchSpec.from_graphs(jg, 3), BatchSpec.from_graphs(tg, 3)
        _assert_arrays_equal(batch_arrays(tg[1:4], ts),
                             _jax_arrays(j_pad_and_batch(jg[1:4], js)))
        _NPPGN["v"] = (jax.tree.map(jnp.asarray, j_pad_and_batch(jg[:3], js)),
                       pad_and_batch(tg[:3], ts, device="cpu"), M,
                       tg[0].x.shape[1], tg[0].edge_attr.shape[1])
    return _NPPGN["v"]


@pytest.mark.parametrize("variant", [
    {"classify": False}, {"classify": False, "graph_pred": False},
    {"classify": True},
    {"classify": False, "compute_dtype": "bfloat16"}])
def test_nested_ppgn_parity(variant):
    """NestedPPGN logits on carried weights: graph level (logits and
    log-softmax) and the per-subgraph head at rtol 1e-5, the bf16 block
    stacks at the JAX package's bf16 tolerance (rtol 3e-2; measured
    1e-7)."""
    jb, tb, M, in_dim, edge_dim = _nppgn_batches()
    cfg = dict(emb_dim=8, num_rb_layers=2, num_tasks=2, use_rd=True,
               max_nodes_per_subgraph=M, **variant)
    jm, params, _, m = _model_pair(CLASSES, cfg, jb, in_dim=in_dim,
                                   edge_dim=edge_dim)
    want = np.asarray(jm.apply({"params": params}, jb))
    with torch.no_grad():
        got = m(tb).numpy()
    assert got.shape == want.shape
    _close(got, want, 3e-2 if variant.get("compute_dtype") else 1e-5)


def test_nested_ppgn_grads():
    """The NestedPPGN train step: BCE-free L1 over its logits and every
    gradient at rtol 1e-4 (atol 1e-6 of the largest): the trash-slot
    scatters and the clamped gathers give JAX's dropped and clamped
    updates."""
    jb, tb, M, in_dim, edge_dim = _nppgn_batches()
    cfg = dict(emb_dim=8, num_rb_layers=2, num_tasks=1, use_rd=True,
               classify=False, max_nodes_per_subgraph=M)
    jm, params, _, m = _model_pair(CLASSES, cfg, jb, in_dim=in_dim,
                                   edge_dim=edge_dim)
    y = np.random.default_rng(0).normal(size=(jb.num_graphs, 1)).astype(
        np.float32)
    jbb = jb.replace(y=jnp.asarray(y))
    tbb = dataclasses.replace(tb, y=torch.from_numpy(y))
    jloss, jgrads = jax.value_and_grad(
        lambda p: j_l1_graph_loss(jm.apply({"params": p}, jbb), jbb))(params)
    loss = l1_graph_loss(m(tbb), tbb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want_g = flax_to_state_dict(_np_tree(jgrads), {})
    atol = 1e-6 * max(float(w.abs().max()) for w in want_g.values())
    for k, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   rtol=1e-4, atol=atol, err_msg=k)
