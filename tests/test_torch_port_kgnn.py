"""The k-GNN family of the PyTorch port against the JAX package, on the CPU.

Compared:
  * the native k-set enumeration (`native/kgnn`): all eight {2, 3} x
    {local, malkin} x {all, connected} variants and `assignment_2to3`,
    bit for bit, on numpy-seeded random labelled graphs;
  * `attach_kset_graphs` on the node-copies graphs of synthetic QM9
    molecules (h 2, with resistance distances), bit for bit;
  * the k-set batch fields and budgets (`kset{k}_*`, `assign_2to3_*`), a
    full batch and a short padded one, bit for bit;
  * padding invariance: the same graphs under a spec with larger budgets
    give KGNN k123 the same outputs.
KGNN against the JAX model on carried weights is
`test_torch_port_kgnn_models.py`'s.
"""

import dataclasses

import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.qm9 import append_distance_edge_attr as j_distance
from escgnn_tpu.data.qm9 import synthetic_qm9 as j_synthetic_qm9
from escgnn_tpu.featurize import node_subgraphs as j_node
from escgnn_tpu.featurize.kset import attach_kset_graphs as j_attach
from escgnn_tpu.native import kgnn as j_kgnn
from escgnn_tpu_torch.data.batching import BatchSpec, batch_arrays, pad_and_batch
from escgnn_tpu_torch.data.qm9 import append_distance_edge_attr, synthetic_qm9
from escgnn_tpu_torch.featurize import node_subgraphs
from escgnn_tpu_torch.featurize.kset import attach_kset_graphs
from escgnn_tpu_torch.models.kgnn_models import KGNN, KGNNConfig
from escgnn_tpu_torch.native import kgnn

BS = 3


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _random_graphs(seed=0, count=4):
    """(num_nodes, edge_index, labels) of small random undirected graphs
    with 5 node labels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        n = int(rng.integers(5, 11))
        upper = np.triu(rng.random((n, n)) < 0.35, k=1)
        a, b = np.nonzero(upper | upper.T)
        out.append((n, np.stack([a, b]).astype(np.int32),
                    rng.integers(0, 5, n)))
    return out


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("malkin", [False, True])
@pytest.mark.parametrize("connected", [False, True])
def test_native_set_graph_bit_equal(k, malkin, connected):
    """Every variant's set-graph edges, assignment and iso types (and
    their dtypes) equal the JAX package's native core's."""
    for n, ei, lab in _random_graphs(k + 2 * malkin + 4 * connected):
        got = kgnn.kgnn_set_graph(ei, lab, 5, n, k=k, connected=connected,
                                  malkin=malkin)
        want = j_kgnn.kgnn_set_graph(ei, lab, 5, n, k=k,
                                     connected=connected, malkin=malkin)
        for f in ("edge_index", "assignment", "iso_type"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert got.iso_type.size > 0


def test_native_assignment_2to3_and_input_checks():
    """`assignment_2to3` equals JAX's; out-of-range edges, a label count
    that is not the node count and a k outside {2, 3} raise before the
    native code runs."""
    for n, ei, _ in _random_graphs(9):
        got = kgnn.kgnn_assignment_2to3(ei, n)
        want = j_kgnn.kgnn_assignment_2to3(ei, n)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    n, ei, lab = _random_graphs(9)[0]
    with pytest.raises(ValueError, match="out of range"):
        kgnn.kgnn_set_graph(ei, lab[:-1], 5, n - 1)
    with pytest.raises(ValueError, match="labels"):
        kgnn.kgnn_set_graph(ei, lab[:-1], 5, n)
    with pytest.raises(ValueError, match="k = 4"):
        kgnn.kgnn_set_graph(ei, lab, 5, n, k=4)
    with pytest.raises(ValueError, match="out of range"):
        kgnn.kgnn_assignment_2to3(ei, n - 1)


def test_library_builds_into_the_port_build_dir():
    """The port's library is built from its own copy of the source into
    the package's build directory, never beside the JAX package."""
    from escgnn_tpu_torch._build import BUILD_DIR

    kgnn._load()
    assert kgnn._LIB == f"{BUILD_DIR}/libkgnn.so"
    assert kgnn._SRC.endswith("escgnn_tpu_torch/native/kgnn.cpp")
    with open(kgnn._SRC) as f, open(j_kgnn._SRC) as g:
        assert f.read() == g.read()


_GRAPHS = {}


def _kset_graphs(levels):
    """(JAX graphs, port graphs): 5 synthetic QM9 molecules with distance
    edges; for k-set levels, their h-2 node copies with the k-set graphs
    attached (Malkin, the default connectivity)."""
    if levels not in _GRAPHS:
        jg = [j_distance(g) for g in j_synthetic_qm9(5, 1)]
        tg = [append_distance_edge_attr(g) for g in synthetic_qm9(5, 1)]
        if levels:
            jc = j_node.NodeSubgraphConfig(h=2, use_rd=True)
            tc = node_subgraphs.NodeSubgraphConfig(h=2, use_rd=True)
            jg = [j_attach(j_node.create_node_subgraphs(g, jc), ks=levels)
                  for g in jg]
            tg = [attach_kset_graphs(node_subgraphs.create_node_subgraphs(
                g, tc), ks=levels) for g in tg]
        _GRAPHS[levels] = (jg, tg)
    return _GRAPHS[levels]


@pytest.mark.parametrize("levels,connected", [
    ((2,), None), ((3,), None), ((2, 3), None), ((2, 3), True),
    ((2, 3), {2: True, 3: False})])
def test_attach_kset_graphs_bit_equal(levels, connected):
    """Every extra of the k-set attachment (per-copy enumeration, offset
    set ids, owning copies, the 2-to-3 incidences) equals JAX's."""
    jg, tg = _kset_graphs(())
    jc = j_node.NodeSubgraphConfig(h=2, use_rd=True)
    tc = node_subgraphs.NodeSubgraphConfig(h=2, use_rd=True)
    for a, b in zip(jg[:3], tg[:3]):
        want = j_attach(j_node.create_node_subgraphs(a, jc), ks=levels,
                        connected=connected)
        got = attach_kset_graphs(node_subgraphs.create_node_subgraphs(b, tc),
                                 ks=levels, connected=connected)
        assert set(got.extras) == set(want.extras)
        for k, v in want.extras.items():
            assert np.asarray(got.extras[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got.extras[k], v, err_msg=k)
    # a graph without copies is one range
    got = attach_kset_graphs(tg[0], ks=(2,))
    want = j_attach(jg[0], ks=(2,))
    np.testing.assert_array_equal(got.extras["kset2_edge_index"],
                                  want.extras["kset2_edge_index"])


_SPEC_FIELDS = ("num_graphs", "num_nodes", "num_edges", "num_segments",
                "num_kset2", "num_kset2_edges", "num_kset2_assign",
                "num_kset3", "num_kset3_edges", "num_kset3_assign",
                "num_assign_2to3", "max_nodes_per_graph")


def _jax_arrays(jbatch) -> dict:
    out = {k: np.asarray(v) for k, v in vars(jbatch).items()
           if v is not None and hasattr(v, "shape")}
    out.update({"extras." + k: np.asarray(v)
                for k, v in (jbatch.extras or {}).items()})
    return out


@pytest.mark.parametrize("levels", [(2,), (3,), (2, 3)])
def test_kset_batches_bit_equal(levels):
    """The k-set budgets and every field and extra of a full batch and a
    short padded one equal JAX's `pad_and_batch`."""
    jg, tg = _kset_graphs(levels)
    js, ts = JBatchSpec.from_graphs(jg, BS), BatchSpec.from_graphs(tg, BS)
    for f in _SPEC_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    for lo, hi in ((0, BS), (3, 5)):
        got = batch_arrays(tg[lo:hi], ts)
        want = _jax_arrays(j_pad_and_batch(jg[lo:hi], js))
        assert set(got) == set(want)
        assert sum(k.startswith("extras.kset") for k in got) == (
            10 * len(levels))
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_kgnn_padding_invariance():
    """k123 on the same graphs under the dataset spec and under a spec
    with twice the batch budgets: the real graphs' outputs agree (rtol
    1e-6), the padded rows change nothing."""
    jg, tg = _kset_graphs((2, 3))
    small = BatchSpec.from_graphs(tg, BS)
    big = BatchSpec.from_graphs(tg, 2 * BS)
    big = dataclasses.replace(big, num_graphs=BS)
    m = KGNN(KGNNConfig(levels=(2, 3), use_rd=True, use_pos=True),
             x_dim=tg[0].x.shape[1],
             edge_dim=tg[0].edge_attr.shape[1], has_pos=False, device="cpu",
             generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a = m(pad_and_batch(tg[:BS], small, device="cpu"))
        b = m(pad_and_batch(tg[:BS], big, device="cpu"))
    assert big.num_kset2 > small.num_kset2
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
