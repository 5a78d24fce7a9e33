"""The port's host data layer against the JAX package: bit for bit.

Same graphs (numpy, from a seed) through both packages' featurizers and
batchers; every array must be equal, dtype included.
"""

import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.container import GraphData as JGraphData
from escgnn_tpu.data.molecules import synthetic_zinc as j_synthetic_zinc
from escgnn_tpu.data.molecules import zinc_splits as j_zinc_splits
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.escgnn import esc_encode as j_esc_encode
from escgnn_tpu.featurize.transform import esc_transform as j_esc_transform
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu_torch.data.batching import BatchSpec, batch_arrays, pad_and_batch
from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.data.molecules import synthetic_zinc, zinc_splits
from escgnn_tpu_torch.featurize import EscConfig, esc_encode, esc_transform
from escgnn_tpu_torch.featurize import featurize_many
from escgnn_tpu_torch.native.escfeat import esc_encode_native
from tests.conftest import random_graph

_GRAPH_FIELDS = ("edge_index", "edge_attr", "enc_idx", "enc_cnt",
                 "enc_offsets", "x", "y")
_ENC_FIELDS = ("edge_index", "enc_idx", "enc_cnt", "enc_offsets",
               "self_loop_attr_mask")


def _assert_same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _random_graphs(seed, k=10):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n, ei = random_graph(rng, max_n=12)
        ea = rng.integers(0, 4, ei.shape[1]).astype(np.int32)
        out.append((n, ei, ea))
    return out


@pytest.mark.parametrize("h,use_rd,self_loop", [
    (3, True, True), (2, True, False), (2, False, True),
])
def test_esc_transform_bit_equal(h, use_rd, self_loop):
    """esc_transform (native C++ core first) equals JAX's on 10 random
    graphs: edge_index, edge_attr (self-loop fill), enc_idx/cnt/offsets."""
    jcfg = JEscConfig(h=h, use_rd=use_rd, self_loop=self_loop)
    cfg = EscConfig(h=h, use_rd=use_rd, self_loop=self_loop)
    for n, ei, ea in _random_graphs(h * 7 + use_rd + 2 * self_loop):
        jg = j_esc_transform(JGraphData(num_nodes=n, edge_index=ei,
                                        edge_attr=ea), jcfg)
        g = esc_transform(GraphData(num_nodes=n, edge_index=ei,
                                    edge_attr=ea), cfg)
        for f in ("edge_index", "edge_attr", "enc_idx", "enc_cnt",
                  "enc_offsets"):
            _assert_same_array(getattr(g, f), getattr(jg, f), f)


def test_numpy_and_native_encoders_bit_equal():
    """The port's numpy encoder equals JAX's numpy encoder, and the
    port's native C++ core equals both."""
    jcfg, cfg = JEscConfig(h=3), EscConfig(h=3)
    for n, ei, _ in _random_graphs(5):
        want = j_esc_encode(n, ei, jcfg)
        got = esc_encode(n, ei, cfg)
        native = esc_encode_native(n, ei, cfg)
        assert native is not None
        for f in _ENC_FIELDS:
            _assert_same_array(getattr(got, f), getattr(want, f), f)
            _assert_same_array(getattr(native, f), getattr(want, f), f)


def test_synthetic_zinc_and_splits_equal():
    for jg, g in zip(j_synthetic_zinc(12, seed=4), synthetic_zinc(12, seed=4)):
        assert jg.num_nodes == g.num_nodes
        for f in ("edge_index", "edge_attr", "x", "y"):
            _assert_same_array(getattr(g, f), getattr(jg, f), f)
    jsplits, is_real = j_zinc_splits("/nonexistent", num_graphs=20, seed=1)
    assert not is_real
    splits = zinc_splits(num_graphs=20, seed=1)
    for name in ("train", "val", "test"):
        assert len(splits[name]) == len(jsplits[name])
        for jg, g in zip(jsplits[name], splits[name]):
            _assert_same_array(g.edge_index, jg.edge_index, name)


@pytest.fixture(scope="module")
def zinc_pair():
    return (j_featurize_many(j_synthetic_zinc(8, seed=2), JEscConfig(h=3)),
            featurize_many(synthetic_zinc(8, seed=2), EscConfig(h=3)))


_SPEC_FIELDS = ("num_graphs", "num_nodes", "num_edges", "enc_width",
                "y_is_node_level", "num_enc_rows", "num_enc_buckets",
                "max_nodes_per_graph", "uniform_nodes", "uniform_edges")


@pytest.mark.parametrize("ctor", ["uniform", "from_graphs"])
@pytest.mark.parametrize("layout", ["dedup", "width"])
def test_batch_spec_and_arrays_bit_equal(zinc_pair, ctor, layout):
    """BatchSpec budgets and every array pad_and_batch emits (the dedup
    fields enc_edge_row, enc_row_weight, enc_edge_perm, enc_row_sorted,
    enc_bucket_ids and enc_countmat included) equal the JAX batcher's."""
    jg, tg = zinc_pair
    jspec = getattr(JBatchSpec, ctor)(jg, len(jg), enc_layout=layout)
    spec = getattr(BatchSpec, ctor)(tg, len(tg), enc_layout=layout)
    for f in _SPEC_FIELDS:
        assert getattr(spec, f) == getattr(jspec, f), f
    want = {k: v for k, v in vars(j_pad_and_batch(jg, jspec)).items()
            if isinstance(v, np.ndarray)}
    batch = pad_and_batch(tg, spec, device="cpu")
    got = {k: v.numpy() for k, v in batch.tensors().items()}
    assert set(got) == set(want)
    if layout == "dedup":
        assert {"enc_edge_row", "enc_row_weight", "enc_edge_perm",
                "enc_row_sorted", "enc_bucket_ids", "enc_countmat"} <= set(got)
    for k in want:
        _assert_same_array(got[k], want[k], k)
    assert batch.nodes_per_graph == (spec.uniform_nodes or None)
    assert batch.edges_per_graph == (spec.uniform_edges or None)


def test_partial_batch_and_node_level_targets():
    """A batch with fewer graphs than the spec, node-level float targets
    and features (the counting variant's shape), dedup layout."""
    rng = np.random.default_rng(9)
    jg, tg = [], []
    for _ in range(5):
        n, ei = random_graph(rng, max_n=9)
        x = rng.normal(size=(n, 3)).astype(np.float32)
        y = rng.normal(size=(n, 2)).astype(np.float32)
        jg.append(j_esc_transform(JGraphData(num_nodes=n, edge_index=ei,
                                             x=x, y=y), JEscConfig(h=2)))
        tg.append(esc_transform(GraphData(num_nodes=n, edge_index=ei,
                                          x=x, y=y), EscConfig(h=2)))
    jspec = JBatchSpec.from_graphs(jg, 4, enc_layout="dedup")
    spec = BatchSpec.from_graphs(tg, 4, enc_layout="dedup")
    assert spec.y_is_node_level
    want = {k: v for k, v in vars(j_pad_and_batch(jg[:3], jspec)).items()
            if isinstance(v, np.ndarray)}
    got = batch_arrays(tg[:3], spec)
    assert set(got) == set(want)
    for k in want:
        _assert_same_array(got[k], want[k], k)


def test_batch_to_device_and_budget_errors(zinc_pair):
    _, tg = zinc_pair
    spec = BatchSpec.uniform(tg, len(tg), enc_layout="dedup")
    b = pad_and_batch(tg, spec, device="cpu").to("cpu")
    assert all(t.device.type == "cpu" for t in b.tensors().values())
    assert b.num_graphs == len(tg) and b.num_edges == spec.num_edges
    small = BatchSpec.uniform(tg[:1], 1, enc_layout="dedup")
    with pytest.raises(ValueError):
        pad_and_batch(tg, small, device="cpu")
    with pytest.raises(NotImplementedError):
        BatchSpec.uniform(tg, 2, enc_layout="flat")
    assert isinstance(b.senders, torch.Tensor)
