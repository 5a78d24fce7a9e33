"""The port's batch iterator, prefetcher and stacked batch pools against
the JAX package, on the CPU: the same graphs and seeds give the same
batches, bit for bit, in the same order.
"""

import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import batch_iterator as j_batch_iterator
from escgnn_tpu.data.molecules import synthetic_zinc as j_synthetic_zinc
from escgnn_tpu.data.prefetch import stack_split as j_stack_split
from escgnn_tpu.data.prefetch import stacked_batch_pools as j_stacked_pools
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu_torch.data.batching import BatchSpec, batch_iterator
from escgnn_tpu_torch.data.molecules import synthetic_zinc
from escgnn_tpu_torch.data.prefetch import (
    materialized_batches,
    pool_entry,
    pool_size,
    prefetched_batches,
    stack_split,
    stacked_batch_pools,
)
from escgnn_tpu_torch.featurize import EscConfig, featurize_many

BATCH = 4


@pytest.fixture(scope="module")
def graphs():
    """11 graphs: 3 batches of 4, the last one short (3 graphs)."""
    jg = j_featurize_many(j_synthetic_zinc(11, seed=8), JEscConfig(h=2))
    tg = featurize_many(synthetic_zinc(11, seed=8), EscConfig(h=2))
    jspec = JBatchSpec.uniform(jg, BATCH, enc_layout="dedup")
    spec = BatchSpec.uniform(tg, BATCH, enc_layout="dedup")
    return jg, tg, jspec, spec


def _jax_fields(batch) -> dict:
    return {k: np.asarray(v) for k, v in vars(batch).items()
            if v is not None and hasattr(v, "shape")}


def _assert_batch_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        a = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert a.dtype == want[k].dtype, (k, a.dtype, want[k].dtype)
        np.testing.assert_array_equal(a, want[k], err_msg=k)


def test_batch_iterator_shuffled_equals_jax(graphs):
    """shuffle=True with one rng seed: every batch (host arrays and the
    CPU-tensor batch) equals JAX's, the short last batch padded to the
    spec's shapes."""
    jg, tg, jspec, spec = graphs
    want = [_jax_fields(b) for b in j_batch_iterator(
        jg, jspec, shuffle=True, rng=np.random.default_rng(5))]
    host = list(batch_iterator(tg, spec, shuffle=True,
                               rng=np.random.default_rng(5), device=None))
    on_cpu = list(batch_iterator(tg, spec, shuffle=True,
                                 rng=np.random.default_rng(5), device="cpu"))
    assert len(want) == len(host) == len(on_cpu) == 3
    for w, h, b in zip(want, host, on_cpu):
        _assert_batch_equal(h, w)
        _assert_batch_equal(b.tensors(), w)
        assert b.nodes_per_graph == spec.uniform_nodes
    assert host[-1]["graph_mask"].sum() == 3
    assert host[-1]["node_mask"].shape == host[0]["node_mask"].shape


def test_prefetched_batches_equal_batch_iterator(graphs):
    """The background-thread prefetcher yields batch_iterator's batches in
    its order, and raises what the producer raised."""
    _, tg, _, spec = graphs
    want = list(batch_iterator(tg, spec, shuffle=True,
                               rng=np.random.default_rng(1), device=None))
    got = list(prefetched_batches(tg, spec, shuffle=True,
                                  rng=np.random.default_rng(1), device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_batch_equal(g.tensors(), w)
    too_small = BatchSpec.uniform(tg[:1], 1, enc_layout="dedup")
    with pytest.raises(ValueError):
        list(prefetched_batches(tg, too_small, device="cpu"))


@pytest.mark.parametrize("pin_bytes", [0, 2**30])
def test_materialized_batches(graphs, pin_bytes):
    """A fixed split padded once: kept as tensors (fits pin_bytes) or as
    host arrays copied per access; either way the same batches, reusable."""
    _, tg, _, spec = graphs
    mb = materialized_batches(tg, spec, device="cpu", pin_bytes=pin_bytes)
    want = list(batch_iterator(tg, spec, device=None))
    assert len(mb) == len(want)
    for _ in range(2):
        for g, w in zip(mb, want):
            _assert_batch_equal(g.tensors(), w)


def test_stacked_batch_pools_equal_jax(graphs, capsys):
    """k=2, seed=3: both pools' stacked arrays and num_batches equal JAX's
    (the same permutations from the same seed); a max_total_bytes under
    two pools caps k to 1, as JAX does; the decoder of uncompressed pools
    is the identity, and `compress=True` gives pools the decoder restores
    (tests/test_torch_port_compress.py holds them against JAX's)."""
    jg, tg, jspec, spec = graphs
    jpools, jn, _ = j_stacked_pools(jg, jspec, k=2, seed=3)
    pools, n, decode = stacked_batch_pools(tg, spec, k=2, seed=3,
                                           device="cpu")
    assert decode(pools[0]) is pools[0]
    assert n == jn == 3 and len(pools) == len(jpools) == 2
    for p, jp in zip(pools, jpools):
        _assert_batch_equal(p.tensors(), _jax_fields(jp))
        assert pool_size(p) == 3
        assert p.enc_countmat is not None and p.pos is None
    per_pool = sum(t.numel() * t.element_size()
                   for t in pools[0].tensors().values())
    capped, n, _ = stacked_batch_pools(tg, spec, k=4, seed=3,
                                    max_total_bytes=per_pool + 1,
                                    device="cpu")
    jcapped, _, _ = j_stacked_pools(jg, jspec, k=4, seed=3,
                                    max_total_bytes=per_pool + 1)
    assert len(capped) == len(jcapped) == 1 and n == 3
    assert "capping pools 4 -> 1" in capsys.readouterr().out
    entry = pool_entry(pools[1], 2)
    _assert_batch_equal(entry.tensors(),
                        {k: v[2] for k, v in _jax_fields(jpools[1]).items()})
    cpools, cn, cdecode = stacked_batch_pools(tg, spec, k=2, seed=3,
                                              compress=True, device="cpu")
    assert cn == n and len(cpools) == 2
    _assert_batch_equal(cdecode(cpools[1]).tensors(), _jax_fields(jpools[1]))


def test_stack_split_equals_jax(graphs):
    jg, tg, jspec, spec = graphs
    _assert_batch_equal(stack_split(tg, spec, "cpu").tensors(),
                        _jax_fields(j_stack_split(jg, jspec)))
