"""Compressed pools (`escgnn_tpu_torch/data/compress.py`) against the JAX
package's `escgnn_tpu/data/compress.py`, on counting graphs (60 graphs,
h 2, uniform + dedup batches of 16) generated and featurized by each
package from one seed: every compressed tensor's dtype and values equal
JAX's leaf; `compress_tree_like` and a decoder shared across stacks;
the pool, eval, refresh and logits steps on a compressed pool equal
them on the uncompressed one; `stacked_batch_pools(compress=True)` gives
JAX's pools, count and order, under a byte cap counted compressed."""

import jax
import numpy as np
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import batch_iterator as j_batch_iterator
from escgnn_tpu.data.compress import compress_tree as j_compress_tree
from escgnn_tpu.data.counting import (
    CountingDatasetConfig as JCountingConfig,
    generate_counting_graphs as j_generate,
    normalize_targets as j_normalize,
)
from escgnn_tpu.data.prefetch import stacked_batch_pools as j_stacked_pools
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.transform import featurize_many as j_featurize
from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.compress import (
    compress_tree,
    compress_tree_like,
    make_decoder,
    pool_nbytes,
)
from escgnn_tpu_torch.data.container import EXTRAS_PREFIX
from escgnn_tpu_torch.data.counting import (
    CountingDatasetConfig,
    generate_counting_graphs,
    normalize_targets,
)
from escgnn_tpu_torch.data.prefetch import (
    _host_batches,
    pool_entry,
    stack_batches,
    stack_split,
    stack_split_compressed,
    stacked_batch_pools,
)
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.train.loop import (
    adam_with_plateau,
    l1_node_loss,
    make_pool_eval_step,
    make_pool_logits_step,
    make_pool_refresh_step,
    make_pool_train_step,
)


@pytest.fixture(scope="module")
def graphs():
    j = j_generate(JCountingConfig(num_graphs=60, seed=0))
    j, _, _ = j_normalize(j, 2)
    t = generate_counting_graphs(CountingDatasetConfig(num_graphs=60,
                                                       seed=0))
    t, _, _ = normalize_targets(t, 2)
    jg = j_featurize(j["train"], JEscConfig(h=2, use_rd=True, self_loop=True))
    tg = featurize_many(t["train"], EscConfig(h=2, use_rd=True,
                                              self_loop=True))
    return (jg, tg, JBatchSpec.uniform(jg, 16, enc_layout="dedup"),
            BatchSpec.uniform(tg, 16, enc_layout="dedup"))


def _j_stack(batches):
    return jax.tree.map(lambda *xs: np.stack(xs), *batches)


def _jax_leaf(jtree, name: str):
    if name.startswith(EXTRAS_PREFIX):
        return jtree.extras[name[len(EXTRAS_PREFIX):]]
    return getattr(jtree, name)


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def _assert_equal_to_jax(batch, jtree):
    for k, t in batch.tensors().items():
        want = np.asarray(_jax_leaf(jtree, k))
        assert t.dtype == _torch_dtype(want.dtype), (k, t.dtype, want.dtype)
        np.testing.assert_array_equal(t.numpy(), want, err_msg=k)


def test_compressed_tensors_equal_jax(graphs):
    """Each tensor of the compressed stack has JAX's compressed dtype and
    values; the stack shrinks below half (the count matrix to int8); the
    decoder restores every tensor, dtype and value."""
    jg, tg, jspec, spec = graphs
    jhost = _j_stack(list(j_batch_iterator(jg, jspec)))
    host = stack_batches(_host_batches(tg, spec))
    jc, _ = j_compress_tree(jhost)
    c, metas = compress_tree(host)
    _assert_equal_to_jax(c, jc)
    assert c.enc_countmat.dtype == torch.int8
    assert pool_nbytes(c) < 0.5 * pool_nbytes(host)
    assert set(metas) == set(host.tensors())
    back = make_decoder(metas)(c)
    for k, t in host.tensors().items():
        assert back.tensors()[k].dtype == t.dtype, k
        assert torch.equal(back.tensors()[k], t), k


def test_compress_like_and_shared_decoder(graphs):
    """A reversed stack cast like the first takes its dtypes (JAX's
    `compress_tree_like`); a decoder made from one batch restores the
    whole stack, compressed on its own; a decoder passes names it does
    not hold, and a cast that would change values is refused."""
    _, tg, _, spec = graphs
    batches = _host_batches(tg, spec)
    c0, _ = compress_tree(stack_batches(batches))
    c2 = compress_tree_like(stack_batches(batches[::-1]), c0)
    for k, t in c0.tensors().items():
        assert c2.tensors()[k].dtype == t.dtype, k
    _, metas1 = compress_tree(stack_batches(batches[:1]))
    full = stack_batches(batches)
    back = make_decoder(metas1)(compress_tree(full)[0])
    for k, t in full.tensors().items():
        assert torch.equal(back.tensors()[k], t), k
    partial = make_decoder({"x": torch.float32})
    b = full.with_tensors({"x": full.x.to(torch.int8),
                           "node_mask": full.node_mask})
    out = partial(b)
    assert out.x.dtype == torch.float32 and out.node_mask.dtype == torch.bool
    big = full.with_tensors(dict(full.tensors(),
                                 x=full.x + 1000.0))
    with pytest.raises(ValueError, match="losslessly"):
        compress_tree_like(big, c0)


def _model(in_dim, seed=0):
    return NestedGINEff(NestedGINEffConfig(hidden=16, num_layers=2,
                                           act="elu", graph_pred=False,
                                           use_x_embedding_jk=False,
                                           head_order="dropout_act"),
                        in_dim=in_dim, device="cpu",
                        generator=torch.Generator().manual_seed(seed))


def test_pool_steps_on_compressed_pool_equal_uncompressed(graphs):
    """Two pool epochs (Adam) on the compressed pool give the losses and
    parameters of the uncompressed pool bit for bit, and so do the pool
    eval, BN refresh and logits steps through the decoder."""
    _, tg, _, spec = graphs
    pools, n, _ = stacked_batch_pools(tg, spec, k=1, device="cpu")
    cpools, cn, decode = stacked_batch_pools(tg, spec, k=1, compress=True,
                                             device="cpu")
    assert n == cn and pool_nbytes(cpools[0]) < pool_nbytes(pools[0])
    order = np.random.default_rng(0).permutation(n)
    results = []
    for pool, dec in ((pools[0], None), (cpools[0], decode)):
        torch.manual_seed(0)
        model = _model(tg[0].x.shape[1])
        opt = adam_with_plateau(model.parameters(), 1e-3)
        step = make_pool_train_step(model, opt, l1_node_loss, pool,
                                    decode=dec)
        losses = torch.cat([step(pool, order), step(pool, order[::-1])])
        make_pool_refresh_step(model, decode=dec)(pool)
        e, c = make_pool_eval_step(model, node_level=True, decode=dec)(pool)
        logits, y, mask = make_pool_logits_step(model, node_level=True,
                                                decode=dec)(pool)
        results.append((losses, [p.detach().clone()
                                 for p in model.parameters()],
                        (e, c), (logits, y, mask)))
    (l0, p0, ev0, lg0), (l1, p1, ev1, lg1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(ev0, ev1))
    assert all(torch.equal(a, b) for a, b in zip(lg0, lg1))
    stack, sdec = stack_split_compressed(tg, spec, "cpu")
    plain = stack_split(tg, spec, "cpu")
    assert torch.equal(sdec(pool_entry(stack, 1)).enc_countmat,
                       pool_entry(plain, 1).enc_countmat)


def test_compressed_stacked_pools_equal_jax(graphs, capsys):
    """k=3, seed=5: the compressed pools equal JAX's compressed pools
    tensor by tensor (the same permutations, the later pools cast like the
    first); a byte cap under two compressed pools caps k to 1 as JAX
    does; the decoder restores JAX's uncompressed pools."""
    jg, tg, jspec, spec = graphs
    jpools, jn, _ = j_stacked_pools(jg, jspec, k=3, seed=5,
                                          compress=True)
    pools, n, decode = stacked_batch_pools(tg, spec, k=3, seed=5,
                                           compress=True, device="cpu")
    assert n == jn and len(pools) == len(jpools) == 3
    for p, jp in zip(pools, jpools):
        _assert_equal_to_jax(p, jax.tree.map(np.asarray, jp))
    plain, _, _ = j_stacked_pools(jg, jspec, k=3, seed=5)
    back = decode(pools[2])
    for k, t in back.tensors().items():
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(_jax_leaf(plain[2], k)), err_msg=k)
    cap = pool_nbytes(pools[0]) + 1
    capped, _, _ = stacked_batch_pools(tg, spec, k=3, seed=5, compress=True,
                                       max_total_bytes=cap, device="cpu")
    jcapped, _, _ = j_stacked_pools(jg, jspec, k=3, seed=5, compress=True,
                                    max_total_bytes=cap)
    assert len(capped) == len(jcapped) == 1
    assert "capping pools 3 -> 1" in capsys.readouterr().out
