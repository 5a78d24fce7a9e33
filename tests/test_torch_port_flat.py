"""The flat COO encoding layout and packed batches of the port against the
JAX package, on the CPU.

  * batches: `BatchSpec.from_graphs` / `uniform` / `exact` with
    `enc_layout="flat"` give JAX's spec and JAX's `pad_and_batch` arrays,
    field for field, bit for bit; the flat entries give the width layout's
    per-edge histograms;
  * `zemb_weighted_flat`: forward, dTable and dCnt against JAX's at rtol
    1e-5 (JAX's table backward set to f32 through its own
    `set_backward_matmul_dtype`), with the entries in the batcher's order
    and shuffled (each sum sorts its ids and runs through K1's wrapper);
    the bf16 option against JAX's bf16 at rtol 1e-2 of the gradient's
    norm;
  * NestedGINEff, GPS and PPGN on flat batches with weights drawn by
    numpy and carried across: the eval output at 1e-5 of its largest
    entry, the train-mode loss at rtol 1e-5, each gradient at 1e-4 of its
    norm (a gradient that is rounding noise on JAX's side, under 1e-4 of
    the largest norm, must be under that bound here too). NestedGINEff's
    gradients are held at 1e-3 of the largest gradient norm instead: on
    these ZINC-shaped graphs (BatchNorm over 3 graphs) its gradients
    differ from JAX's by up to 3.5e-4 of their own norm, and its eps
    gradients by 2e-3, on the width layout as on the flat one. PPGN: the
    port's flat forward against its width forward;
  * `packed_batch_iterator`, `prefetched_batches(packed=True)` and
    `materialized_batch_pools` yield JAX's batches for the same seed, and
    a flat pool survives stacking and `compress_tree`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import escgnn_tpu.train.loop as jloop
from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.batching import (
    packed_batch_iterator as j_packed_batch_iterator,
)
from escgnn_tpu.data.compress import compress_tree as j_compress_tree
from escgnn_tpu.data.molecules import synthetic_zinc as j_synthetic_zinc
from escgnn_tpu.data.prefetch import (
    materialized_batch_pools as j_materialized_batch_pools,
)
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu.models.gps import GPSConfig as JGPSConfig
from escgnn_tpu.models.gps import GPSModel as JGPSModel
from escgnn_tpu.models.nested_gin_eff import NestedGINEff as JNestedGINEff
from escgnn_tpu.models.nested_gin_eff import (
    NestedGINEffConfig as JNestedGINEffConfig,
)
from escgnn_tpu.ops import zemb as j_zemb
import escgnn_tpu_torch.train.loop as loop
from escgnn_tpu_torch.data.batching import (
    BatchSpec,
    batch_arrays,
    batch_iterator,
    packed_batch_iterator,
    pad_and_batch,
)
from escgnn_tpu_torch.data.compress import compress_tree, make_decoder
from escgnn_tpu_torch.data.molecules import synthetic_zinc
from escgnn_tpu_torch.data.prefetch import (
    _host_batches,
    materialized_batch_pools,
    prefetched_batches,
    stack_batches,
)
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.models.gps import GPSConfig, GPSModel
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.models.ppgn import PPGN, PPGNConfig
from escgnn_tpu_torch.ops import zemb
from escgnn_tpu_torch.weights import flax_to_state_dict, load_flax_variables
from tests.test_torch_port_compress import _assert_equal_to_jax, _j_stack
from tests.test_torch_port_gps import _prep, _widths
from tests.test_torch_port_zoo import jax_run, numpy_variables

BS = 4


@pytest.fixture(scope="module")
def graphs():
    """11 ZINC-shaped graphs featurized by each package (ESC h 2)."""
    jg = j_featurize_many(j_synthetic_zinc(11, seed=8), JEscConfig(h=2))
    tg = featurize_many(synthetic_zinc(11, seed=8), EscConfig(h=2))
    return jg, tg


@pytest.fixture
def f32_jax_backward():
    """JAX's table backwards in f32 for the test, bf16 (its default)
    after."""
    j_zemb.set_backward_matmul_dtype(jnp.float32)
    yield
    j_zemb.set_backward_matmul_dtype(jnp.bfloat16)


def _jax_fields(batch) -> dict:
    return {k: np.asarray(v) for k, v in vars(batch).items()
            if v is not None and hasattr(v, "shape")}


def _assert_arrays_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        a = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert a.dtype == want[k].dtype, (k, a.dtype, want[k].dtype)
        np.testing.assert_array_equal(a, want[k], err_msg=k)


def _specs(jg, tg, kind):
    if kind == "exact":
        return (JBatchSpec.exact(jg[:BS], enc_layout="flat"),
                BatchSpec.exact(tg[:BS], enc_layout="flat"))
    return (getattr(JBatchSpec, kind)(jg, BS, enc_layout="flat"),
            getattr(BatchSpec, kind)(tg, BS, enc_layout="flat"))


@pytest.mark.parametrize("kind", ["from_graphs", "uniform", "exact"])
def test_flat_batch_equals_jax(graphs, kind):
    """The flat spec is JAX's (flat budget set, width 0) and every array
    of a 3-graph batch (one empty graph slot) equals JAX's; the entries
    are sorted by edge, padding entries carry count 0 on edge E - 1, and
    they sum to the width layout's per-edge histograms."""
    jg, tg = graphs
    jspec, spec = _specs(jg, tg, kind)
    assert spec.num_enc_nnz > 0 and spec.enc_width == 0
    for f in dataclasses.fields(spec):
        assert getattr(spec, f.name) == getattr(jspec, f.name), f.name
    n = BS if kind == "exact" else BS - 1
    got = batch_arrays(tg[:n], spec)
    _assert_arrays_equal(got, _jax_fields(j_pad_and_batch(jg[:n], jspec)))
    fe, fc = got["enc_flat_edge"], got["enc_flat_cnt"]
    E = spec.num_edges
    assert (np.diff(fe) >= 0).all()
    real = sum(int(np.diff(g.enc_offsets).sum()) for g in tg[:n])
    assert (fc[real:] == 0).all() and (fe[real:] == E - 1).all()
    wspec = BatchSpec.exact(tg[:n]) if kind == "exact" else getattr(
        BatchSpec, kind)(tg, BS)
    w = batch_arrays(tg[:n], wspec)
    dense_w = np.zeros((E, 1800), np.float32)
    np.add.at(dense_w, (np.broadcast_to(np.arange(E)[:, None],
                                        w["enc_idx"].shape),
                        w["enc_idx"].astype(np.int64)),
              w["enc_cnt"].astype(np.float32))
    dense_f = np.zeros((E, 1800), np.float32)
    np.add.at(dense_f, (fe.astype(np.int64), got["enc_flat_idx"]
                        .astype(np.int64)), fc.astype(np.float32))
    np.testing.assert_array_equal(dense_f[w["edge_mask"]],
                                  dense_w[w["edge_mask"]])


def test_exact_dedup_spec_equals_jax(graphs):
    """`BatchSpec.exact` on the dedup layout sizes its rows by the list's
    true cross-graph distinct-row count, as JAX's does."""
    jg, tg = graphs
    jspec = JBatchSpec.exact(jg[:BS], enc_layout="dedup")
    spec = BatchSpec.exact(tg[:BS], enc_layout="dedup")
    assert dataclasses.asdict(spec) == {
        f.name: getattr(jspec, f.name) for f in dataclasses.fields(spec)}
    _assert_arrays_equal(batch_arrays(tg[:BS], spec),
                         _jax_fields(j_pad_and_batch(jg[:BS], jspec)))


def _flat_inputs(seed=0, Z=60, H=16, K=384, E=100):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, Z, K).astype(np.int16)
    cnt = rng.integers(0, 5, K).astype(np.int16)
    edge = np.sort(rng.integers(0, E, K)).astype(np.int32)
    table = rng.normal(size=(Z, H)).astype(np.float32)
    w = rng.normal(size=(E, H)).astype(np.float32)
    return table, idx, cnt, edge, w


def _jax_flat(table, idx, cnt, edge, w):
    E = w.shape[0]

    def loss(t, c):
        z = j_zemb._zemb_flat_core(t, jnp.asarray(idx, jnp.int32), c,
                                   jnp.asarray(edge), E)
        return jnp.sum(jnp.sin(z) * w), z

    (_, z), (dt, dc) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(table), jnp.asarray(cnt, jnp.float32))
    return np.asarray(z), np.asarray(dt), np.asarray(dc)


def _torch_flat(table, idx, cnt, edge, w):
    t = torch.tensor(table, requires_grad=True)
    c = torch.tensor(cnt.astype(np.float32), requires_grad=True)
    z = zemb.zemb_weighted_flat(t, torch.from_numpy(idx), c,
                                torch.from_numpy(edge), w.shape[0])
    (torch.sin(z) * torch.from_numpy(w)).sum().backward()
    return z.detach().numpy(), t.grad.numpy(), c.grad.numpy()


def test_zemb_flat_equals_jax(f32_jax_backward):
    """Forward, dTable and dCnt equal JAX's f32 ones at rtol 1e-5
    (atol 1e-5 of the largest entry); the default backward dtype is f32
    and only f32 / bf16 are taken."""
    args = _flat_inputs()
    assert zemb._BWD_MATMUL_DTYPE == torch.float32
    for got, want in zip(_torch_flat(*args), _jax_flat(*args)):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    with pytest.raises(ValueError, match="bfloat16"):
        zemb.set_backward_matmul_dtype(torch.float16)


def test_zemb_flat_sums_through_k1_in_any_entry_order(f32_jax_backward):
    """The forward's sum into edges and dTable's sum into buckets each sort
    their ids and go through K1's wrapper once; with the entries shuffled
    (an ep rank's rebased copy is not sorted by edge) forward, dTable and
    dCnt still equal JAX's on the sorted entries at rtol 1e-5."""
    from escgnn_tpu_torch.utils import cost

    table, idx, cnt, edge, w = _flat_inputs(seed=2)
    shuffle = np.random.default_rng(3).permutation(len(idx))
    s_idx, s_cnt, s_edge = idx[shuffle], cnt[shuffle], edge[shuffle]
    t = torch.tensor(table, requires_grad=True)
    with cost.CostMode() as mode:
        (zemb.zemb_weighted_flat(
            t, torch.from_numpy(s_idx), torch.from_numpy(s_cnt),
            torch.from_numpy(s_edge), w.shape[0]) * torch.from_numpy(w)
         ).sum().backward()
    assert mode.by_op["sorted_segment_sum"].calls == 2
    assert mode.by_op["aten.sort"].calls == 2
    z, dt, dc = _torch_flat(table, s_idx, s_cnt, s_edge, w)
    dc_sorted = np.empty_like(dc)
    dc_sorted[shuffle] = dc
    want = _jax_flat(table, idx, cnt, edge, w)
    for got, ref in zip((z, dt, dc_sorted), want):
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)


def test_zemb_flat_bf16_backward_equals_jax_bf16():
    """With bf16 set on both sides the table gradients agree within
    1e-2 of their norm (the operands rounded alike, summed in f32 in
    another order), and differ from the f32 gradient by more than the
    f32 one differs from itself; f32 is set back after."""
    args = _flat_inputs(seed=1)
    _, dt32, _ = _torch_flat(*args)
    zemb.set_backward_matmul_dtype(torch.bfloat16)
    try:
        _, dt16, dc16 = _torch_flat(*args)
    finally:
        zemb.set_backward_matmul_dtype(torch.float32)
    _, jdt16, jdc16 = _jax_flat(*args)  # JAX's default is bf16
    norm = np.linalg.norm(jdt16)
    assert np.linalg.norm(dt16 - jdt16) <= 1e-2 * norm
    assert np.linalg.norm(dt16 - dt32) > 0
    np.testing.assert_allclose(dc16, jdc16, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jdc16).max()))


def _check_model(jm, jb, m, tb, j_loss, t_loss, per_largest=False):
    """Eval output, train-mode loss and gradients of a port model on
    carried weights against JAX's (see the module docstring)."""
    v = numpy_variables(jm, jb)
    stats = v.get("batch_stats", {})
    load_flax_variables(m, v["params"], stats)

    def run(params, batch):
        eval_out = jm.apply({"params": params, "batch_stats": stats}, batch)

        def loss(p):
            out, _ = jm.apply({"params": p, "batch_stats": stats}, batch,
                              deterministic=True, use_running_average=False,
                              mutable=["batch_stats"])
            return j_loss(out, batch)

        return (eval_out,) + jax.value_and_grad(loss)(params)

    want, want_loss, jgrads = jax_run(run, v["params"], jb)
    want = np.asarray(want)
    m.eval()
    with torch.no_grad():
        got = m(tb).numpy()
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5,
                               atol=1e-5)
    m.train()
    loss = t_loss(m(tb), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_g = flax_to_state_dict(jax.tree.map(np.asarray, jgrads), {})
    got_g = {k: p.grad for k, p in m.named_parameters()}
    assert set(want_g) == set(got_g)
    norms = {k: float(np.linalg.norm(w.numpy())) for k, w in want_g.items()}
    noise = 1e-4 * max(norms.values())
    for k, w in want_g.items():
        g = got_g[k].numpy()
        if norms[k] < noise:
            assert float(np.linalg.norm(g)) < noise, k
            continue
        bound = (1e-3 * max(norms.values()) if per_largest
                 else 1e-4 * norms[k])
        assert np.linalg.norm(g - w.numpy()) <= bound, k


@pytest.mark.parametrize("node_level", [False, True])
def test_nested_gin_eff_flat_equals_jax(graphs, f32_jax_backward,
                                        node_level):
    """NestedGINEff (graph and node heads) on a flat batch equals JAX's;
    its z MLP takes the flat z under `edge_mask` as on the width
    layout."""
    jg, tg = graphs
    jspec, spec = _specs(jg, tg, "from_graphs")
    jb = jax.tree.map(jnp.asarray, j_pad_and_batch(jg[:BS - 1], jspec))
    tb = pad_and_batch(tg[:BS - 1], spec, device="cpu")
    fields = dict(hidden=16, num_layers=2, graph_pred=not node_level,
                  node_embed_vocab=28, edge_embed_vocab=4)
    if node_level:
        # a node target per node: the graph's y broadcast
        jb = dataclasses.replace(jb, y=jnp.zeros((jb.num_nodes, 1)))
        tb = dataclasses.replace(tb, y=torch.zeros(tb.num_nodes, 1))
    j_loss = jloop.l1_node_loss if node_level else jloop.l1_graph_loss
    t_loss = loop.l1_node_loss if node_level else loop.l1_graph_loss
    jm = JNestedGINEff(JNestedGINEffConfig(**fields))
    m = NestedGINEff(NestedGINEffConfig(**fields), in_dim=1, device="cpu")
    _check_model(jm, jb, m, tb, j_loss, t_loss, per_largest=True)


def test_gps_flat_equals_jax(f32_jax_backward):
    """The GPS layer applies the ESC encoding to a flat batch (its
    `z_initial` gets a gradient) and the model equals JAX's."""
    from tests.test_torch_port_gps import _raw

    tg, jg = _prep(_raw("zinc", "torch"), "torch"), _prep(_raw("zinc", "jax"),
                                                         "jax")
    n = len(tg) - 1
    jspec = JBatchSpec.from_graphs(jg, len(jg), enc_layout="flat")
    spec = BatchSpec.from_graphs(tg, len(tg), enc_layout="flat")
    jb = jax.tree.map(jnp.asarray, j_pad_and_batch(jg[:n], jspec))
    tb = pad_and_batch(tg[:n], spec, device="cpu")
    fields = dict(dim_h=16, num_layers=2, num_heads=2, use_attn_bias=True)
    m = GPSModel(GPSConfig(**fields), device="cpu", **_widths(tg))
    _check_model(JGPSModel(JGPSConfig(**fields)), jb, m, tb,
                 jloop.l1_graph_loss, loop.l1_graph_loss)
    assert float(m.layer0.z_initial.grad.abs().sum()) > 0


def test_ppgn_flat_equals_width(graphs):
    """PPGN with the ESC encoding takes a flat batch: on one set of
    weights its eval output and gradients equal those on the width
    batch of the same graphs."""
    _, tg = graphs
    n = BS - 1
    outs = []
    for layout in ("width", "flat"):
        spec = BatchSpec.from_graphs(tg, BS, enc_layout=layout)
        b = pad_and_batch(tg[:n], spec, device="cpu")
        m = PPGN(PPGNConfig(emb_dim=8, num_rb_layers=1, max_nodes=32,
                            use_esc=True), device="cpu")
        out = m(b)
        out.square().sum().backward()
        outs.append((out.detach(), {k: p.grad for k, p in
                                    m.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-5)
    for k, g in outs[0][1].items():
        torch.testing.assert_close(outs[1][1][k], g, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["width", "dedup", "flat"])
def test_packed_batches_equal_jax(graphs, layout):
    """`packed_batch_iterator` with one shuffle seed yields JAX's packed
    batches, each bit-equal; they cover every graph once in no more
    batches than `batch_iterator`; `prefetched_batches(packed=True)`
    yields the same batches."""
    jg, tg = graphs
    jspec = JBatchSpec.from_graphs(jg, BS, enc_layout=layout)
    spec = BatchSpec.from_graphs(tg, BS, enc_layout=layout)
    want = [_jax_fields(b) for b in j_packed_batch_iterator(
        jg, jspec, shuffle=True, rng=np.random.default_rng(3))]
    got = list(packed_batch_iterator(tg, spec, shuffle=True,
                                     rng=np.random.default_rng(3),
                                     device=None))
    assert len(got) == len(want)
    for a, w in zip(got, want):
        _assert_arrays_equal(a, w)
    assert sum(int(a["graph_mask"].sum()) for a in got) == len(tg)
    assert sum(int(a["edge_mask"].sum()) for a in got) == sum(
        g.num_edges for g in tg)
    assert len(got) <= len(list(batch_iterator(tg, spec, device=None)))
    pre = list(prefetched_batches(tg, spec, shuffle=True,
                                  rng=np.random.default_rng(3),
                                  device="cpu", packed=True))
    assert len(pre) == len(got)
    for b, a in zip(pre, got):
        _assert_arrays_equal(b.tensors(), a)


def test_materialized_batch_pools_equal_jax(graphs):
    """k pools of one seed hold JAX's batches in JAX's order."""
    jg, tg = graphs
    jspec = JBatchSpec.uniform(jg, BS, enc_layout="flat")
    spec = BatchSpec.uniform(tg, BS, enc_layout="flat")
    want = j_materialized_batch_pools(jg, jspec, k=2, seed=4)
    got = materialized_batch_pools(tg, spec, k=2, seed=4, device="cpu")
    assert len(got) == len(want) == 2
    for gp, wp in zip(got, want):
        assert len(gp) == len(wp)
        for b, w in zip(gp, wp):
            _assert_arrays_equal(b.tensors(), _jax_fields(w))


def test_flat_pool_stacks_and_compresses_like_jax(graphs):
    """A stack of flat batches compresses to JAX's dtypes and values and
    decodes back bit for bit."""
    jg, tg = graphs
    jspec = JBatchSpec.uniform(jg, BS, enc_layout="flat")
    spec = BatchSpec.uniform(tg, BS, enc_layout="flat")
    jhost = _j_stack([j_pad_and_batch(jg[i:i + BS], jspec)
                      for i in range(0, 8, BS)])
    host = stack_batches(_host_batches(tg[:8], spec))
    assert host.enc_flat_idx.shape[0] == 2
    jc, _ = j_compress_tree(jhost)
    c, metas = compress_tree(host)
    _assert_equal_to_jax(c, jc)
    back = make_decoder(metas)(c)
    for k, t in host.tensors().items():
        assert torch.equal(back.tensors()[k], t), k
