"""The port's sorted segment sums against the JAX package, on the CPU.

`segment_sum`, `segment_mean`, `segment_softmax` and `gather_rows`
(`escgnn_tpu_torch/ops/segment.py`) add through a stable sort of the ids
and K1 (`ops/expand_cuda.py`; its plain version on the CPU), so every
sum has one fixed order. Each is held to `escgnn_tpu.ops.segment` (and
`jnp.take`) through `jax.grad` of a fixed random projection, forward and
gradient, on numpy-seeded values of rank 1, 2 and 3 with empty segments
and masked rows whose padding ids lie out of range: f32 at rtol 1e-6,
bf16 at 2e-2 of the output's norm, a few bf16 roundings (2^-8 each) of
the softmax's chain (K1 adds bf16 rows in f32 where JAX adds in bf16).
The same on sparse ids (an interior gap of 4000 segments, 5000 segments
for 96 rows, masked rows beside the gap), where K1 zeroes most rows; a
masked view gathers in range and sorts its masked rows last, under the
segment count, where K1 drops them. Then: a view refilled in place by
`copy_` (as the pool step refills its buffers) is rebuilt, not reused; a
scope builds each view once; the CPU routing ends in K1's plain version;
a source scan of the port finds no atomic float sum outside the
allowlist; and `tools/determinism_probe.py` names the first op whose
output bits differ between two runs and tables K1's calls.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.ops import segment as jseg
from escgnn_tpu_torch.ops import expand_cuda
from escgnn_tpu_torch.ops import segment as tseg

S = 9  # segments; 6, 7 and 8 stay empty
E = 48


def _input(shape, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 6, E).astype(np.int32)
    vals = rng.normal(size=(E,) + shape).astype(np.float32)
    mask = rng.random(E) > 0.3
    ids_pad = np.where(mask, ids, S + 5).astype(np.int32)  # out of range
    proj = rng.normal(size=(S,) + shape).astype(np.float32)
    return ids, ids_pad, vals, mask, proj


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        scale = max(float(np.linalg.norm(want)), 1e-6)
        assert float(np.linalg.norm(got - want)) <= 2e-2 * scale


def _jax_value_and_grad(fn, vals, proj, dtype):
    v = jnp.asarray(vals).astype(dtype)

    def f(x):
        return jnp.sum(fn(x).astype(jnp.float32) * proj)
    return fn(v), jax.grad(f)(v)


def _torch_value_and_grad(fn, vals, proj, dtype):
    v = torch.from_numpy(vals).to(getattr(torch, dtype)).requires_grad_(True)
    out = fn(v)
    (out.float() * torch.from_numpy(proj)).sum().backward()
    return out.detach().float().numpy(), v.grad.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(), (3,), (2, 4)])
@pytest.mark.parametrize("name", ["sum", "mean"])
@pytest.mark.parametrize("masked", [True, False])
def test_sum_and_mean_against_jax(name, shape, dtype, masked):
    ids, ids_pad, vals, mask, proj = _input(shape)
    jfn, tfn = getattr(jseg, f"segment_{name}"), getattr(tseg, f"segment_{name}")
    if masked:
        jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
        j_ids, t_ids = jnp.asarray(ids_pad), torch.from_numpy(ids_pad)
    else:
        jm = tm = None
        j_ids, t_ids = jnp.asarray(ids), torch.from_numpy(ids)
    j_out, j_grad = _jax_value_and_grad(
        lambda x: jfn(x, j_ids, S, mask=jm), vals, proj, dtype)
    t_out, t_grad = _torch_value_and_grad(
        lambda x: tfn(x, t_ids, S, mask=tm), vals, proj, dtype)
    assert t_out.shape == (S,) + shape
    _close(t_out, j_out, dtype)
    _close(t_grad, j_grad, dtype)
    # the empty segments come out 0, the masked rows get no gradient
    assert not t_out[6:].any()
    if masked:
        assert not t_grad[~mask].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1,), (3,)])
@pytest.mark.parametrize("masked", [True, False])
def test_softmax_against_jax(shape, dtype, masked):
    ids, ids_pad, vals, mask, _ = _input(shape, seed=1)
    proj = np.random.default_rng(2).normal(size=(E,) + shape).astype(
        np.float32)
    jm, tm = (jnp.asarray(mask), torch.from_numpy(mask)) if masked else (
        None, None)
    use = ids_pad if masked else ids
    j_out, j_grad = _jax_value_and_grad(
        lambda x: jseg.segment_softmax(x, jnp.asarray(use), S, mask=jm),
        vals, proj, dtype)
    t_out, t_grad = _torch_value_and_grad(
        lambda x: tseg.segment_softmax(x, torch.from_numpy(use), S, mask=tm),
        vals, proj, dtype)
    _close(t_out, j_out, dtype)
    _close(t_grad, j_grad, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(), (3,), (2, 4)])
def test_gather_rows_against_take(shape, dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(S,) + shape).astype(np.float32)
    ids = rng.integers(0, 6, E).astype(np.int32)  # rows 6-8 never gathered
    proj = rng.normal(size=(E,) + shape).astype(np.float32)
    j_out, j_grad = _jax_value_and_grad(
        lambda v: jnp.take(v, jnp.asarray(ids), axis=0), x, proj, dtype)
    t_out, t_grad = _torch_value_and_grad(
        lambda v: tseg.gather_rows(v, torch.from_numpy(ids)), x, proj, dtype)
    np.testing.assert_array_equal(t_out, np.asarray(j_out, np.float32))
    _close(t_grad, j_grad, dtype)
    assert not t_grad[6:].any()


def test_double_backward_through_the_pair():
    """segment_sum and gather_rows are each other's adjoints, so a second
    derivative runs through them as well."""
    ids, _, vals, _, proj = _input((3,), seed=4)
    t_ids = torch.from_numpy(ids)
    x = torch.from_numpy(vals).requires_grad_(True)
    out = tseg.segment_sum(x * x, t_ids, S)
    (g,) = torch.autograd.grad((out * torch.from_numpy(proj)).sum(), x,
                               create_graph=True)
    g.sum().backward()
    want = 2.0 * proj[ids]
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-6)


def test_refilled_ids_build_a_new_view():
    """The pool step refills its static buffers with `copy_`: a view built
    before the refill must not serve the call after it."""
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.normal(size=(E, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, S, E).astype(np.int32))
    mask = torch.from_numpy(rng.random(E) > 0.2)
    new_ids = torch.from_numpy(rng.integers(0, S, E).astype(np.int32))
    new_mask = torch.from_numpy(rng.random(E) > 0.5)

    def plain(i, m):
        v = torch.where(m[:, None], vals, 0.0)
        return torch.zeros(S, 3).index_add_(0, i.long(), v)

    with tseg.sorted_views():
        first = tseg.segment_sum(vals, ids, S, mask)
        torch.testing.assert_close(first, plain(ids, mask), rtol=0, atol=1e-6)
        ids.copy_(new_ids)
        again = tseg.segment_sum(vals, ids, S, mask)
        torch.testing.assert_close(again, plain(new_ids, mask), rtol=0,
                                   atol=1e-6)
        mask.copy_(new_mask)
        third = tseg.segment_sum(vals, ids, S, mask)
        torch.testing.assert_close(third, plain(new_ids, new_mask), rtol=0,
                                   atol=1e-6)


def test_scope_builds_each_view_once():
    ids = torch.tensor([3, 1, 1, 0, 3], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True, True])
    with tseg.sorted_views():
        a = tseg.sorted_ids(ids, 4)
        assert tseg.sorted_ids(ids, 4) is a
        assert tseg.sorted_ids(ids, 5) is not a
        b = tseg.sorted_ids(ids, 4, mask)
        assert b is not a and tseg.sorted_ids(ids, 4, mask) is b
    # no scope: every call sorts; and a closed scope keeps nothing
    assert tseg.sorted_ids(ids, 4) is not a
    assert not tseg._SCOPES
    assert b.ids.tolist() == [3, 1, 0, 0, 3]
    # the masked row sorts last, under the segment count (K1 drops it)
    assert b.ids_sorted.tolist() == [0, 1, 3, 3, 4]
    assert b.perm.tolist() == [3, 1, 0, 4, 2]  # stable
    assert b.perm.dtype == b.ids_sorted.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_view_gathers_in_range_and_sorts_masked_last(seed):
    """A masked view's `ids` stay in [0, S) for the forward gather (the
    masked rows on 0, the padding ids never read), while `ids_sorted`
    is the unmasked ids sorted, then the masked rows under id S; `perm`
    is the stable order that sorts them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S, E).astype(np.int32)
    mask = rng.random(E) > 0.4
    padded = np.where(mask, ids, S + 7).astype(np.int32)
    view = tseg.sorted_ids(torch.from_numpy(padded), S,
                           torch.from_numpy(mask))
    got_ids = view.ids.numpy()
    assert ((got_ids >= 0) & (got_ids < S)).all()
    np.testing.assert_array_equal(got_ids, np.where(mask, ids, 0))
    kept = int(mask.sum())
    order = np.where(mask, ids, S)
    want_perm = np.argsort(order, kind="stable")
    np.testing.assert_array_equal(view.perm.numpy(), want_perm)
    np.testing.assert_array_equal(view.ids_sorted.numpy(), order[want_perm])
    np.testing.assert_array_equal(view.ids_sorted.numpy()[:kept],
                                  np.sort(ids[mask]))
    assert (view.ids_sorted.numpy()[kept:] == S).all()


def _sparse_ids(pattern, n, rng):
    """(segments, ids, mask) of `pattern`: ids on both sides of an
    interior gap of 4000 unnamed rows; ids over 5000 segments, far more
    than positions; the gap with a third of the rows masked, their ids
    out of range."""
    if pattern == "wide":
        return 5000, rng.integers(0, 5000, n).astype(np.int32), None
    segs = 4100
    ids = np.where(rng.random(n) < 0.5, rng.integers(0, 40, n),
                   rng.integers(4040, segs, n)).astype(np.int32)
    if pattern == "gap":
        return segs, ids, None
    mask = rng.random(n) > 0.33
    return segs, np.where(mask, ids, segs + 3).astype(np.int32), mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern", ["gap", "wide", "masked_gap"])
@pytest.mark.parametrize("name", ["sum", "mean"])
def test_sparse_sums_against_jax(name, pattern, dtype):
    """segment_sum and segment_mean where K1's ids are sparse (an
    interior gap of 4000 rows, 5000 segments for 96 positions, masked
    rows with out-of-range ids) against the JAX package, values and
    gradients at the file's tolerances; every unnamed segment is 0."""
    rng = np.random.default_rng(7)
    n = 96
    segs, ids, mask = _sparse_ids(pattern, n, rng)
    vals = rng.normal(size=(n, 3)).astype(np.float32)
    proj = rng.normal(size=(segs, 3)).astype(np.float32)
    jfn, tfn = getattr(jseg, f"segment_{name}"), getattr(tseg, f"segment_{name}")
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    j_out, j_grad = _jax_value_and_grad(
        lambda x: jfn(x, jnp.asarray(ids), segs, mask=jm), vals, proj, dtype)
    t_out, t_grad = _torch_value_and_grad(
        lambda x: tfn(x, torch.from_numpy(ids), segs, mask=tm), vals, proj,
        dtype)
    _close(t_out, j_out, dtype)
    _close(t_grad, j_grad, dtype)
    named = np.zeros(segs, bool)
    named[ids[mask] if mask is not None else ids] = True
    assert not t_out[~named].any()
    if mask is not None:
        assert not t_grad[~mask].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern", ["gap", "wide"])
def test_sparse_gather_gradient_against_jax(pattern, dtype):
    """gather_rows' gradient (K1 over the ids' view) where the ids are
    sparse in the rows they gather, against `jax.ops.segment_sum` of the
    cotangent and jax.grad of `jnp.take`; rows never gathered get 0."""
    rng = np.random.default_rng(8)
    n = 96
    segs, ids, _ = _sparse_ids(pattern, n, rng)
    x = rng.normal(size=(segs, 2)).astype(np.float32)
    proj = rng.normal(size=(n, 2)).astype(np.float32)
    _, j_grad = _jax_value_and_grad(
        lambda v: jnp.take(v, jnp.asarray(ids), axis=0), x, proj, dtype)
    t_out, t_grad = _torch_value_and_grad(
        lambda v: tseg.gather_rows(v, torch.from_numpy(ids)), x, proj, dtype)
    np.testing.assert_array_equal(t_out, np.asarray(
        jnp.take(jnp.asarray(x).astype(dtype), jnp.asarray(ids), axis=0),
        np.float32))
    _close(t_grad, j_grad, dtype)
    cot = jnp.asarray(proj).astype(dtype).astype(jnp.float32)
    by_ops = jax.ops.segment_sum(cot, jnp.asarray(ids), segs)
    _close(t_grad, by_ops, dtype)
    unnamed = np.ones(segs, bool)
    unnamed[ids] = False
    assert not t_grad[unnamed].any()


def test_cpu_routing_ends_in_k1_plain(monkeypatch):
    """On the CPU the sort, the mask and the reshape run as on the card and
    K1's plain version takes the final sum: forward and both backwards."""
    calls = []
    plain = expand_cuda.sorted_segment_sum_plain

    def counted(*args):
        calls.append(tuple(args[0].shape))
        return plain(*args)

    monkeypatch.setattr(expand_cuda, "sorted_segment_sum_plain", counted)
    ids, ids_pad, vals, mask, _ = _input((2, 4))
    x = torch.from_numpy(vals).requires_grad_(True)
    out = tseg.segment_sum(x, torch.from_numpy(ids_pad), S,
                           torch.from_numpy(mask))
    assert calls == [(E, 8)]
    y = torch.randn(S, 3, requires_grad=True)
    tseg.gather_rows(y, torch.from_numpy(ids)).sum().backward()
    assert calls == [(E, 8), (E, 3)]
    out.sum().backward()  # a gather: no sum
    assert len(calls) == 2


def test_cpu_sum_is_bitwise_repeatable():
    rng = np.random.default_rng(6)
    vals = torch.from_numpy(rng.normal(size=(4000, 16)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 7, 4000).astype(np.int32))
    first = tseg.segment_sum(vals, ids, 7)
    for _ in range(3):
        assert torch.equal(tseg.segment_sum(vals, ids, 7), first)


# the atomic float sums that may stay (`tests` guard: file, enclosing
# function): small-integer counts, or dense-grid writes of at most one
# nonzero term per cell with padding sent to a trash slot; and K1's
# plain version, which the CPU takes
ALLOWED = {
    ("models/gps.py", "_fake_grid"),
    ("ops/zemb_cuda.py", "count_matrix"),
    ("parallel/edge_partition.py", "_local_view"),
    ("models/ppgn.py", "PPGN.forward"),
    ("models/nested_ppgn.py", "NestedPPGN.forward"),
    ("ops/expand_cuda.py", "sorted_segment_sum_plain"),
}
ATOMIC = {"index_add_", "index_add", "scatter_add_", "scatter_add"}


def _atomic_sites(root: pathlib.Path):
    sites = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        tree = ast.parse(path.read_text())

        def walk(node, scope):
            for child in ast.iter_child_nodes(node):
                inner = scope
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    inner = scope + (child.name,)
                if isinstance(child, ast.Attribute) and child.attr in ATOMIC:
                    sites.append((rel, ".".join(scope), child.lineno))
                walk(child, inner)
        walk(tree, ())
    return sites


def test_no_atomic_float_sum_outside_the_allowlist():
    root = pathlib.Path(__file__).resolve().parents[1] / "escgnn_tpu_torch"
    sites = _atomic_sites(root)
    bad = [s for s in sites if s[:2] not in ALLOWED]
    assert not bad, f"atomic sums outside the allowlist: {bad}"
    # every allowlisted site is still there (a moved one is re-checked)
    assert {s[:2] for s in sites} == ALLOWED


def test_no_deterministic_mode_on_any_path():
    """`torch.use_deterministic_algorithms` is not the repair: no module
    of the port sets it."""
    root = pathlib.Path(__file__).resolve().parents[1] / "escgnn_tpu_torch"
    for path in root.rglob("*.py"):
        assert "use_deterministic_algorithms" not in path.read_text(), path


def test_determinism_probe_names_the_first_differing_op():
    """`tools/determinism_probe.py` on the CPU: two eager steps of the TU
    fold from one state are bit-equal with no op named; an op whose
    output bits differ in the second run is named by index and name."""
    import sys

    tools = str(pathlib.Path(__file__).resolve().parents[1] / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import determinism_probe as probe

    case = probe.build_cases(torch.device("cpu"), ["tu"], num_workers=0,
                             smoke=True)["tu"]
    a, b = probe.traced_step(case), probe.traced_step(case)
    same = probe.compare(a, b)
    assert same["loss_equal"] and same["grads_equal"]
    assert same["first_op_differing"] is None and same["ops"] > 100
    op, where, sums = b["ops"][7]
    b["ops"][7] = (op, where, sums + 1)
    named = probe.compare(a, b)["first_op_differing"]
    assert named["index"] == 7 and named["op"] == op


def test_determinism_probe_k1_helpers():
    """The probe's K1 table on the CPU: one eager step's calls recorded
    and deduplicated by shape and ids (each with its count), the stats of
    an id array (longest run, largest unnamed stretch, dropped
    positions), and `zeros + index_add_` on the unsorted ids equal to
    K1's plain version, positions outside [0, R) dropped."""
    import sys

    tools = str(pathlib.Path(__file__).resolve().parents[1] / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import determinism_probe as probe

    case = probe.build_cases(torch.device("cpu"), ["tu"], num_workers=0,
                             smoke=True)["tu"]
    calls = probe.record_k1_calls(case)
    distinct = probe.distinct_k1_calls(calls)
    assert sum(c for _, c in distinct) == len(calls) > len(distinct) > 0
    assert len({(d[0][0], d[0][4], d[0][3].numpy().tobytes())
                for d in distinct}) == len(distinct)
    rows = torch.tensor([-1, 0, 0, 0, 5, 5, 9, 12, 12], dtype=torch.int32)
    assert probe.ids_stats(rows, 12) == dict(longest_run=3, largest_gap=4,
                                             dropped=3)
    assert probe.ids_stats(rows, 20)["largest_gap"] == 7
    perm = torch.randperm(9).to(torch.int32)
    dZ = torch.randn(9, 4)
    got = probe.index_add_sum(dZ, perm, rows, 12)()[:12]
    want = expand_cuda.sorted_segment_sum_plain(dZ, perm, rows, 12)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
