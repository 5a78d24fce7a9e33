"""The port's parallel modes (`escgnn_tpu_torch/parallel/`) on two gloo
ranks on localhost, against the JAX package's CPU mesh and against the
port's single-device step.

One worker group per module (`tests/torch_parallel_worker.py`, two
processes, the port only) runs every case; the weights are a flax init
carried across with `escgnn_tpu_torch.weights`, the batches are made from
numpy seeds by both packages' batchers. Both sides are f32 (the JAX
table backward is set to f32). Compared, at loss rtol 1e-5 and gradient
rtol 1e-4 / atol 1e-5 (the parameters after one SGD step at lr 1e-2 at
rtol 1e-4 / atol 1e-6):
  * dp: one step against JAX's `make_dp_train_step` (gradients against the
    mean of JAX's per-replica gradients) and a 2-step pool epoch against
    `make_dp_pool_train_step`;
  * ep (width and dedup layouts), dp_ep (2 data shards) and an ep pool
    epoch against JAX's single-device SGD step on the whole batch (the
    pool epoch: two such steps in the epoch's order); each rank's edge
    shard, its multiplicities and its sorted view;
  * halo: the plan bit-equal to JAX's, GINEConv's halo aggregation, and
    one step of the node-level and of the graph-level NestedGINEff
    against JAX's single-device step; the toy GINE stack's aggregation
    and two of its training steps against JAX's `make_halo_gine_forward`
    and `make_halo_train_step` on a 2-device CPU mesh (losses at rtol
    1e-5, parameters at rtol 1e-5 / atol 1e-6);
  * ep on the flat layout (each rank's copy of the COO entries rebased
    to its edge slice) against JAX's single-device step;
  * multihost: degenerate in one process, joined in two, `process_shard`,
    the global mesh and `host_local_to_global`;
  * `batch_shardings` / `batch_shardings_2d` against JAX's placements,
    and `parallel.mesh.stack_batches` against JAX's.
The two workers' group is on a port rank 0 binds itself, and
`torchrun --standalone` picks its own port: no port is chosen first and
bound later, when another process may have taken it. Each torchrun rank
writes its own log file (`--redirects 3`): on one pipe their lines can
interleave.
"""

import glob
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.container import GraphData as JGraphData
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.transform import esc_transform as j_esc
from escgnn_tpu.models.nested_gin_eff import NestedGINEff as JNestedGINEff
from escgnn_tpu.models.nested_gin_eff import NestedGINEffConfig as JConfig
from escgnn_tpu.ops import zemb as j_zemb
from escgnn_tpu.parallel.data_parallel import (
    make_dp_pool_train_step as j_dp_pool,
    make_dp_train_step as j_dp_step,
    replicate_state as j_replicate_state,
)
from escgnn_tpu.parallel import edge_partition as j_ep
from escgnn_tpu.parallel.halo import (
    make_halo_gine_forward as j_halo_forward,
    make_halo_train_step as j_halo_train_step,
    plan_halo_sharding as j_plan_halo,
    scatter_edge_payload as j_scatter_edge_payload,
    shard_plan as j_shard_plan,
)
from escgnn_tpu.parallel.mesh import (
    make_mesh as j_make_mesh,
    shard_stacked as j_shard_stacked,
    stack_batches as j_stack_batches,
)
from escgnn_tpu.train.loop import (
    TrainState,
    l1_graph_loss as j_l1_graph,
    l1_node_loss as j_l1_node,
    make_train_step as j_make_train_step,
)
from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.data.prefetch import stack_batches
from escgnn_tpu_torch.featurize import EscConfig, esc_transform
from escgnn_tpu_torch.data import prefetch
from escgnn_tpu_torch.parallel import edge_partition as ep
from escgnn_tpu_torch.parallel import halo
from escgnn_tpu_torch.parallel import mesh as tmesh
from escgnn_tpu_torch.parallel.multihost import init_multihost, process_shard
from escgnn_tpu_torch.weights import flax_to_state_dict, halo_params
from tests.conftest import random_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
LR = 1e-2
NODE_CFG = dict(hidden=8, num_layers=2, graph_pred=False)
GRAPH_CFG = dict(hidden=8, num_layers=2, graph_pred=True, pool="add",
                 use_x_embedding_jk=False)


def _graphs(seed: int, k: int, node_level: bool = True):
    """k random graphs, ESC-featurized by each package from one draw."""
    rng = np.random.default_rng(seed)
    jg, tg = [], []
    for _ in range(k):
        n, ei = random_graph(rng, max_n=9)
        y = (rng.normal(size=(n, 1)) if node_level
             else rng.normal(size=(1,))).astype(np.float32)
        x = rng.normal(size=(n, 10)).astype(np.float32)
        jg.append(j_esc(JGraphData(num_nodes=n, edge_index=ei, x=x, y=y),
                        JEscConfig(h=2, use_rd=True, self_loop=True)))
        tg.append(esc_transform(GraphData(num_nodes=n, edge_index=ei, x=x,
                                          y=y),
                                EscConfig(h=2, use_rd=True, self_loop=True)))
    return jg, tg


def _jax(b):
    return jax.tree.map(jnp.asarray, b)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sgd_state(variables):
    return TrainState.create(
        jax.tree.map(jnp.array, variables["params"]),
        jax.tree.map(jnp.array, variables["batch_stats"]), optax.sgd(LR))


def _jax_sgd_steps(jm, variables, batches):
    """JAX's single-device SGD steps (lr `LR`, batch statistics, running
    statistics updated) on `batches` in turn: the first step's loss and
    gradients, and the parameters and statistics after the last."""
    params, stats = variables["params"], variables["batch_stats"]

    @jax.jit
    def step(params, stats, b):
        def loss_of(p):
            out, mut = jm.apply({"params": p, "batch_stats": stats}, b,
                                deterministic=True, use_running_average=False,
                                mutable=["batch_stats"])
            return j_l1_node(out, b), mut["batch_stats"]

        (loss, new_stats), g = jax.value_and_grad(loss_of, has_aux=True)(
            params)
        return loss, g, jax.tree.map(lambda p, d: p - LR * d, params, g), \
            new_stats

    first = None
    for b in batches:
        loss, g, params, stats = step(params, stats, _jax(b))
        first = first or dict(loss=float(loss), grads=_np(g))
    return dict(first, params=_np(params), stats=_np(stats))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Inputs, the JAX references, and the two ranks' results."""
    j_zemb.set_backward_matmul_dtype(jnp.float32)
    try:
        return _setup(tmp_path_factory.mktemp("parallel"))
    finally:
        j_zemb.set_backward_matmul_dtype(jnp.bfloat16)


def _setup(tmp):
    jg, tg = _graphs(0, 8)
    # dp: two width batches of 2 graphs (one per rank), and a pool of 4
    jspec, spec = JBatchSpec.from_graphs(jg, 2), BatchSpec.from_graphs(tg, 2)
    jb = [j_pad_and_batch(jg[2 * i:2 * i + 2], jspec) for i in range(4)]
    tb = [pad_and_batch(tg[2 * i:2 * i + 2], spec, device="cpu")
          for i in range(4)]
    jmodel = JNestedGINEff(JConfig(**NODE_CFG))
    variables = jmodel.init(jax.random.key(0), _jax(jb[0]))
    state = flax_to_state_dict(_np(variables["params"]),
                               _np(variables["batch_stats"]))
    jgm = JNestedGINEff(JConfig(**GRAPH_CFG))
    jgg, tgg = _graphs(1, 4, node_level=False)
    jhspec = JBatchSpec.from_graphs(jgg, 4)
    hspec = BatchSpec.from_graphs(tgg, 4)
    jgraph_b = j_pad_and_batch(jgg, jhspec)
    gvars = jgm.init(jax.random.key(0), _jax(jgraph_b))
    gstate = flax_to_state_dict(_np(gvars["params"]),
                                _np(gvars["batch_stats"]))
    ref = {}

    # JAX dp: one step over ranks' batches 0 and 1, a pool epoch
    mesh = j_make_mesh(2)
    stacked = j_shard_stacked(j_stack_batches(jb[:2]), mesh)
    s, loss = j_dp_step(jmodel, j_l1_node, mesh)(
        j_replicate_state(_sgd_state(variables), mesh), stacked,
        jax.random.key(1))
    grads = []
    for b in jb[:2]:
        def loss_of(p, b=_jax(b)):
            out, _ = jmodel.apply(
                {"params": p, "batch_stats": variables["batch_stats"]}, b,
                deterministic=True, use_running_average=False,
                mutable=["batch_stats"])
            return j_l1_node(out, b)
        grads.append(jax.grad(loss_of)(variables["params"]))
    ref["dp_step"] = dict(
        loss=float(loss), params=_np(s.params), stats=_np(s.batch_stats),
        grads=_np(jax.tree.map(lambda a, b: (a + b) / 2, *grads)))
    order = np.array([[2, 0], [1, 3]], np.int32)
    pool = _jax(j_stack_batches(jb))
    s, losses = j_dp_pool(jmodel, j_l1_node, mesh)(
        j_replicate_state(_sgd_state(variables), mesh), pool,
        jnp.asarray(order), jax.random.key(1))
    ref["dp_pool"] = dict(losses=np.asarray(losses), params=_np(s.params),
                          stats=_np(s.batch_stats))

    # ep / dp_ep / ep pool inputs: a width and a dedup batch of 4 graphs,
    # and a pool of the dedup batches of graphs 0-3 and 4-7 walked [1, 0]
    width = pad_and_batch(tg[:4], BatchSpec.from_graphs(tg, 4), device="cpu")
    dspec = BatchSpec.uniform(tg, 4, enc_layout="dedup")
    dedup = pad_and_batch(tg[:4], dspec, device="cpu")
    dpool = stack_batches([dedup, pad_and_batch(tg[4:], dspec,
                                                device="cpu")])
    jhb = j_pad_and_batch(jg[:4], JBatchSpec.from_graphs(jg, 4))
    jdspec = JBatchSpec.uniform(jg, 4, enc_layout="dedup")
    jdedup = [j_pad_and_batch(jg[:4], jdspec),
              j_pad_and_batch(jg[4:], jdspec)]
    ref["ep_width"] = _jax_sgd_steps(jmodel, variables, [jhb])
    ref["ep_dedup"] = ref["dp_ep"] = _jax_sgd_steps(jmodel, variables,
                                                    jdedup[:1])
    ref["ep_pool"] = _jax_sgd_steps(jmodel, variables, jdedup[::-1])

    # halo: the node-level width batch (4 graphs) and a graph-level one
    assert jhb.num_nodes % 2 == 0 and width.num_nodes % 2 == 0
    plan = halo.plan_halo_sharding(width, 2)
    gplan = halo.plan_halo_sharding(
        pad_and_batch(tgg, hspec, device="cpu"), 2)
    rng = np.random.default_rng(5)
    hx = rng.normal(size=(width.num_nodes, 6)).astype(np.float32)
    hemb = rng.normal(size=(width.num_edges, 6)).astype(np.float32)
    for name, jm, jvars, jbatch, jloss in (
            ("halo_node", jmodel, variables, jhb, j_l1_node),
            ("halo_graph", jgm, gvars, jgraph_b, j_l1_graph)):
        s, loss = j_make_train_step(jm, jloss)(
            _sgd_state(jvars), _jax(jbatch), jax.random.key(3))
        ref[name] = dict(loss=float(loss), params=_np(s.params),
                         stats=_np(s.batch_stats))
    # GINEConv with eps 0 and no MLP: x + the masked sum of messages
    jagg = jax.ops.segment_sum(
        jnp.where(jhb.edge_mask[:, None],
                  jax.nn.relu(jnp.asarray(hx)[jhb.senders] + hemb), 0.0),
        jhb.receivers, num_segments=jhb.num_nodes)
    ref["halo_agg"] = hx + np.asarray(jagg)

    # the toy GINE stack: two SGD steps on JAX's 2-device "model" mesh
    F, L = 4, 2
    toy = dict(num_layers=L, node_mask=np.asarray(jhb.node_mask),
               x=rng.normal(size=(width.num_nodes, F)).astype(np.float32),
               y=rng.normal(size=(width.num_nodes, F)).astype(np.float32),
               edge_emb=rng.normal(size=(width.num_edges, F)).astype(
                   np.float32),
               params={})
    for i in range(L):
        toy["params"][f"w_{i}"] = (0.3 * rng.normal(size=(F, F))).astype(
            np.float32)
        toy["params"][f"b_{i}"] = (0.1 * rng.normal(size=F)).astype(
            np.float32)
    hmesh = j_make_mesh(2, axis_names=("model",))
    jplan = j_plan_halo(jhb, 2)
    jplan_sh = j_shard_plan(jplan, hmesh)
    je = jnp.asarray(j_scatter_edge_payload(jplan, toy["edge_emb"]))
    ref["toy_agg"] = np.asarray(j_halo_forward(hmesh)(
        jnp.asarray(toy["x"]), je, jplan_sh))
    jstep = j_halo_train_step(hmesh, num_layers=L, lr=LR)
    params, losses = jax.tree.map(jnp.asarray, toy["params"]), []
    for _ in range(2):
        params, loss = jstep(params, jnp.asarray(toy["x"]), je,
                             jnp.asarray(toy["y"]),
                             jnp.asarray(toy["node_mask"]), jplan_sh)
        losses.append(float(loss))
    ref["toy_step"] = dict(losses=losses, params=_np(params))

    # ep on the flat layout: JAX's single-device step on the same batch
    fspec = BatchSpec.uniform(tg, 4, enc_layout="flat")
    jfspec = JBatchSpec.uniform(jg, 4, enc_layout="flat")
    flat = pad_and_batch(tg[:4], fspec, device="cpu")
    ref["ep_flat"] = _jax_sgd_steps(jmodel, variables,
                                    [j_pad_and_batch(jg[:4], jfspec)])

    inp = dict(
        in_dim=10, lr=LR, model_cfg=NODE_CFG, model_state=state,
        graph_cfg=GRAPH_CFG, graph_state=gstate,
        dp_stacked=stack_batches(tb[:2]), dp_pool=stack_batches(tb),
        dp_order=order, ep_width=width, ep_dedup=dedup, ep_pool=dpool,
        ep_order=[1, 0],
        halo_plan=plan, halo_x=torch.from_numpy(hx),
        halo_edge_emb=torch.from_numpy(hemb),
        halo_node_batch=halo.build_halo_batch(width, plan),
        halo_graph_batch=halo.build_halo_batch(
            pad_and_batch(tgg, hspec, device="cpu"), gplan),
        toy=toy, ep_flat=flat, global_rows=torch.arange(16.0).reshape(8, 2),
    )
    torch.save(inp, tmp / "in.pt")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", str(tmp / "in.pt"), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    return dict(ref=ref, inp=inp, ranks=ranks, variables=variables,
                jmodel=jmodel, jhb=jhb)


def _close_tree(got: dict, want: dict, rtol, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def _flax_state(params, stats=None):
    return {k: v.numpy() for k, v in
            flax_to_state_dict(params, stats or {}).items()}


def _both_ranks_equal(setup, case):
    a, b = (r[case]["state"] for r in setup["ranks"])
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_dp_step_equals_jax(setup):
    """The dp step (rank 1 started from other weights, put back by
    replicate_state): loss, the summed gradients against the mean of JAX's
    per-replica gradients, the parameters and BN statistics after the SGD
    step against JAX's `make_dp_train_step`; both ranks equal."""
    got, want = setup["ranks"][0]["dp_step"], setup["ref"]["dp_step"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _close_tree({k: v.numpy() for k, v in got["grads"].items()},
                _flax_state(want["grads"]), 1e-4, 1e-5)
    _close_tree({k: v.numpy() for k, v in got["state"].items()},
                _flax_state(want["params"], want["stats"]), 1e-4, 1e-6)
    _both_ranks_equal(setup, "dp_step")


def test_dp_pool_epoch_equals_jax(setup):
    """Two dp pool steps over a (2, 2) order: the per-step replica-mean
    losses and the final parameters and statistics against JAX's
    `make_dp_pool_train_step`; a (steps, 1) order is refused."""
    got, want = setup["ranks"][0]["dp_pool"], setup["ref"]["dp_pool"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _close_tree({k: v.numpy() for k, v in got["state"].items()},
                _flax_state(want["params"], want["stats"]), 1e-4, 1e-6)
    _both_ranks_equal(setup, "dp_pool")
    assert "(steps, 2)" in setup["ranks"][0]["dp_bad_order"]


@pytest.mark.parametrize("case,batch", [("ep_width", "ep_width"),
                                        ("ep_dedup", "ep_dedup"),
                                        ("ep_flat", "ep_flat"),
                                        ("dp_ep", "ep_dedup")])
def test_edge_partition_equals_single_device(setup, case, batch):
    """ep on the width, dedup and flat layouts (the dedup shard carries
    its own multiplicities and sorted view, the flat shard its own
    rebased copy of the COO entries) and dp_ep over 2 data shards: the
    global loss, the summed gradients and the state after the step equal
    JAX's single-device step on the whole batch; both ranks equal."""
    want = setup["ref"][case]
    for r in setup["ranks"]:
        got = r[case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        _close_tree({k: v.numpy() for k, v in got["grads"].items()},
                    _flax_state(want["grads"]), 1e-4, 1e-5)
        _close_tree({k: v.numpy() for k, v in got["state"].items()},
                    _flax_state(want["params"], want["stats"]), 1e-4, 1e-6)
    _both_ranks_equal(setup, case)
    if case == "dp_ep":
        N = setup["inp"][batch].num_nodes
        assert [r["dp_ep_rows"] for r in setup["ranks"]] == [N // 2] * 2


def test_ep_pool_epoch_equals_single_device(setup):
    """The ep pool epoch over a 2-batch dedup pool in the order [1, 0]
    equals JAX's single-device SGD steps on those batches in that order:
    the first step's loss and the state after the epoch."""
    want = setup["ref"]["ep_pool"]
    for r in setup["ranks"]:
        np.testing.assert_allclose(r["ep_pool"]["losses"][0], want["loss"],
                                   rtol=1e-5)
        _close_tree({k: v.numpy() for k, v in r["ep_pool"]["state"].items()},
                    _flax_state(want["params"], want["stats"]), 1e-4, 1e-6)
    _both_ranks_equal(setup, "ep_pool")


@pytest.mark.parametrize("layout", ["width", "dedup"])
def test_edge_shards_carry_their_own_view(setup, layout):
    """Each rank's ep shard holds its contiguous half of every edge field,
    the replicated fields whole; on the dedup layout its row
    multiplicities count its own edges (the ranks' sum is the batch's)
    and its sorted view sorts its own `enc_edge_row`."""
    whole = setup["inp"][f"ep_{layout}"].tensors()
    shards = [r[f"ep_{layout}"]["shard"] for r in setup["ranks"]]
    E = whole["edge_mask"].shape[0]
    for k, v in whole.items():
        if k in ("enc_row_weight", "enc_edge_perm", "enc_row_sorted"):
            continue
        split = k in ("senders", "receivers", "edge_mask", "edge_attr",
                      "enc_edge_row") or (
            k in ("enc_idx", "enc_cnt") and layout == "width")
        for d, sh in enumerate(shards):
            want = v[d * E // 2:(d + 1) * E // 2] if split else v
            torch.testing.assert_close(sh[k], want, rtol=0, atol=0, msg=k)
    if layout == "dedup":
        torch.testing.assert_close(
            shards[0]["enc_row_weight"] + shards[1]["enc_row_weight"],
            whole["enc_row_weight"], rtol=0, atol=0)
        for sh in shards:
            rows = sh["enc_edge_row"].long()
            perm = sh["enc_edge_perm"].long()
            assert torch.equal(rows[perm], sh["enc_row_sorted"].long())
            assert bool((sh["enc_row_sorted"][1:]
                         >= sh["enc_row_sorted"][:-1]).all())
            assert sh["enc_row_weight"].sum() == sh["edge_mask"].sum()


@pytest.mark.parametrize("budgets", [(0, 0, 0), (512, 16, 24)])
def test_halo_plan_bit_equal_to_jax(budgets):
    """`plan_halo_sharding` (a numpy copy) gives JAX's plan array for
    array, dtype for dtype, at 2 and 4 devices, with and without budgets."""
    jg, tg = _graphs(2, 5)
    jb = j_pad_and_batch(jg, JBatchSpec.from_graphs(jg, 5))
    tb = pad_and_batch(tg, BatchSpec.from_graphs(tg, 5), device="cpu")
    for D in (2, 4):
        want = j_plan_halo(jb, D, *budgets)
        got = halo.plan_halo_sharding(tb, D, *budgets)
        assert got.nodes_per_shard == want.nodes_per_shard
        for f in halo.PLAN_FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_halo_aggregation_equals_jax(setup):
    """GINEConv's halo path (eps 0, no MLP) on each rank's rows, the
    remote senders brought by `halo_exchange`, put together, equals x +
    the single-device masked GINE sum computed by JAX."""
    got = torch.cat([r["halo_agg"] for r in setup["ranks"]]).numpy()
    np.testing.assert_allclose(got, setup["ref"]["halo_agg"], rtol=1e-5,
                               atol=1e-6)


def test_graphed_steps_refuse_gloo(setup):
    """A parallel pool step on a CUDA device (a CUDA graph) under gloo
    raises (gloo's collectives cannot be captured); it never turns eager
    on its own."""
    for r in setup["ranks"]:
        assert "needs NCCL" in r["graphed_gloo"]


@pytest.mark.parametrize("case", ["halo_node", "halo_graph"])
def test_halo_model_step_equals_jax(setup, case):
    """One halo step of NestedGINEff (node-level head: row shares of the
    masked L1; graph-level head: the pooled rows whole on each rank, the
    loss / D) equals JAX's single-device SGD step on the width batch:
    loss, parameters and BN statistics; both ranks equal."""
    want = setup["ref"][case]
    for r in setup["ranks"]:
        got = r[case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        _close_tree({k: v.numpy() for k, v in got["state"].items()},
                    _flax_state(want["params"], want["stats"]), 1e-4, 1e-5)
    _both_ranks_equal(setup, case)


def test_multihost_joined_and_degenerate(setup):
    """In the two-rank group `init_multihost` returns (2, rank) and
    `process_shard` strides by rank; in this one process, with no
    coordinator and no torchrun environment, it initializes nothing."""
    for rank, r in enumerate(setup["ranks"]):
        assert r["multihost"] == (2, rank)
        assert r["shard"] == list(range(7))[rank::2]
    if "WORLD_SIZE" not in os.environ:
        assert init_multihost() in ((1, 0),)
    assert process_shard(list(range(5)), 0, 1) == list(range(5))
    parts = [process_shard(list(range(10)), p, 4) for p in range(4)]
    assert parts[1] == [1, 5, 9] and sorted(sum(parts, [])) == list(range(10))


@pytest.mark.parametrize("flags", [["--mesh", "ep"],
                                   ["--mesh", "dp", "--multihost"]])
def test_twin_on_two_ranks_under_torchrun(tmp_path, flags):
    """`run_graphcount` launched as two gloo ranks by torchrun
    (`torch.distributed.run`, `--standalone`: it binds its own port):
    both ranks print the same epoch lines (ep: the single-rank run's
    losses; dp with per-process train shards: the refreshed BN statistics
    averaged, so both evaluate alike), each in its own log file, and
    rank 0 alone writes the run's log and the checkpoints."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    args = ["--device", "cpu", "--num_graphs", "40", "--hidden", "16",
            "--layers", "2", "--batch_size", "8", "--epochs", "2",
            "--data_dir", str(tmp_path / "data")]
    logs = tmp_path / "logs"
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "--log-dir", str(logs), "--redirects", "3",
         "-m", "escgnn_tpu_torch.run_graphcount", *args,
         "--res_dir", str(tmp_path / "run"), *flags],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    out = {rank: "".join(open(f).read() for f in sorted(glob.glob(
        str(logs / "**" / str(rank) / "std*.log"), recursive=True)))
        for rank in (0, 1)}
    assert r.returncode == 0, (r.stderr[-3000:] + out[0][-2000:]
                               + out[1][-2000:])
    lines = {rank: [ln.rsplit(" (", 1)[0] for ln in text.splitlines()
                    if ln.startswith("epoch")]
             for rank, text in out.items()}
    assert len(lines[0]) == 2 and lines[0] == lines[1], lines
    log = (tmp_path / "run" / "log.txt").read_text().splitlines()
    assert [ln.rsplit(" (", 1)[0] for ln in log if ln.startswith("epoch")] \
        == lines[0]
    assert sorted(os.listdir(tmp_path / "run" / "ckpt")) == ["1.pt", "2.pt"]


def test_flat_edge_shards_rebase_their_entries(setup):
    """Each rank keeps all K flat entries; those of its edge slice point
    at its local edge ids with their counts, the others carry count 0;
    the ranks' counts add up to the batch's."""
    whole = setup["inp"]["ep_flat"].tensors()
    E = whole["edge_mask"].shape[0]
    total = torch.zeros_like(whole["enc_flat_cnt"])
    for d, r in enumerate(setup["ranks"]):
        sh = r["ep_flat"]["shard"]
        edge, cnt = whole["enc_flat_edge"].long(), whole["enc_flat_cnt"]
        mine = (edge >= d * E // 2) & (edge < (d + 1) * E // 2)
        assert torch.equal(sh["enc_flat_idx"], whole["enc_flat_idx"])
        assert torch.equal(sh["enc_flat_edge"][mine].long(),
                           edge[mine] - d * E // 2)
        assert torch.equal(sh["enc_flat_cnt"][mine], cnt[mine])
        assert not sh["enc_flat_cnt"][~mine].any()
        total += sh["enc_flat_cnt"]
    assert torch.equal(total, whole["enc_flat_cnt"])


def test_halo_toy_stack_equals_jax(setup):
    """The toy GINE stack under the halo plan: each rank's aggregation
    rows put together equal JAX's `make_halo_gine_forward`; two SGD steps
    of `make_halo_train_step` (parameters carried by
    `weights.halo_params`) give JAX's losses and parameters; both ranks
    equal."""
    want = setup["ref"]["toy_step"]
    got = torch.cat([r["toy_agg"] for r in setup["ranks"]]).numpy()
    np.testing.assert_allclose(got, setup["ref"]["toy_agg"], rtol=1e-5,
                               atol=1e-6)
    for r in setup["ranks"]:
        np.testing.assert_allclose(r["toy_step"]["losses"], want["losses"],
                                   rtol=1e-5)
        _close_tree({k: v.numpy() for k, v in r["toy_step"]["params"].items()},
                    want["params"], 1e-5, 1e-6)
    a, b = (r["toy_step"]["params"] for r in setup["ranks"])
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_halo_params_round_trip(setup):
    """`weights.halo_params` keeps every name, value and layout of the toy
    stack's dict, and refuses a dict missing a layer's bias."""
    params = setup["inp"]["toy"]["params"]
    got = halo_params(params, "cpu")
    assert sorted(got) == sorted(params)
    for k, v in params.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v)
    with pytest.raises(ValueError, match="w_i and b_i"):
        halo_params({"w_0": params["w_0"]}, "cpu")


def test_global_mesh_and_host_local_to_global(setup):
    """Two ranks: the global mesh spans the world on "data"; each rank's
    strided rows placed by `host_local_to_global` come back gathered in
    rank order, the rows of the whole array. One process: JAX's
    `host_local_to_global` is a device_put; the port's gives the same
    values on the CPU."""
    from escgnn_tpu.parallel import multihost as j_multihost

    rows = setup["inp"]["global_rows"]
    for r in setup["ranks"]:
        assert r["global_mesh"] == (("data",), 2)
        g = r["global_rows"]
        assert torch.equal(g[0], rows[0::2]) and torch.equal(g[1], rows[1::2])
    jmesh = j_make_mesh(1)
    want = j_multihost.host_local_to_global(
        {"a": np.arange(6.0).reshape(3, 2)}, jmesh,
        jax.sharding.PartitionSpec("data"))
    fake = types.SimpleNamespace(mesh_dim_names=("data",))
    from escgnn_tpu_torch.parallel.multihost import host_local_to_global

    got = host_local_to_global({"a": np.arange(6.0).reshape(3, 2)}, fake,
                               "data", device="cpu")
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    with pytest.raises(ValueError, match="not axes"):
        host_local_to_global({}, fake, "model", device="cpu")


def _jax_placement(sharding) -> str:
    spec = tuple(sharding.spec)
    if not spec:
        return "replicated"
    return "rows" if spec == ("data",) else "edges"


@pytest.mark.parametrize("layout", ["ep_width", "ep_dedup", "ep_flat"])
def test_batch_shardings_equal_jax(setup, layout):
    """`batch_shardings` and `batch_shardings_2d` place every tensor as
    JAX's do: split over the edge axes, over the data axis, or whole;
    the port's "local" tensors (the dedup multiplicities and sorted view,
    the flat entries) are whole in JAX too."""
    batch = setup["inp"][layout]
    host = {k: v.numpy() for k, v in batch.tensors().items()}
    from escgnn_tpu.data.container import GraphBatch as JGraphBatch

    jb = JGraphBatch(**host)
    mesh1 = types.SimpleNamespace(mesh_dim_names=("model",))
    mesh2 = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    jmesh1 = j_make_mesh(2, axis_names=("model",))
    jmesh2 = j_make_mesh(shape=(1, 2), axis_names=("data", "model"))
    for got, want in (
            (ep.batch_shardings(batch, mesh1),
             j_ep.batch_shardings(jb, jmesh1)),
            (ep.batch_shardings_2d(batch, mesh2),
             j_ep.batch_shardings_2d(jb, jmesh2))):
        assert set(got) == set(host)
        for k, place in got.items():
            jplace = _jax_placement(getattr(want, k))
            assert (place if place != "local" else "replicated") == jplace, k
    with pytest.raises(ValueError, match="not axes"):
        ep.batch_shardings(batch, mesh2, "edges")


def test_stack_batches_is_the_pools_and_equals_jax(setup):
    """`parallel.mesh.stack_batches` is `data.prefetch.stack_batches`, and
    stacks JAX's arrays."""
    assert tmesh.stack_batches is prefetch.stack_batches
    tb = [setup["inp"]["ep_width"], setup["inp"]["ep_width"]]
    got = tmesh.stack_batches(tb)
    host = [{k: v.numpy() for k, v in b.tensors().items()} for b in tb]
    want = j_stack_batches(host)
    for k, v in got.tensors().items():
        np.testing.assert_array_equal(v.numpy(), want[k])
