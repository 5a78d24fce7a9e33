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
    against JAX's single-device step;
  * multihost: degenerate in one process, joined in two, `process_shard`.
"""

import os
import socket
import subprocess
import sys

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
from escgnn_tpu.parallel.halo import plan_halo_sharding as j_plan_halo
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
from escgnn_tpu_torch.parallel import halo
from escgnn_tpu_torch.parallel.multihost import init_multihost, process_shard
from escgnn_tpu_torch.weights import flax_to_state_dict
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


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


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
    )
    torch.save(inp, tmp / "in.pt")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), str(r), "2", str(tmp / "in.pt"),
         str(tmp)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
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
                                        ("dp_ep", "ep_dedup")])
def test_edge_partition_equals_single_device(setup, case, batch):
    """ep on the width and the dedup layout (the dedup shard carries its
    own multiplicities and sorted view) and dp_ep over 2 data shards:
    the global loss, the summed gradients and the state after the step
    equal JAX's single-device step on the whole batch; both ranks
    equal."""
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
    (`torch.distributed.run`): both ranks print the same epoch lines (ep:
    the single-rank run's losses; dp with per-process train shards: the
    refreshed BN statistics averaged, so both evaluate alike), and rank 0
    alone writes the log and the checkpoints."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    args = ["--device", "cpu", "--num_graphs", "40", "--hidden", "16",
            "--layers", "2", "--batch_size", "8", "--epochs", "2",
            "--data_dir", str(tmp_path / "data")]
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(_free_port()), "-m",
         "escgnn_tpu_torch.run_graphcount", *args,
         "--res_dir", str(tmp_path / "run"), *flags],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("epoch")]
    assert len(lines) == 4
    strip = sorted(ln.rsplit(" (", 1)[0] for ln in lines)
    assert strip[0] == strip[1] and strip[2] == strip[3]
    log = (tmp_path / "run" / "log.txt").read_text().splitlines()
    assert [ln.rsplit(" (", 1)[0] for ln in log if ln.startswith("epoch")] \
        == [strip[0], strip[2]]
    assert sorted(os.listdir(tmp_path / "run" / "ckpt")) == ["1.pt", "2.pt"]
