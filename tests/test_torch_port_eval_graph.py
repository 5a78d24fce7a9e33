"""The pool eval and the BN refresh replayed from CUDA graphs
(`train/loop.py` `_GraphedForwardPool`), held bit for bit to the eager
path on the same card: NestedGIN_eff at graph level, PPGN_eff at node
level (plain and compressed stacks), NGNN copies at segment level, both
BatchNorm modes; one capture per batch layout, a fresh one for a rebound
parameter; the eval leaves the model as it was. The card tests skip
without a CUDA card; on the card, where JAX is not installed, run them
with `python3 -m pytest --noconftest tests/test_torch_port_eval_graph.py`.
The last test holds the CPU path to eager, with no replay."""

import numpy as np
import pytest
import torch

from escgnn_tpu_torch import run_graphcount as rg
from escgnn_tpu_torch import run_zinc_cycle
from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.counting import (
    CountingDatasetConfig,
    generate_counting_graphs,
    normalize_targets,
)
from escgnn_tpu_torch.data.molecules import synthetic_zinc
from escgnn_tpu_torch.data.prefetch import (
    pool_entry,
    pool_size,
    stack_split,
    stack_split_compressed,
)
from escgnn_tpu_torch.featurize import EscConfig, featurize_many
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.train import loop
from escgnn_tpu_torch.train.copies import copy_layout_spec
from escgnn_tpu_torch.utils import trace

ZINC_CFG = dict(hidden=16, num_layers=2, act="elu", graph_pred=True,
                pool="add", use_x_embedding_jk=False,
                head_order="dropout_act", node_embed_vocab=100,
                node_embed_dim=4, edge_embed_vocab=100, edge_embed_dim=4)
CASES = ("zinc_graph", "count_node", "count_node_compressed",
         "cycle_segment")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the card: python3 -m pytest "
                    "--noconftest tests/test_torch_port_eval_graph.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _clean_registry():
    trace.reset()
    yield
    trace.reset()


def _zinc(device):
    graphs = featurize_many(synthetic_zinc(40, seed=3), EscConfig(h=2))
    spec = BatchSpec.uniform(graphs, 8, enc_layout="dedup")
    model = NestedGINEff(NestedGINEffConfig(**ZINC_CFG), device=device,
                         generator=torch.Generator().manual_seed(0))
    return dict(model=model, loss=loop.l1_graph_loss, graphs=graphs,
                spec=spec, kw=dict(node_level=False), transform=None)


def _count(device):
    args = rg.build_parser().parse_args(
        ["--model", "PPGN_eff", "--hidden", "16", "--layers", "2",
         "--h", "2", "--device", str(device)])
    splits = generate_counting_graphs(CountingDatasetConfig(num_graphs=60,
                                                            seed=0))
    splits, _, _ = normalize_targets(splits, 0)
    graphs = featurize_many(splits["train"], EscConfig(h=2, use_rd=True,
                                                       self_loop=True))
    spec = BatchSpec.uniform(graphs, 8, enc_layout="dedup")
    model = rg.build_model(args, spec, graphs[0].x.shape[1], device)
    return dict(model=model, loss=loop.l1_node_loss, graphs=graphs,
                spec=spec, kw=dict(node_level=True), transform=None)


def _cycle(device):
    args = run_zinc_cycle.build_parser().parse_args(
        ["--model", "NGNN", "--num_graphs", "40", "--hidden", "16",
         "--layers", "2", "--batch_size", "8", "--device", str(device)])
    splits, _, _ = run_zinc_cycle.build_splits(args)
    splits, spec, transform = copy_layout_spec(splits, 8, "uniform")
    model = run_zinc_cycle.build_model(args, device)
    return dict(model=model, loss=loop.l1_segment_loss,
                graphs=splits["train"], spec=spec,
                kw=dict(node_level=True, segment_level=True),
                transform=transform)


def _setup(case: str, device):
    """The case's model on `device` after one eager Adam step (its
    running statistics off their initial values), its graphs, spec, a
    stack of the first 24 graphs (its decoder for the compressed case)."""
    s = {"zinc_graph": _zinc, "count_node": _count,
         "count_node_compressed": _count, "cycle_segment": _cycle}[case](
             device)
    if case.endswith("_compressed"):
        s["stack"], s["decode"] = stack_split_compressed(
            s["graphs"][:24], s["spec"], device, s["transform"])
    else:
        s["stack"] = stack_split(s["graphs"][:24], s["spec"], device,
                                 s["transform"])
        s["decode"] = None
    s["opt"] = loop.adam_with_plateau(s["model"].parameters(), 1e-3)
    _adam_step(s)
    return s


def _adam_step(s) -> None:
    b = pool_entry(s["stack"], 0)
    loop.train_step(s["model"], s["opt"],
                    b if s["decode"] is None else s["decode"](b), s["loss"])


def _eager_eval(s, bn_mode):
    """The eager pool eval on the card: `eval_step` per batch, summed in
    batch order."""
    total = count = None
    for b in loop._pool_batches(s["stack"], s["decode"]):
        e, c = loop.eval_step(s["model"], b, bn_mode=bn_mode, **s["kw"])
        total = e if total is None else total + e
        count = c if count is None else count + c
    return total, count


def _eager_refresh(s) -> dict:
    """The running statistics the eager refresh leaves, the model put back
    in place as it was."""
    model = s["model"]
    snap = loop._snapshot(model)
    loop.refresh_bn_stats(loop.make_bn_refresh_step(model), model,
                          loop._pool_batches(s["stack"], s["decode"]))
    want = loop.bn_stats(model)
    loop._restore_in_place(model, None, snap)
    return want


def _state(model) -> list:
    return [t.detach().clone() for t in loop._model_tensors(model)]


def _assert_same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("bn_mode", loop._BN_MODES)
@pytest.mark.parametrize("case", CASES)
def test_graphed_eval_equals_eager(cuda, case, bn_mode):
    """Over two calls with an in-place Adam step between them: the
    graphed (sum, count) equals the eager one bit for bit, and the eval
    leaves every parameter and running statistic as it found them."""
    s = _setup(case, cuda)
    eval_pool = loop.make_pool_eval_step(s["model"], bn_mode=bn_mode,
                                         decode=s["decode"], **s["kw"])
    n = pool_size(s["stack"])
    for call in range(2):
        want = _eager_eval(s, bn_mode)
        before = _state(s["model"])
        got = eval_pool(s["stack"])
        _assert_same(_state(s["model"]), before)
        _assert_same(list(got), list(want))
        assert float(got[1]) > 0
        _adam_step(s)
    assert trace.counter("eval.captures") == 1
    assert trace.counter("eval.replays") == 2 * n


@pytest.mark.parametrize("case", CASES)
def test_graphed_refresh_equals_eager(cuda, case):
    """Over two calls with an in-place Adam step between them: the
    graphed refresh leaves the eager refresh's running statistics bit for
    bit, and touches no parameter."""
    s = _setup(case, cuda)
    model = s["model"]
    refresh = loop.make_pool_refresh_step(model, decode=s["decode"])
    for call in range(2):
        want = _eager_refresh(s)
        params = [p.detach().clone() for p in model.parameters()]
        refresh(s["stack"])
        got = loop.bn_stats(model)
        assert list(got) == list(want)
        _assert_same(list(got.values()), list(want.values()))
        _assert_same([p.detach() for p in model.parameters()], params)
        _adam_step(s)
    n = pool_size(s["stack"])
    assert trace.counter("refresh.captures") == 1
    assert trace.counter("refresh.replays") == trace.counter(
        "refresh.batches") == 2 * n


def test_one_capture_per_layout_and_model_address(cuda):
    """Val and test stacks of one layout share a capture across calls; a
    stack of another layout captures its own; a rebound parameter forces
    a fresh capture, whose sums still equal eager."""
    s = _setup("zinc_graph", cuda)
    model, graphs, spec = s["model"], s["graphs"], s["spec"]
    val = stack_split(graphs[:24], spec, cuda)
    test = stack_split(graphs[24:40], spec, cuda)
    eval_pool = loop.make_pool_eval_step(model, node_level=False)
    for stack in (val, test, val):
        s["stack"] = stack
        _assert_same(list(eval_pool(stack)), list(_eager_eval(s, "running")))
    assert trace.counter("eval.captures") == 1
    assert trace.counter("eval.replays") == 2 * pool_size(val) + pool_size(
        test)

    other_spec = BatchSpec.uniform(graphs, 4, enc_layout="dedup")
    s["stack"] = stack_split(graphs[:8], other_spec, cuda)
    _assert_same(list(eval_pool(s["stack"])), list(_eager_eval(s, "running")))
    assert trace.counter("eval.captures") == 2

    p = next(model.parameters())
    ptr = p.data_ptr()
    p.data = p.data.clone() * 1.5  # rebound, not written in place
    assert p.data_ptr() != ptr
    s["stack"] = val
    _assert_same(list(eval_pool(val)), list(_eager_eval(s, "running")))
    assert trace.counter("eval.captures") == 3
    eval_pool(val)
    assert trace.counter("eval.captures") == 3


class _NoStatistics(torch.nn.Module):
    """A graph-level model without BatchNorm: a refresh has no statistic
    to re-estimate."""

    def __init__(self, device):
        super().__init__()
        self.lin = torch.nn.Linear(1, 1, device=device)

    def forward(self, batch):
        return self.lin(batch.graph_mask[:, None].float())


def test_model_without_statistics(cuda):
    """A model with no BatchNorm statistic: the graphed refresh replays
    its forward and changes nothing, as the eager one; its graphed eval
    still equals eager."""
    s = _setup("zinc_graph", cuda)
    s["model"] = model = _NoStatistics(cuda)
    params = _state(model)
    loop.make_pool_refresh_step(model)(s["stack"])
    _assert_same(_state(model), params)
    assert trace.counter("refresh.replays") == pool_size(s["stack"])
    got = loop.make_pool_eval_step(model, node_level=False)(s["stack"])
    _assert_same(list(got), list(_eager_eval(s, "running")))


def test_cpu_stack_runs_eager():
    """A stack on the CPU runs the eager path: batches counted, no
    capture and no replay, the four spans at their per-batch counts."""
    graphs = featurize_many(synthetic_zinc(12, seed=3), EscConfig(h=2))
    spec = BatchSpec.uniform(graphs, 4, enc_layout="dedup")
    stack = stack_split(graphs, spec, "cpu")
    model = NestedGINEff(NestedGINEffConfig(**ZINC_CFG), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    trace.reset()
    loop.make_pool_refresh_step(model)(stack)
    e, c = loop.make_pool_eval_step(model, node_level=False)(stack)
    n = pool_size(stack)
    assert np.isfinite(float(e)) and float(c) == float(np.sum(
        stack.graph_mask.numpy()))
    got = trace.snapshot()
    assert got["counters"] == {"refresh.batches": n, "eval.batches": n}
    assert {k: v["calls"] for k, v in got["spans"].items()} == {
        "refresh": 1, "refresh.forward": n, "eval": 1, "eval.forward": n}
    for k in ("eval.replays", "eval.captures", "refresh.replays",
              "refresh.captures"):
        assert trace.counter(k) == 0
