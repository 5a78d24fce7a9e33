"""chip_smoke.py's count of a kernel's launches in CUDA-graph replays:
the kernel's nodes in the captured graph's DOT dump times the replays.
The capture itself needs a card; the DOT reading and the wrapping of
`torch.cuda.CUDAGraph` are checked here, and so are `_hold_grads`, the
rule the card's parallel-mode gradients are held by, and
`_hold_grads_to_order_spread`, `[small_gps]`'s rule for the
ppa_uniform gradients.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import chip_smoke  # noqa: E402

# a verbose `cuGraphDebugDotPrint` dump of a captured step: K3, an
# elementwise kernel, a memset and a reduction, labels cut short
DOT = r'''digraph dot {
subgraph cluster_5 {
label="graph_5" graph[style="dashed"];
"graph_5_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 3) | _ZN9zemb_rows16zemb_rows_kernelILi1ELb0ELb0EEEvPKfPKiS3_iiiiiPfS6_\<\<\<132,1024,8320\>\>\>}
| {{node handle | func handle} | {0x000000000AE5A5F0 | 0x000000000982C1C0}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_5_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 2) | _ZN2at6native29vectorized_elementwise_kernelILi4EEEviT0_T1_\<\<\<250,128,0\>\>\>}
| {cooperative | 0}
}"];

"graph_5_node_2"[style="solid" style="solid" shape="record" label="{MEMSET
| {{ID | node handle | dptr | pitch | value | elementSize | width | height} | {2 (topoId: 1) | 0x000000000AE5B4C0 | 0x00007FC1F0BF4400 | 0 | 0 | 1 | 4 | 1}}}"];

"graph_5_node_3"[style="bold" shape="record" label="{KERNEL
| {ID | 3 (topoId: 0) | _ZN2at6native13reduce_kernelILi512ELi1EEEvT1_\<\<\<\{1,32\},512,2048\>\>\>}
| {cooperative | 0}
}"];

"graph_5_node_0" -> "graph_5_node_1" [headlabel=0];
"graph_5_node_1" -> "graph_5_node_2" [headlabel=0];
"graph_5_node_2" -> "graph_5_node_3" [headlabel=0];
}
}
'''


@pytest.mark.parametrize("symbol,want", [
    ("", 4), ("{KERNEL", 3), ("{MEMSET", 1), ("zemb_rows_kernel", 1),
    ("segsum_kernel", 0), ("graph_5_node_1", 1)])
def test_dot_nodes_counts_declarations_not_edges(symbol, want):
    """A node counts once whatever its label holds; edge lines, which
    name two nodes each, count for none."""
    assert chip_smoke._dot_nodes(DOT, symbol) == want


def test_ledger_counts_nodes_times_replays():
    ledger = chip_smoke._GraphLedger()
    ledger.dots = [DOT, DOT.replace("zemb_rows_kernel", "other_kernel")]
    ledger.replays = [3, 5]
    assert ledger.nodes("zemb_rows_kernel") == 1
    assert ledger.launches("zemb_rows_kernel") == 3
    assert ledger.launches("{KERNEL") == 3 * 3 + 3 * 5
    ledger.clear_replays()
    assert ledger.replays == [0, 0] and ledger.launches("{KERNEL") == 0


def test_ledger_counts_train_and_forward_graphs_apart():
    """A forward-only eval or refresh graph's launches count apart from
    the train steps' graphs."""
    ledger = chip_smoke._GraphLedger()
    ledger.dots = [DOT, DOT, DOT.replace("zemb_rows_kernel", "other")]
    ledger.replays = [2, 7, 5]
    ledger.forward = [False, True, True]
    assert ledger.launches("zemb_rows_kernel") == 9
    assert ledger.launches("zemb_rows_kernel", forward=False) == 2
    assert ledger.launches("zemb_rows_kernel", forward=True) == 7
    assert ledger.launches("{KERNEL", forward=True) == 3 * 12


def test_ledger_watch_puts_cuda_graph_back():
    """The wrapped capture end and replay, and the forward graph's
    constructor, are the originals again after `watch()`, also when the
    watched code raises."""
    from escgnn_tpu_torch.train import loop

    cls = torch.cuda.CUDAGraph
    before = (cls.capture_end, cls.replay, loop._ForwardGraph.__init__)
    ledger = chip_smoke._GraphLedger()
    with pytest.raises(RuntimeError, match="inside"):
        with ledger.watch():
            assert (cls.capture_end, cls.replay,
                    loop._ForwardGraph.__init__) != before
            raise RuntimeError("inside")
    assert (cls.capture_end, cls.replay, loop._ForwardGraph.__init__) == before


def _grads():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(64, 64, generator=g),
            "eps": torch.randn(4, generator=g) * 1e-3,
            "bn_bias": torch.zeros(8)}


@pytest.mark.parametrize("case,ok", [
    ("equal", True),
    ("w_off_by_5e-3", True),     # within 1e-2 of its own norm
    ("w_off_by_5e-2", False),
    ("small_doubled", False),    # a gradient far under the largest
    ("zero_noise_1e-6", True),   # the reference's is zero: rounding noise
    ("zero_noise_1e-3", False),
])
def test_hold_grads_holds_each_gradient_to_its_own_norm(case, ok):
    """Each gradient within `rel` of its own norm, however small next to
    the largest; only a reference gradient that is zero to rounding is
    exempt, and its counterpart must stay under `NOISE_GRAD` of the
    largest norm."""
    want = _grads()
    got = {k: v.clone() for k, v in want.items()}
    top = float(want["w"].norm())
    if case.startswith("w_off_by_"):
        got["w"] *= 1 + float(case.rsplit("_", 1)[1])
    elif case == "small_doubled":
        got["eps"] *= 2
    elif case.startswith("zero_noise_"):
        got["bn_bias"][0] = float(case.rsplit("_", 1)[1]) * top
    if not ok:
        with pytest.raises(AssertionError):
            chip_smoke._hold_grads(case, got, want, rel=1e-2)
        return
    worst, n_zero, zero_max = chip_smoke._hold_grads(case, got, want,
                                                     rel=1e-2)
    assert worst <= 1e-2 and n_zero == 1 and zero_max < chip_smoke.NOISE_GRAD


# the phases that step a bench batch, by the twin's metric: [gps_bench]
# and [flat]'s GPS step, [gps_pep], the OGB and GINE+ bench steps and
# [zoo_registry]'s k123 batch
_PHASE_LINES = {"gps_bench": "zinc_gps_trainstep_edges_per_s_per_chip",
                "gps_pep": "pepstruct_gps_trainstep_edges_per_s_per_chip",
                "ogb_bench_step": "molhiv_ogbgnn_trainstep_edges_per_s_per_chip",
                "ginep_bench_step":
                    "molhiv_gineplus_trainstep_edges_per_s_per_chip",
                "zoo_registry_k123":
                    "qm9_k123gnn_trainstep_copyedges_per_s_per_chip"}


@pytest.mark.parametrize("phase", list(_PHASE_LINES))
def test_phase_batches_are_the_bench_twins(phase):
    """`bench_line`, which those phases read, gives the twin's table line
    (`escgnn_tpu_torch/bench.py`): its graphs' batch bit for bit, its
    spec, model config, loss and widths (at BENCH_SMOKE's counts)."""
    from escgnn_tpu_torch import bench

    metric = _PHASE_LINES[phase]
    got = chip_smoke.bench_line(metric, smoke=True)
    want = bench.bench_line(metric, bench.make_graph_sets(
        (metric,), smoke=True, num_workers=0), smoke=True)
    assert got.spec == want.spec and got.config == want.config
    assert got.loss_fn is want.loss_fn
    assert got.model_kwargs == want.model_kwargs
    assert got.real_edges == want.real_edges
    gb, wb = got.host_batch().tensors(), want.host_batch().tensors()
    assert set(gb) == set(wb)
    for k, v in wb.items():
        assert torch.equal(gb[k], v), k


def test_zoo_k123_batch_is_the_bench_twins():
    """`[zoo_registry]`'s k123 batch is the twin's k123 line at full
    size."""
    from escgnn_tpu_torch import bench

    data = chip_smoke._zoo_data()
    want = bench.bench_line(bench.K123, bench.make_graph_sets(
        (bench.K123,), num_workers=0))
    gb, wb = data["kset"].tensors(), want.host_batch().tensors()
    assert set(gb) == set(wb)
    for k, v in wb.items():
        assert torch.equal(gb[k], v), k


def test_bench_phase_names_every_line():
    """`[bench]` prints one `[bench_<line>]` per metric, and K1's nodes
    expected per captured step are the K1 calls `CostMode` counts in one
    eager step of the line (at BENCH_SMOKE counts on the CPU): every sum
    and the backward of every row gather and embedding lookup; none on
    PPGN_eff."""
    from escgnn_tpu_torch import bench
    from escgnn_tpu_torch.train.loop import adam_with_plateau
    from escgnn_tpu_torch.utils.cost import count_cost

    shorts = [chip_smoke._bench_short(m) for m in bench.METRICS]
    assert len(set(shorts)) == len(bench.METRICS)
    assert shorts[-1] == "flagship"
    gsets = bench.make_graph_sets(smoke=True, num_workers=0)
    for metric, short in zip(bench.METRICS, shorts):
        line = bench.bench_line(metric, gsets, smoke=True)
        model = line.model("cpu")
        cost, _ = count_cost(model, adam_with_plateau(model.parameters(),
                                                      bench.LR),
                             line.host_batch(), line.loss_fn)
        k1 = cost.by_op.get("sorted_segment_sum")
        assert chip_smoke.BENCH_K1_NODES.get(short, 0) == (
            k1.calls if k1 else 0), short
    assert "ppgn" not in chip_smoke.BENCH_K1_NODES


def test_k1_cases_hold_the_regimes_they_name():
    """`[k1]`'s cases on the CPU (the flagship view replaced by a small
    one): the gap case leaves an interior gap of 4960 unnamed rows, the
    short one sums 1024 positions into 928 rows, the masked one sorts
    20494 positions last under id R; K1's plain version equals the f64
    sum on each (positions outside [0, R) dropped) and every unnamed row
    is 0."""
    import types

    import determinism_probe as probe
    from escgnn_tpu_torch.ops import expand_cuda

    E, R = 64, 20
    rows = torch.sort(torch.randint(0, R, (E,))).values.to(torch.int32)
    batch = types.SimpleNamespace(
        enc_edge_perm=torch.randperm(E).to(torch.int32),
        enc_row_sorted=rows, enc_idx=torch.zeros(R, 4))
    gen = torch.Generator().manual_seed(0)
    cases = {c[0]: c[1:] for c in chip_smoke._k1_cases(batch, "cpu", gen)}
    stats = {k: probe.ids_stats(v[2], v[3]) for k, v in cases.items()}
    assert stats["gap_4960"]["largest_gap"] == 4960
    assert cases["short_1024"][0].shape == (1024, 64)
    assert cases["short_1024"][3] == 928
    assert stats["masked_k123"]["dropped"] == 20494
    assert stats["masked_k123"]["largest_gap"] >= 4960
    assert stats["masked_k123"]["longest_run"] >= 3000
    for name in ("gap_4960", "short_1024", "masked_k123"):
        dZ, perm, rows, R, exact = cases[name]
        assert exact
        got = expand_cuda.sorted_segment_sum(dZ, perm, rows, R)
        want = chip_smoke._f64_sum(dZ, perm, rows, R)
        # the plain version adds the 3000-term run one term at a time in
        # f32 (K1 on the card adds it in pieces: chip_smoke holds it at
        # atol 1e-4)
        torch.testing.assert_close(got, want.float(), rtol=1e-5, atol=1e-3)
        unnamed = chip_smoke._unnamed_rows(rows, R)
        assert not got[unnamed].any()


@pytest.mark.parametrize("card_gap,card_spread,ok", [
    (0.0, 0.0, True), (2.9e-3, 0.0, True), (3.2e-3, 0.0, False),
    (3.2e-3, 2.0e-3, False), (2.9e-3, 2.0e-3, True)])
def test_ppa_grads_held_to_twice_the_order_spread_plus_1e5(
        card_gap, card_spread, ok):
    """`[small_gps]`'s ppa_uniform rule: the card's largest gradient gap
    over the largest gradient may be at most twice the largest gap the
    reordered batches give on the CPU, plus 1e-5 (here 1.5e-3, the
    largest gradient 1); the card's own reordered spread (`card_spread`)
    is reported and does not widen the limit."""
    cpu = {"grad w": torch.tensor([1.0, -0.5]), "grad b": torch.zeros(2)}
    gpu = {"grad w": cpu["grad w"], "grad b": torch.tensor([card_gap, 0.0])}
    spreads = {"cpu": iter([1.0e-3, 1.5e-3, 0.5e-3]),
               "card": iter([0.0, card_spread, 0.0])}

    def run(cfg, kw, host, loss_fn, device):
        base = cpu if device == "cpu" else gpu
        d = next(spreads["cpu" if device == "cpu" else "card"])
        return {"grad w": base["grad w"] + torch.tensor([d, 0.0]),
                "grad b": base["grad b"]}

    args = ("ppa", None, {}, [None] * 3, None, run, cpu, gpu,
            ["grad w", "grad b"], 1.0, "card")
    if not ok:
        with pytest.raises(AssertionError, match="reordered spread"):
            chip_smoke._hold_grads_to_order_spread(*args)
        return
    res = chip_smoke._hold_grads_to_order_spread(*args)
    # the gaps are f32 differences: rel 1e-4
    assert res["ppa_grad_limit"] == pytest.approx(2 * 1.5e-3 + 1e-5,
                                                  rel=1e-4)
    assert res["ppa_cpu_reordered_gaps"] == pytest.approx(
        [1.0e-3, 1.5e-3, 0.5e-3], rel=1e-4)
    assert res["ppa_card_reordered_gaps"] == pytest.approx(
        [0.0, card_spread, 0.0], rel=1e-4, abs=1e-12)
    assert res["ppa_grad_gap_over_gmax"] == pytest.approx(card_gap)
