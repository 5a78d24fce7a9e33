"""The `gps_zinc.train` cell's benchmark files: its FLOP count
(`perfbench/costs/gps_zinc.py`) against `FlopCounterMode`'s count of one
eager GPS step at the batch's padded shapes, the analytic count's
additivity and attention term, and the metrics the cell resolves."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import cell, port, weights
from perfbench.costs import gps_zinc
from perfbench.gen import zinc_molecules

CELL = "gps_zinc.train"
FIELDS = dict(dim_h=16, num_layers=2, num_heads=4, out_dim=1,
              spd_vocab=102)


def _one_step(bs: int = 16):
    res = cell.resolve(CELL)
    cfg = res["config"]
    f = dict(cfg["model"]["fields"], **FIELDS)
    raw = zinc_molecules.generate(dict(num_graphs=3 * bs), 3)
    ys = [np.asarray([0.1 * i], np.float32) for i in range(len(raw))]
    graphs = port.featurize(raw, ys, cfg["esc"], 0)
    system = port.system(cfg["model"]["system"])
    spec = system.batch_spec(graphs, bs, cfg["layout"])
    stack = port.stack(graphs[:bs], spec, "cpu")
    model = system.build(f, spec, 1, "cpu")
    weights.load(model, weights.draw(model, 3, "cpu", system.draw_rule))
    opt = port.optimizer(model, cfg["optimizer"], capturable=False)
    step = port.pool_train_step(model, opt, port.loss_fn("l1_graph_loss"),
                                stack)
    with FlopCounterMode(display=False) as fc:
        step(stack, [0])
    return spec, f, fc.get_total_flops()


def test_launched_products_are_flop_counters():
    spec, f, counted = _one_step()
    G = spec.num_graphs
    sizes = dict(graphs=G, nodes=[spec.uniform_nodes] * G,
                 edges=[spec.uniform_edges] * G, nnz=[0] * G,
                 rows=spec.num_enc_rows, buckets=spec.num_enc_buckets,
                 n_u=spec.uniform_nodes, e_u=spec.uniform_edges,
                 m=spec.max_nodes_per_graph)
    assert gps_zinc.flops(sizes, f, launched=True) == counted


def test_analytic_count_is_additive_over_graphs():
    a = dict(graphs=1, nodes=[5], edges=[13], nnz=[40])
    b = dict(graphs=1, nodes=[7], edges=[19], nnz=[66])
    both = dict(graphs=2, nodes=[5, 7], edges=[13, 19], nnz=[40, 66])
    assert gps_zinc.flops(both, FIELDS) == pytest.approx(
        gps_zinc.flops(a, FIELDS) + gps_zinc.flops(b, FIELDS))


def test_attention_counts_each_graphs_own_pairs():
    """Moving a node between two graphs of one batch changes the count by
    the pairs' term alone: logits and A.V with both gradients (3 x 2 n^2 D
    each) and the bias's one-hot rows (2 n^2 heads), per layer."""
    D, L, Hh = FIELDS["dim_h"], FIELDS["num_layers"], FIELDS["num_heads"]
    even = dict(graphs=2, nodes=[6, 6], edges=[20, 20], nnz=[50, 50])
    skew = dict(graphs=2, nodes=[5, 7], edges=[20, 20], nnz=[50, 50])
    pairs = (25 + 49) - (36 + 36)
    want = L * pairs * (2 * 3 * 2 * D + 2 * Hh)
    assert gps_zinc.flops(skew, FIELDS) - gps_zinc.flops(even, FIELDS) == \
        pytest.approx(want)


def test_cell_resolves_with_its_metrics():
    res = cell.resolve(CELL)
    names = {m["name"] for m in res["metrics"]}
    # the ZINC train cell's per-layer metrics read the GPS step as they
    # read NestedGIN's; the SPD featurizer's metric is the cell's own
    assert names == {
        "train_edges_per_s", "setup_s", "featurize_s", "pool_build_s",
        "host_ms_per_step.train", "step_ms_p95.train",
        "kernel_nodes_per_step.train", "mfu.train", "k1_roofline",
        "device_idle_frac.train", "pool_load_ms_per_step.train",
        "pool_run_ms_per_step.train", "batch_copies_per_step.train",
        "pool_pad_s", "pool_upload_s", "featurize_graphs_per_s",
        "pool_sizing_s", "spd_graphs_per_s"}
    assert res["cell"]["chips"] == 1
    cfg = res["config"]
    assert cfg["reduced"] == [] and cfg["tf32"] is False
    f = cfg["model"]["fields"]
    assert (f["dim_h"], f["num_layers"], f["num_heads"]) == (64, 10, 4)
    assert f["use_esc"] and f["use_attn_bias"]
    assert res["traffic"]["batch_size"] == 128
