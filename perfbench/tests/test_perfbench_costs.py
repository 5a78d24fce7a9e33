"""Each configuration's FLOP count (`perfbench/costs/<config>.py`) against
`torch.utils.flop_counter.FlopCounterMode`'s count of the matrix products
of one eager train step of the system, both at the batch's padded
shapes; and the analytic count's hand-checked terms."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import cell, port, weights
from perfbench.costs import count_ppgn_eff, zinc_nestedgin_eff
from perfbench.tests.conftest import tiny


def _one_step(workload):
    res = tiny(workload, graphs=48, batch=16)
    run = cell.Run(res, 3, 0.0, False, torch.device("cpu"), 0.0, 1)
    cfg, trf = run.cfg, run.trf
    raw = cell.split(__import__(
        f"perfbench.gen.{trf['generator']}",
        fromlist=["generate"]).generate(trf["data"], 3), trf["split"])
    ys = cell.normalized_targets(raw, cfg["task"])
    graphs = [g for s in raw for g in port.featurize(raw[s], ys[s],
                                                     cfg["esc"], 0)]
    m = cfg["model"]
    system = port.system(m["system"])
    spec = system.batch_spec(graphs, trf["batch_size"], cfg["layout"])
    stack = port.stack(graphs[:trf["batch_size"]], spec, "cpu")
    model = system.build(m["fields"], spec,
                         int(np.asarray(raw["train"][0].x).shape[1]), "cpu")
    weights.load(model, weights.draw(model, 3, "cpu", system.draw_rule))
    opt = port.optimizer(model, cfg["optimizer"], capturable=False)
    step = port.pool_train_step(model, opt, port.loss_fn(cfg["task"]["loss"]),
                                stack)
    with FlopCounterMode(display=False) as fc:
        step(stack, [0])
    return spec, m["fields"], fc.get_total_flops()


def test_zinc_nestedgin_eff_launched_products():
    spec, f, counted = _one_step("zinc_nestedgin_eff.train")
    G = spec.num_graphs
    sizes = dict(graphs=G, nodes=[spec.uniform_nodes] * G,
                 edges=[spec.uniform_edges] * G, nnz=[0] * G,
                 rows=spec.num_enc_rows, buckets=spec.num_enc_buckets,
                 n_u=spec.uniform_nodes, e_u=spec.uniform_edges)
    assert zinc_nestedgin_eff.flops(sizes, f, launched=True) == counted


def test_count_ppgn_eff_launched_products():
    spec, f, counted = _one_step("count_ppgn_eff.train")
    G = spec.num_graphs
    grid = max(spec.max_nodes_per_graph, spec.uniform_nodes)
    sizes = dict(graphs=G, nodes=[grid] * G, edges=[spec.uniform_edges] * G,
                 nnz=[0] * G, rows=spec.num_enc_rows,
                 buckets=spec.num_enc_buckets, grid=grid)
    assert count_ppgn_eff.flops(sizes, f, launched=True) == counted


@pytest.mark.parametrize("cost,fields", [
    (zinc_nestedgin_eff, dict(hidden=4, num_layers=1, node_embed_dim=2,
                              edge_embed_dim=2, out_dim=1)),
    (count_ppgn_eff, dict(emb_dim=4, num_rb_layers=1, out_dim=1)),
])
def test_analytic_count_is_additive_over_graphs(cost, fields):
    a = dict(graphs=1, nodes=[5], edges=[13], nnz=[40])
    b = dict(graphs=1, nodes=[7], edges=[19], nnz=[66])
    both = dict(graphs=2, nodes=[5, 7], edges=[13, 19], nnz=[40, 66])
    assert cost.flops(both, fields) == pytest.approx(
        cost.flops(a, fields) + cost.flops(b, fields))


def test_ppgn_block_product_counts_n_cubed():
    f = dict(emb_dim=4, num_rb_layers=1, out_dim=1)
    one = dict(graphs=1, nodes=[3], edges=[0], nnz=[0])
    two = dict(graphs=1, nodes=[4], edges=[0], nnz=[0])
    C, d = 4, 6
    per_cell = 2 * (6 * d * C + 6 * C * C) + 6 * (d + C) * C
    per_node = 6 * 2 * C * C + 6 * C
    expect = (lambda n: per_cell * n * n + 6 * n ** 3 * C + per_node * n)
    assert count_ppgn_eff.flops(two, f) - count_ppgn_eff.flops(one, f) == \
        expect(4) - expect(3)
