"""GraphGPS on ZINC as the benchmark runs it
(`perfbench/configs/gps_zinc.json`: GINE + Transformer layers, ESC edges,
the SPD bias, add pool) in the port
against the benchmark's plain reference (`perfbench/reference/gps.py`),
on the CPU at dim_h 16, 2 layers, 4 heads: each graph's SPD grid bit for
bit, one step's loss and every leaf's gradient, the weights after three
Adam steps, and the `gps_zinc.train` cell cut to this size through
`perfbench.cell.run`, sound and under each planted fault."""

import copy

import numpy as np
import pytest
import torch

from escgnn_tpu_torch.data.prefetch import pool_entry
from escgnn_tpu_torch.models import gps
from escgnn_tpu_torch.train import loop
from perfbench import cell, checks, port, weights
from perfbench.gen import zinc_molecules
from perfbench.reference import batch as rbatch
from perfbench.reference import gps as rgps
from perfbench.reference import train as rtrain
from perfbench.reference.nn import Norms
from perfbench.systems import GPSModel as adapter
from perfbench.tests.conftest import run_tiny, tiny

CELL = "gps_zinc.train"
BS, LR = 8, 1e-3


def _fields() -> dict:
    f = dict(cell.resolve(CELL)["config"]["model"]["fields"])
    f.update(dim_h=16, num_layers=2, num_heads=4)
    return f


@pytest.fixture(scope="module")
def data():
    """24 seeded molecules with standardized targets: the port's featurized
    graphs (SPD grids attached), their spec and stack of 3 batches, and the
    reference's batches of the same graphs in the same order."""
    raw = zinc_molecules.generate(dict(num_graphs=3 * BS), 7)
    y = np.asarray([float(g.y[0]) for g in raw])
    ys = [np.asarray([(v - y.mean()) / y.std(ddof=1)], np.float32)
          for v in y]
    esc_cfg = cell.resolve(CELL)["config"]["esc"]
    graphs = port.featurize(raw, ys, esc_cfg, 0)
    spec = adapter.batch_spec(graphs, BS, "uniform_dedup")
    stack = port.stack(graphs, spec, "cpu")
    enc = rbatch.encode_all(raw, esc_cfg["h"], 1)
    batches = [rbatch.make_batch(raw[i:i + BS], enc[i:i + BS],
                                 ys[i:i + BS], "cpu")
               for i in range(0, len(raw), BS)]
    return dict(raw=raw, graphs=graphs, spec=spec, stack=stack,
                batches=batches)


def _model(data, seed: int = 3):
    fields = _fields()
    model = adapter.build(fields, data["spec"], 1, "cpu")
    w0 = weights.draw(model, seed, "cpu", adapter.draw_rule)
    weights.load(model, w0)
    return model, w0, fields


@pytest.mark.parametrize("batch", [0, 1, 2])
def test_reference_spd_is_the_ports_grid(data, batch):
    """The reference's own BFS over the batch's edge list gives each
    graph's `attach_attn_bias` grid bit for bit (no pair is unconnected in
    a molecule, and none lies over 100 hops apart)."""
    b = data["batches"][batch]
    groups = rgps.size_groups(b)
    got = {}
    for ids, grid in groups:
        for row, g in zip(ids.tolist(), grid.numpy()):
            got[row[0]] = g
    start = np.concatenate([[0], np.cumsum(b.nodes_per_graph.numpy())])
    for i in range(b.num_graphs):
        want = data["graphs"][batch * BS + i].extras["attn_bias"]
        assert want.dtype == np.int16
        assert np.array_equal(got[int(start[i])].astype(np.int16), want)


def test_reference_spd_caps_far_and_unconnected_pairs():
    """A path of 103 nodes and an isolated node: 101 beyond 100 hops and
    between unconnected nodes, as the port gives for a graph over 100
    nodes."""
    n = 104
    src = np.concatenate([np.arange(102), np.arange(1, 103)])
    dst = np.concatenate([np.arange(1, 103), np.arange(102)])
    d = rgps.spd(n, src, dst)
    assert d[0, 100] == 100 and d[0, 101] == 101 and d[0, 102] == 101
    assert d[103, 103] == 0 and d[103, 0] == d[0, 103] == 101
    from escgnn_tpu_torch.featurize.bfs import hop_distance_matrix

    ei = np.stack([src, dst])
    port_d = np.minimum(hop_distance_matrix(n, ei, 100), 101)
    assert np.array_equal(port_d, d)


@pytest.fixture(scope="module")
def one_step(data):
    """One train-mode forward and backward of batch 0 in the port and in
    the reference from the same drawn weights."""
    model, w0, fields = _model(data)
    model.train()
    b = pool_entry(data["stack"], 0)
    out = model(b)
    loss = loop.l1_graph_loss(out, b)
    loss.backward()
    sys_g = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    p = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    rb = data["batches"][0]
    r_out = rgps.forward(p, rb, fields, Norms())
    r_loss = rgps.loss(r_out, rb)
    ref_g = dict(zip(p, torch.autograd.grad(r_loss, list(p.values()))))
    return dict(out=out.detach(), loss=float(loss.detach()),
                r_out=r_out.detach(), r_loss=float(r_loss.detach()),
                sys_g=sys_g, ref_g=ref_g)


def test_one_step_loss_and_outputs(one_step):
    """f32 on both sides, sums in different orders: a few ulps per graph
    output, 1e-6 relative on the loss (its mean of 8 terms)."""
    s = one_step
    assert s["r_out"].shape == s["out"].shape == (BS, 1)
    torch.testing.assert_close(s["out"], s["r_out"], rtol=1e-5, atol=1e-5)
    assert abs(s["loss"] - s["r_loss"]) <= 1e-6 * abs(s["r_loss"])


def test_one_step_every_gradient(one_step):
    """Each leaf's gradient within 3e-5 of the larger of its own norm and
    the median leaf's: BatchNorm's backward subtracts nearly equal sums, so
    a leaf ahead of a BN (a Dense bias there, `k`'s bias under softmax)
    holds rounding alone, and is held to the median leaf's scale (read:
    2.5e-6 at worst)."""
    sys_g, ref_g = one_step["sys_g"], one_step["ref_g"]
    assert set(sys_g) == set(ref_g)
    norms = {k: float(v.norm()) for k, v in ref_g.items()}
    med = float(np.median(list(norms.values())))
    for k in ref_g:
        gap = float((sys_g[k] - ref_g[k]).norm())
        assert gap <= 3e-5 * max(norms[k], med), (k, gap, norms[k], med)


def test_three_adam_steps(data):
    """Losses of three eager pool steps within 1e-5 relative (the state
    drifts by rounding from step 2 on); each leaf's change within 2e-4 of
    the reference's change where its first gradient is at least a
    thousandth of the median leaf's (`checks.moved_leaves`); the others
    have gradients of rounding alone, which Adam turns into steps of up to
    about lr per entry in either direction, so the two changes differ by at
    most 2 x 3 lr per entry."""
    model, w0, fields = _model(data)
    opt = port.optimizer(model, dict(lr=LR, grad_clip=0.0),
                         capturable=False)
    step = port.pool_train_step(model, opt, port.loss_fn("l1_graph_loss"),
                                data["stack"])
    losses = step(data["stack"], [0, 1, 2]).tolist()
    ref = rtrain.train(rgps, fields, w0, data["batches"], LR, 0.0)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    moved = checks.moved_leaves(
        {k: float(v.norm()) for k, v in ref["grad1"].items()})
    got = dict(model.named_parameters())
    assert len(moved) > len(got) // 2
    for k, w in got.items():
        d_sys = w.detach() - w0[k]
        d_ref = ref["weights"][k] - w0[k]
        if k in moved:
            gap = float((d_sys - d_ref).norm())
            assert gap <= 2e-4 * float(d_ref.norm()), (k, gap)
        else:
            assert float((d_sys - d_ref).abs().max()) <= 6 * LR, k


def _tiny_cell():
    """The cell at 60 graphs: a train split of 48, three full batches of
    16, so that each checked step sees a whole batch."""
    res = tiny(CELL, graphs=60, batch=16)
    res["config"]["model"]["fields"].update(dim_h=16, num_layers=2,
                                            num_heads=4)
    return res


def test_cut_cell_is_correct():
    out = run_tiny(_tiny_cell())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(loop.ClippedAdam, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """The loss over the first half of the batch's graphs only."""
    fn = loop.l1_graph_loss

    def loss(out, batch):
        G = batch.graph_mask.shape[0]
        keep = torch.arange(G) < G // 2
        return fn(out, batch.with_tensors(
            {"graph_mask": batch.graph_mask & keep}))

    monkeypatch.setattr(loop, "l1_graph_loss", loss)


def _altered_answer(monkeypatch):
    """The model's first output row moved by 1 where it is produced."""
    fwd = gps.GPSModel._forward

    def forward(self, batch):
        out = fwd(self, batch)
        return torch.cat([out[:1] + 1.0, out[1:]])

    monkeypatch.setattr(gps.GPSModel, "_forward", forward)


def _no_spd_bias(monkeypatch):
    """Attention without the SPD bias (the table still in the model)."""
    monkeypatch.setattr(gps.SpdBias, "forward",
                        lambda self, ids: self.weight.new_zeros(
                            ids.shape + (self.weight.shape[1],)))


def _no_key_mask(monkeypatch):
    """Every key cell attendable: attention reads the grid's padding."""
    monkeypatch.setattr(gps.DenseGrid, "mask",
                        lambda self: torch.ones(self.G, self.M,
                                                dtype=torch.bool))


@pytest.mark.parametrize("fault", [_half_batch, _altered_answer,
                                   _unchanged_state, _no_spd_bias,
                                   _no_key_mask],
                         ids=["half_batch", "altered_answer",
                              "unchanged_state", "no_spd_bias",
                              "no_key_mask"])
def test_cut_cell_is_not_correct_under_a_fault(fault, monkeypatch):
    fault(monkeypatch)
    out = run_tiny(copy.deepcopy(_tiny_cell()))
    assert not out["correct"], out["checks"]
