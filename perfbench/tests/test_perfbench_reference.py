"""The plain reference against the system on the CPU at a small width: its
ESC encoding is the system's bit for bit, each cell's run comes out
`correct`, and the same run with the timed path broken underneath comes
out not correct, once for each fault a training cell can have on one
card."""

import numpy as np
import pytest
import torch

from perfbench.gen import counting_graphs, zinc_molecules
from perfbench.reference import esc
from perfbench.tests.conftest import run_tiny, tiny

TRAIN_CELLS = ["zinc_nestedgin_eff.train", "count_ppgn_eff.train"]


@pytest.mark.parametrize("graphs", [
    zinc_molecules.generate(dict(num_graphs=30), 4),
    counting_graphs.generate(dict(num_graphs=30, n_min=10, n_max=24,
                                  avg_degree=3.0), 4),
], ids=["zinc", "counting"])
def test_reference_encoding_is_the_systems(graphs):
    from escgnn_tpu_torch.data.container import GraphData
    from escgnn_tpu_torch.featurize.escgnn import EscConfig
    from escgnn_tpu_torch.featurize.transform import featurize_many

    sys_graphs = featurize_many(
        [GraphData(num_nodes=g.num_nodes, edge_index=g.edge_index, x=g.x)
         for g in graphs], EscConfig(h=3, use_rd=True, self_loop=True))
    for g, s in zip(graphs, sys_graphs):
        edges, rows = esc.encode(g.num_nodes, g.edge_index, 3)
        assert np.array_equal(edges, s.edge_index)
        dense = np.zeros_like(rows)
        for e in range(rows.shape[0]):
            a, b = s.enc_offsets[e], s.enc_offsets[e + 1]
            dense[e, s.enc_idx[a:b]] = s.enc_cnt[a:b]
        assert np.array_equal(dense, rows)


@pytest.mark.parametrize("workload", TRAIN_CELLS
                         + ["zinc_nestedgin_eff.epoch"])
def test_sound_run_is_correct(workload):
    out = run_tiny(tiny(workload))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def _unchanged_state(monkeypatch):
    from escgnn_tpu_torch.train import loop

    monkeypatch.setattr(loop.ClippedAdam, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """The loss over the first half of the batch's graphs only."""
    from escgnn_tpu_torch.train import loop

    def halve(fn, node_level):
        def loss(out, batch):
            G = batch.graph_mask.shape[0]
            keep = torch.arange(G) < G // 2
            if node_level:
                mask = batch.node_mask & keep[batch.node_graph.long()]
                return fn(out, batch.with_tensors({"node_mask": mask}))
            return fn(out, batch.with_tensors(
                {"graph_mask": batch.graph_mask & keep}))
        return loss

    monkeypatch.setattr(loop, "l1_graph_loss",
                        halve(loop.l1_graph_loss, False))
    monkeypatch.setattr(loop, "l1_node_loss", halve(loop.l1_node_loss, True))


def _altered_answer(monkeypatch):
    """The model's first output row moved by 1 where it is produced."""
    from escgnn_tpu_torch.models import nested_gin_eff, ppgn

    for cls in (nested_gin_eff.NestedGINEff, ppgn.PPGN):
        fwd = cls.forward

        def forward(self, batch, fwd=fwd):
            out = fwd(self, batch)
            return torch.cat([out[:1] + 1.0, out[1:]])

        monkeypatch.setattr(cls, "forward", forward)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_answer],
                         ids=["unchanged_state", "half_batch",
                              "altered_answer"])
@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = run_tiny(tiny(workload))
    assert not out["correct"], out["checks"]
