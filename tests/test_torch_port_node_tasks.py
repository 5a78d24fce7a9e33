"""The node-classification task of the port's `run_gps` against the JAX
package on the CPU: the SBM (PATTERN, CLUSTER) and heterophilous
(WebKB, Actor, WikipediaNetwork) data, bit-equal from the generators and
from raw files written into tmp_path; `node_split_copies`; the macro-F1
against sklearn's to 1e-12; the node-logits pass, which drops padding
rows and nodes outside the split (y < 0) from a pool of one graph; and a
single-graph run (Actor on a 60-node stand-in) against the JAX driver's
epoch lines.
"""

import math
import os

import numpy as np
import pytest
import torch
from sklearn.metrics import f1_score

from escgnn_tpu.data import hetero as j_hetero
from escgnn_tpu.data import planetoid as j_planetoid
from escgnn_tpu.data import sbm as j_sbm
from escgnn_tpu_torch import run_gps
from escgnn_tpu_torch.config import load_cfg
from escgnn_tpu_torch.data import hetero, planetoid, sbm
from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.prefetch import pool_size, stack_split
from escgnn_tpu_torch.train.loop import make_pool_logits_step
from escgnn_tpu_torch.train.metrics import macro_f1
from tests.test_torch_port_driver_parity import REPO
from tests.test_torch_port_gps_driver import _carry, _close, run_jax_gps
from tests.test_torch_port_qm9 import _assert_graphs_equal


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["pattern", "cluster"])
def test_sbm_bit_equal(name):
    gen = {"pattern": "synthetic_pattern", "cluster": "synthetic_cluster"}
    _assert_graphs_equal(getattr(sbm, gen[name])(4, 3),
                         getattr(j_sbm, gen[name])(4, 3))
    got, want = sbm.sbm_splits(name, 10, 1), j_sbm.sbm_splits(name, 10, 1)
    assert set(got) == set(want)
    for k in want:
        _assert_graphs_equal(got[k], want[k])


def _write_hetero_raw(root):
    """WebKB's dense 0/1 rows (texas), Actor's and chameleon's sparse
    index lists; directed edges with a self-loop and a duplicate."""
    rows = {"texas": "0\t1,0,1\t0\n1\t0,1,0\t1\n2\t1,1,1\t0\n3\t0,0,1\t2\n",
            "actor": "0\t0,5,931\t2\n1\t3\t1\n2\t7,8\t0\n",
            "chameleon": "0\t2,2324\t4\n1\t11\t1\n2\t0,3\t0\n"}
    for name, body in rows.items():
        raw = os.path.join(root, name, "raw")
        os.makedirs(raw)
        with open(os.path.join(raw, "out1_node_feature_label.txt"),
                  "w") as f:
            f.write("node_id\tfeature\tlabel\n" + body)
        with open(os.path.join(raw, "out1_graph_edges.txt"), "w") as f:
            f.write("src\tdst\n0\t1\n1\t2\n1\t1\n2\t1\n2\t0\n")


def test_hetero_bit_equal(tmp_path):
    """The raw geom-gcn format (dense and sparse feature rows) through
    get_hetero_graph (real), a missing name through the synthetic
    fallback, every name's synthetic graph; an unknown name refused
    (JAX asserts, the port raises ValueError)."""
    _write_hetero_raw(str(tmp_path))
    for name in ("texas", "actor", "chameleon", "cornell"):
        (g, real) = hetero.get_hetero_graph(name, root=str(tmp_path))
        (jg, jreal) = j_hetero.get_hetero_graph(name, root=str(tmp_path))
        assert real == jreal == (name != "cornell")
        _assert_graphs_equal([g], [jg])
    assert hetero.get_hetero_graph("actor", str(tmp_path))[0].x.shape == (
        3, hetero.ACTOR_FEAT_DIM)
    for name in hetero.WEBKB_NAMES + ("actor",) + hetero.WIKI_NAMES:
        _assert_graphs_equal([hetero.synthetic_hetero(name, num_nodes=50)],
                             [j_hetero.synthetic_hetero(name, num_nodes=50)])
    with pytest.raises(ValueError, match="heterophilous graph"):
        hetero.get_hetero_graph("Texas", root=str(tmp_path))


@pytest.mark.parametrize("seed", [0, 3])
def test_node_split_copies_bit_equal(seed):
    """Three copies of one graph, labels -1 outside each split
    (stratified per class), on a heterophilous and a citation graph."""
    for g, jg in ((hetero.synthetic_hetero("actor", num_nodes=70),
                   j_hetero.synthetic_hetero("actor", num_nodes=70)),
                  (planetoid.synthetic_planetoid("Cora", num_nodes=90),
                   j_planetoid.synthetic_planetoid("Cora", num_nodes=90))):
        got = hetero.node_split_copies(g, seed=seed)
        want = j_hetero.node_split_copies(jg, seed=seed)
        assert set(got) == set(want) == {"train", "val", "test"}
        for k in want:
            _assert_graphs_equal(got[k], want[k])
        owners = np.stack([np.asarray(got[k][0].y).reshape(-1) >= 0
                           for k in ("train", "val", "test")])
        assert (owners.sum(0) == 1).all()


@pytest.mark.parametrize("seed", range(6))
def test_macro_f1_equals_sklearn(seed):
    """sklearn's rules: the classes are the union of the true and the
    predicted labels, a class with no true or no predicted member scores
    0 and counts in the mean (cases with classes absent from either
    side, negative and sparse labels, one sample)."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(1, 60))
        C = int(rng.integers(1, 9))
        true = rng.integers(0, C, n)
        pred = rng.integers(0, C + 2, n) - (seed % 2)
        if seed >= 4:
            true, pred = true * 7, pred * 5  # sparse label ids
        want = f1_score(true, pred, average="macro", zero_division=0)
        assert abs(macro_f1(true, pred) - want) < 1e-12
    with pytest.raises(ValueError):
        macro_f1(np.zeros(0, int), np.zeros(0, int))


def test_node_logits_pass_drops_padding_and_unlabeled_rows():
    """A one-graph split stacks to a pool of one; the node-level logits
    pass returns the node mask, and the split's macro-F1 counts only the
    real nodes with y >= 0 (checked against sklearn on those rows)."""
    g = hetero.synthetic_hetero("actor", num_nodes=40)
    splits = hetero.node_split_copies(g, seed=1)
    spec = BatchSpec.from_graphs([s[0] for s in splits.values()], 4)
    stacked = stack_split(splits["val"], spec, "cpu")
    assert pool_size(stacked) == 1
    assert int(stacked.node_mask.sum()) == 40 < stacked.node_mask.shape[1]

    class Fixed(torch.nn.Module):
        def forward(self, batch):
            gen = torch.Generator().manual_seed(0)
            return torch.randn(batch.num_nodes, 5, generator=gen)

    model = Fixed()
    logits, y, mask = make_pool_logits_step(model, node_level=True)(stacked)
    assert logits.shape == (1, spec.num_nodes, 5)
    assert torch.equal(mask, stacked.node_mask)
    keep = mask.reshape(-1).numpy() & (y.reshape(-1).numpy() >= 0)
    assert 0 < keep.sum() < 40
    cfg = load_cfg(os.path.join(REPO, "configs", "gps", "actor-GPS.yaml"))
    got = run_gps._class_metric(cfg, make_pool_logits_step(
        model, node_level=True), stacked)
    want = f1_score(y.reshape(-1).numpy()[keep].astype(np.int64),
                    logits.reshape(-1, 5).numpy()[keep].argmax(-1),
                    average="macro", zero_division=0)
    assert abs(got - want) < 1e-12


def test_single_graph_run_tracks_the_jax_driver(monkeypatch, tmp_path):
    """actor-GPS.yaml (batch 1, the graph's three split copies) on a
    60-node heterophilous stand-in in both packages, 16 x 2, dropout 0,
    lr 1e-4, 3 epochs from JAX's init: per-epoch loss and val macro-F1 at rel
    1e-4, the best epoch and test F1 as JAX's."""

    def tiny_graph(mod):
        def get(name, root="data/hetero"):
            return mod.synthetic_hetero(name, num_nodes=60), False

        return get

    monkeypatch.setattr(j_hetero, "get_hetero_graph", tiny_graph(j_hetero))
    monkeypatch.setattr(hetero, "get_hetero_graph", tiny_graph(hetero))
    path = os.path.join(REPO, "configs", "gps", "actor-GPS.yaml")
    opts = ["model.dim_h", "16", "model.num_layers", "2", "model.num_heads",
            "2", "model.dropout", "0", "train.epochs", "3",
            "optim.base_lr", "1e-4"]
    run = run_jax_gps(tmp_path / "jax", path, opts)
    _carry(monkeypatch, run["variables"])
    cfg = load_cfg(path, opts + ["dataset.dir", str(tmp_path / "data")])
    res = run_gps.run_one(cfg, 0, str(tmp_path / "res"), "cpu")
    got = [(e["loss"], e["val"]) for e in res["epochs"]]
    assert len(run["lines"]) == len(got) == 3
    for (jl, jv), (tl, tv) in zip(run["lines"], got):
        assert _close(tl, jl) and _close(tv, jv), (got, run["lines"])
    assert res["best_epoch"] == run["res"]["best_epoch"]
    assert _close(res["best_test_f1"], run["res"]["best_test_f1"])
    assert math.isfinite(res["best_val_f1"])
