"""The graph-level GPS datasets of the port (peptides, superpixels,
MalNet, ogbg-code2) against the JAX package on the CPU: the generators
and splits at small sizes and every pickle reader on files written into
tmp_path are bit-equal; the batcher carries per-node classes (VOC, COCO,
PATTERN) and code2's token ids with JAX's fields, dtypes and padding;
`subtoken_f1` equals JAX's; and both packages' `run_gps.build_dataset`
read one another's feature caches (one cache key per dataset name).
"""

import os
import pickle

import numpy as np
import pytest

import escgnn_tpu.config as jconfig
from escgnn_tpu.data import code2 as j_code2
from escgnn_tpu.data import malnet as j_malnet
from escgnn_tpu.data import peptides as j_peptides
from escgnn_tpu.data import sbm as j_sbm
from escgnn_tpu.data import superpixels as j_superpixels
from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu_torch import run_gps
from escgnn_tpu_torch.config import load_cfg
from escgnn_tpu_torch.data import code2, malnet, peptides, sbm, superpixels
from escgnn_tpu_torch.data.batching import BatchSpec, batch_arrays
from tests.test_torch_port_driver_parity import REPO, load_jax_driver
from tests.test_torch_port_qm9 import _assert_graphs_equal, _jax_arrays

GENERATORS = [
    (peptides.synthetic_peptides, j_peptides.synthetic_peptides,
     dict(task="func", num_graphs=5, seed=1)),
    (peptides.synthetic_peptides, j_peptides.synthetic_peptides,
     dict(task="struct", num_graphs=5, seed=2)),
    (superpixels.synthetic_superpixels, j_superpixels.synthetic_superpixels,
     dict(name="MNIST", num_graphs=4, seed=3)),
    (superpixels.synthetic_superpixels, j_superpixels.synthetic_superpixels,
     dict(name="cifar10", num_graphs=4, seed=4)),
    (superpixels.synthetic_voc_coco, j_superpixels.synthetic_voc_coco,
     dict(name="vocsuperpixels", num_graphs=3, seed=5)),
    (superpixels.synthetic_voc_coco, j_superpixels.synthetic_voc_coco,
     dict(name="cocosuperpixels", num_graphs=3, seed=6)),
    (malnet.synthetic_malnet, j_malnet.synthetic_malnet,
     dict(num_graphs=6, seed=7)),
    (code2.synthetic_code2, j_code2.synthetic_code2,
     dict(num_graphs=6, seed=8)),
]


@pytest.mark.parametrize("case", GENERATORS, ids=[
    "peptides-func", "peptides-struct", "mnist", "cifar10", "voc", "coco",
    "malnet", "code2"])
def test_generators_bit_equal(case):
    port, jax_fn, kw = case
    _assert_graphs_equal(port(**kw), jax_fn(**kw))


def _split_cases(d):
    """(port splits, JAX splits) of every split function, synthetic unless
    `d` holds the dataset's pickle."""
    return [
        (peptides.peptide_splits(d, "func", 20, 1),
         j_peptides.peptide_splits(d, "func", 20, 1)),
        (peptides.peptide_splits(d, "struct", 20, 2),
         j_peptides.peptide_splits(d, "struct", 20, 2)),
        (superpixels.superpixel_splits(d, "mnist", 23, 3),
         j_superpixels.superpixel_splits(d, "mnist", 23, 3)),
        (superpixels.voc_coco_splits(d, "vocsuperpixels", 10, 4),
         j_superpixels.voc_coco_splits(d, "vocsuperpixels", 10, 4)),
        (malnet.malnet_splits(d, 20, 5), j_malnet.malnet_splits(d, 20, 5)),
        (code2.code2_splits(d, 20, 6), j_code2.code2_splits(d, 20, 6)),
    ]


def _assert_splits_equal(cases, real):
    for (got, is_real), (want, j_real) in cases:
        assert is_real == j_real
        assert set(got) == set(want)
        for split in want:
            _assert_graphs_equal(got[split], want[split])
    assert [c[0][1] for c in cases] == real


def test_synthetic_splits_bit_equal(tmp_path):
    """Each split function without its files: the synthetic generator's
    80/10/10 split (MNIST's stratified interleave included)."""
    _assert_splits_equal(_split_cases(str(tmp_path)), [False] * 6)


def _write_pickles(root):
    """Tiny artifacts of each pickle format: 1-d and 2-d x / edge_attr,
    int and float labels, MalNet's bare edge lists."""
    rng = np.random.default_rng(9)

    def rec(n, e, x_dim, y, ea=True):
        d = {"x": (rng.integers(0, 9, n) if x_dim == 0
                   else rng.normal(size=(n, x_dim))),
             "edge_index": rng.integers(0, n, (2, e)), "y": y}
        if ea:
            d["edge_attr"] = (rng.integers(0, 3, e) if x_dim == 0
                              else rng.normal(size=(e, 2)))
        return d

    def dump(rel, obj):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(obj, f)

    for task, width in (("func", 10), ("struct", 11)):
        dump(f"peptides/peptides-{task}.pkl", {s: [
            rec(7, 12, 0, rng.random(width)), rec(5, 8, 0, rng.random(
                (1, width)))] for s in ("train", "val", "test")})
    dump("superpixels/MNIST.pkl", {s: [
        rec(6, 10, 3, np.asarray([4])), rec(4, 6, 3, 7, ea=False)]
        for s in ("train", "val", "test")})
    dump("superpixels/VOCSUPERPIXELS.pkl", {s: [
        rec(6, 10, 12, rng.integers(0, 21, 6))]
        for s in ("train", "val", "test")})
    dump("malnet/malnet-tiny.pkl", {s: [
        {"edge_index": rng.integers(0, 9, (2, 14)), "num_nodes": 9,
         "y": np.asarray([3, 1])}] for s in ("train", "val", "test")})


def test_pickle_readers_bit_equal(tmp_path):
    """The peptides, superpixel (MNIST and VOC) and MalNet readers on
    pickles written here, through the split functions (real=True); code2
    has no reader."""
    _write_pickles(str(tmp_path))
    _assert_splits_equal(_split_cases(str(tmp_path)),
                         [True] * 5 + [False])


@pytest.mark.parametrize("name", ["voc", "coco", "pattern", "code2"])
def test_batcher_carries_node_classes_and_tokens(name):
    """VOC/COCO (y (n, 1) float per node, 21/81 classes), PATTERN (y (n,
    1) int64 per node) and code2 (graph-level y (MAX_SEQ_LEN,) float
    token ids padded with EOS): every field of a full and a short batch
    equals the JAX batcher's, dtype included."""
    if name in ("voc", "coco"):
        kw = dict(name=name, num_graphs=5, seed=1)
        tg = superpixels.synthetic_voc_coco(**kw)
        jg = j_superpixels.synthetic_voc_coco(**kw)
    elif name == "pattern":
        tg, jg = sbm.synthetic_pattern(5, 2), j_sbm.synthetic_pattern(5, 2)
    else:
        tg, jg = code2.synthetic_code2(5, 3), j_code2.synthetic_code2(5, 3)
    spec, jspec = BatchSpec.from_graphs(tg, 3), JBatchSpec.from_graphs(jg, 3)
    assert spec.y_is_node_level == jspec.y_is_node_level == (name != "code2")
    for lo, hi in ((0, 3), (3, 5)):
        got = batch_arrays(tg[lo:hi], spec)
        want = _jax_arrays(j_pad_and_batch(jg[lo:hi], jspec))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if name == "code2":
        assert got["y"].shape == (3, code2.MAX_SEQ_LEN)
        assert (got["y"][2:] == 0).all()  # the padding graph's row


def test_subtoken_f1_equals_jax():
    """Sub-token F1 on seeded random sequences (EOS anywhere, empty
    sequences on both sides, repeated tokens) equals JAX's exactly."""
    rng = np.random.default_rng(0)
    eos = code2.eos_id()
    assert eos == j_code2.eos_id() and code2.unk_id() == j_code2.unk_id()
    assert (code2.MAX_SEQ_LEN, code2.NUM_VOCAB) == (j_code2.MAX_SEQ_LEN,
                                                    j_code2.NUM_VOCAB)
    for _ in range(20):
        shape = (int(rng.integers(1, 12)), code2.MAX_SEQ_LEN)
        pred = rng.integers(0, 6, shape)
        true = rng.integers(0, 6, shape)
        pred[rng.random(shape) < 0.25] = eos
        true[rng.random(shape) < 0.25] = eos
        true[0] = eos
        assert code2.subtoken_f1(pred, true) == j_code2.subtoken_f1(
            pred, true)
    assert code2.subtoken_f1(np.zeros((0, 5)), np.zeros((0, 5))) == 0.0


CACHE_CASES = {
    "peptides-struct": ["dataset.num_graphs", "12"],
    "mnist": ["dataset.num_graphs", "12"],
    "malnet": ["dataset.num_graphs", "10"],
    "code2": ["dataset.num_graphs", "10"],
    "imdb": [],
    "pattern": ["dataset.num_graphs", "10"],
}


@pytest.mark.parametrize("name", sorted(CACHE_CASES))
def test_feature_cache_is_shared_with_jax(tmp_path, name):
    """The port's build_dataset writes the feature cache of each split
    under JAX's key; JAX's build_dataset then reads those files (no file
    of its own appears) and gets the same graphs and target scaling."""
    path = os.path.join(REPO, "configs", "gps", f"{name}-GPS.yaml")
    opts = CACHE_CASES[name] + ["dataset.dir", str(tmp_path)]
    if name == "imdb":
        opts += ["dataset.esc.h", "1"]
    splits, mean, std = run_gps.build_dataset(load_cfg(path, opts), 0)
    files = sorted(os.listdir(tmp_path / f"gps_{load_cfg(path).dataset.name}"))
    assert len(files) == 3
    jmod = load_jax_driver("run_gps")
    jsplits, jmean, jstd = jmod.build_dataset(jconfig.load_cfg(path, opts), 0)
    assert sorted(os.listdir(
        tmp_path / f"gps_{load_cfg(path).dataset.name}")) == files
    assert (mean, std) == (jmean, jstd)
    for split in ("train", "val", "test"):
        _assert_graphs_equal(splits[split], jsplits[split])
