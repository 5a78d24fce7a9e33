"""The port's run logger (`escgnn_tpu_torch/train/logger.py`) against
`escgnn_tpu/train/logger.py`: the same inputs give the same summaries
(floats at rtol 1e-12: both reduce in numpy; `time_s` excepted) and the
same `log.txt` and `metrics.jsonl` lines; tensors are taken as arrays;
the link task keeps JAX's behaviour of resetting only its ranking stats.
"""

import json

import numpy as np
import pytest
import torch

from escgnn_tpu.train.logger import RunLogger as JRunLogger
from escgnn_tpu.train.logger import SplitLogger as JSplitLogger
from escgnn_tpu_torch.train.logger import RunLogger, SplitLogger


def _same(got: dict, want: dict):
    got, want = dict(got), dict(want)
    got.pop("time_s"), want.pop("time_s")
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
        else:
            assert got[k] == v, k


def _feeds(task: str):
    rng = np.random.default_rng(0)
    out = []
    for i in range(3):
        if task == "regression":
            pred, true = rng.normal(size=(8, 2)), rng.normal(size=(8, 2))
        elif task == "classification":
            pred, true = rng.normal(size=(8, 3)), rng.integers(0, 3, 8)
        else:
            true = rng.integers(0, 2, (8, 3)).astype(float)
            pred = true + rng.normal(0, 0.6, true.shape)
        mask = rng.uniform(size=8) < 0.8
        out.append((pred, true, mask, 0.1 * (i + 1)))
    return out


@pytest.mark.parametrize("task", ["regression", "classification",
                                  "multilabel"])
def test_split_logger_equals_jax(task):
    """Three masked batches (the port's as tensors), two epochs: the
    summaries equal JAX's; the second epoch starts from an empty buffer."""
    lg, jlg = SplitLogger("val", task), JSplitLogger("val", task)
    for _ in range(2):
        for pred, true, mask, loss in _feeds(task):
            lg.update(torch.from_numpy(pred), torch.from_numpy(true),
                      torch.from_numpy(mask), loss=loss)
            jlg.update(pred, true, mask, loss=loss)
        _same(lg.epoch_summary(), jlg.epoch_summary())
    _same(lg.epoch_summary(), jlg.epoch_summary())  # empty: n 0, no loss


def test_split_logger_link_equals_jax():
    """Link task: mean of the graphs' stats, empty stats skipped; as in
    JAX only the ranking stats reset, so rows and losses given to
    `update` stay and count into the next summary's loss."""
    lg, jlg = SplitLogger("val", "link"), JSplitLogger("val", "link")
    stats = [{"mrr": 1.0, "hits@1": 1.0}, {"mrr": 0.25, "hits@1": 0.0},
             {}]
    for s in stats:
        lg.update_link_stats(s)
        jlg.update_link_stats(s)
    for logger in (lg, jlg):
        logger.update(np.ones((2, 1)), np.zeros((2, 1)), np.ones(2, bool),
                      loss=0.5)
    _same(lg.epoch_summary(), jlg.epoch_summary())
    for logger in (lg, jlg):
        logger.update(np.ones((2, 1)), np.zeros((2, 1)), np.ones(2, bool),
                      loss=1.5)
    got, want = lg.epoch_summary(), jlg.epoch_summary()
    _same(got, want)
    assert got["n"] == 0 and got["loss"] == 1.0


def test_run_logger_writes_jax_lines(tmp_path):
    """The same epochs logged by both packages give the same `log.txt`
    and `metrics.jsonl` files, line for line, and the same messages."""
    rl, jrl = RunLogger(str(tmp_path / "t")), JRunLogger(str(tmp_path / "j"))
    for epoch, stats in ((1, dict(loss=0.5, val_mae=1.25, n=3)),
                         (2, dict(loss=0.25, val_mae=1.0, split="val"))):
        assert rl.log(epoch, **stats) == jrl.log(epoch, **stats)
    for name in ("log.txt", "metrics.jsonl"):
        assert (tmp_path / "t" / name).read_text() == \
            (tmp_path / "j" / name).read_text()
    lines = (tmp_path / "t" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[1])["val_mae"] == 1.0
    rl.finish()
    jrl.finish()
