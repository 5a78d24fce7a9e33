"""The port's checkpoint manager (the orbax manager's API over
`torch.save`) and run-directory backup, on the CPU."""

import os
import sys

import pytest
import torch

from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_model_tree,
    model_tree,
    restore_train_state,
    train_state_tree,
)
from escgnn_tpu_torch.train.loop import adam_with_plateau
from escgnn_tpu_torch.utils.rundir import backup_run


def _model(seed):
    return NestedGINEff(NestedGINEffConfig(hidden=8, num_layers=1),
                        in_dim=3, device="cpu",
                        generator=torch.Generator().manual_seed(seed))


def _assert_tree_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, dict) and isinstance(b, dict))
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_round_trip_is_bit_equal(tmp_path):
    tree = {"params": {"w": torch.randn(3, 4), "b": torch.randn(4).double()},
            "batch_stats": {"m": torch.arange(5, dtype=torch.int32)},
            "step": 7, "note": [1.5, "x"]}
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.restore() is None and ckpt.latest_step() is None
    ckpt.save(3, tree)
    _assert_tree_equal(ckpt.restore(3), tree)
    _assert_tree_equal(ckpt.restore(), tree)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["3.pt"]  # no tmp left


def test_max_to_keep_prunes_oldest_and_force(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=3)
    for step in (1, 2, 5, 9):
        ckpt.save(step, {"v": torch.tensor(float(step))})
    assert ckpt.all_steps() == [2, 5, 9] and ckpt.latest_step() == 9
    with pytest.raises(ValueError, match="exists"):
        ckpt.save(9, {"v": torch.tensor(0.0)})
    ckpt.save(9, {"v": torch.tensor(0.0)}, force=True)
    assert float(ckpt.restore()["v"]) == 0.0
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 5, 9]
    ckpt.close()
    with pytest.raises(RuntimeError, match="closed"):
        ckpt.save(10, {})


def test_restore_with_template(tmp_path):
    """A template's structure and shapes are required; each tensor comes
    back with the template's type."""
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, {"a": {"w": torch.randn(2, 3)}, "n": torch.ones(4)})
    got = ckpt.restore(template={"a": {"w": torch.zeros(2, 3,
                                                         dtype=torch.float64)},
                                 "n": torch.zeros(4)})
    assert got["a"]["w"].dtype == torch.float64
    with pytest.raises(ValueError, match="template"):
        ckpt.restore(template={"a": {"w": torch.zeros(3, 2)},
                               "n": torch.zeros(4)})
    with pytest.raises(ValueError, match="keys"):
        ckpt.restore(template={"a": {"w": torch.zeros(2, 3)}})


def test_model_tree_and_restore_train_state(tmp_path):
    """A model's params and BN stats (and the optimizer's state) restored
    into another model in place: the same tensors, now equal."""
    src, dst = _model(1), _model(2)
    with torch.no_grad():
        next(src.buffers()).add_(0.5)
    p = torch.nn.Parameter(torch.zeros(2))
    opt = adam_with_plateau(src.parameters(), 1e-3)
    loss = sum(q.sum() for q in src.parameters())
    loss.backward()
    opt.step()
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(4, train_state_tree(src, opt, step=11))
    ids = [id(t) for t in dst.parameters()]
    dst_opt = adam_with_plateau(dst.parameters(), 1e-3)
    assert restore_train_state(ckpt, dst, dst_opt) == 11
    assert [id(t) for t in dst.parameters()] == ids
    _assert_tree_equal(model_tree(dst), model_tree(src))
    assert dst_opt.state_dict()["state"].keys() == opt.state_dict()[
        "state"].keys()
    # an optimizer of another layout keeps its fresh state
    other = adam_with_plateau([p], 1e-3)
    assert restore_train_state(ckpt, _model(3), other) == 11
    assert not other.state
    with pytest.raises(ValueError, match="does not match"):
        load_model_tree(NestedGINEff(NestedGINEffConfig(hidden=8,
                                                        num_layers=2),
                                     in_dim=3, device="cpu"),
                        ckpt.restore())
    assert restore_train_state(CheckpointManager(str(tmp_path / "none")),
                               dst) is None


def test_backup_run(tmp_path):
    """The command line is appended to cmd_input.txt and the script is
    copied in."""
    script = tmp_path / "drive.py"
    script.write_text("print(1)\n")
    res = tmp_path / "res"
    backup_run(str(res), argv=[str(script), "--epochs", "2"])
    backup_run(str(res), argv=["-m", "pkg.mod"])
    lines = (res / "cmd_input.txt").read_text().splitlines()
    assert lines == [f"python {script} --epochs 2", "python -m pkg.mod"]
    assert (res / "drive.py").read_text() == "print(1)\n"
    backup_run(str(res))
    assert (res / "cmd_input.txt").read_text().splitlines()[-1] == (
        "python " + " ".join(sys.argv))
