"""The driver twins `escgnn_tpu_torch.run_zinc` and
`escgnn_tpu_torch.run_graphcount`, run on the CPU at a tiny size (40
graphs, hidden 16, 2 layers, batch 8, 2 epochs) in temporary
directories: the files they write, their epoch lines in the JAX drivers'
format, the warm start and PPGN_eff, and the unported flags."""

import json
import os
import re

import pytest
import torch

from escgnn_tpu_torch import run_graphcount, run_zinc

TINY = ["--num_graphs", "40", "--hidden", "16", "--layers", "2",
        "--batch_size", "8", "--epochs", "2", "--num_workers", "0",
        "--device", "cpu"]
# the JAX drivers' epoch line: run_zinc.py:501-510, run_graphcount.py:526-538
EPOCH_LINE = re.compile(
    r"epoch \d{3} lr \d+\.\d{6} loss \d+\.\d{5} val MAE \d+\.\d{5}"
    r"( test MAE \d+\.\d{5} \*)? \(\d+\.\ds\)")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny models' ops are far too small for a team of threads: on a
    shared CPU the team costs the runs several times their work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, tmp_path, *extra, res="res"):
    res_dir = tmp_path / res
    out = main(TINY + ["--data_dir", str(tmp_path / "data"),
                       "--res_dir", str(res_dir), *extra])
    return out, res_dir


def _check_run(out, res_dir, capsys):
    for f in ("config.json", "cmd_input.txt", "log.txt"):
        assert (res_dir / f).exists(), f
    cfg = json.loads((res_dir / "config.json").read_text())
    assert cfg["hidden"] == 16 and cfg["device"] == "cpu"
    log = (res_dir / "log.txt").read_text().splitlines()
    epoch_lines = [ln for ln in log if ln.startswith("epoch")]
    assert len(epoch_lines) == len(out["epochs"])
    printed = capsys.readouterr().out
    for ln in epoch_lines:
        assert EPOCH_LINE.fullmatch(ln), ln
        assert ln in printed
    assert " test MAE " in epoch_lines[0]  # the first epoch is the best yet
    for e in out["epochs"]:
        assert torch.isfinite(torch.tensor([e["loss"], e["val_mae"]])).all()
        assert e["steps"] == 4  # 32 train graphs in batches of 8
    assert out["best_val"] == min(e["val_mae"] for e in out["epochs"])


def test_run_zinc_twin(tmp_path, capsys):
    out, res_dir = _run(run_zinc.main, tmp_path)
    _check_run(out, res_dir, capsys)
    assert sorted(os.listdir(tmp_path / "data" / "zinc_synth")) == [
        f"{s}_n40_s0_esc_h3_rd_sl.v2.npz" for s in ("test", "train", "val")]
    assert (res_dir / "cmd_input.txt").read_text().startswith(
        "python -m escgnn_tpu_torch.run_zinc --num_graphs 40")


def test_run_zinc_twin_reshuffle_and_batch_bn(tmp_path, capsys):
    """--reshuffle_membership (prefetched batches, eager steps) with
    --bn_eval batch and clipping."""
    out, res_dir = _run(run_zinc.main, tmp_path, "--reshuffle_membership",
                        "--bn_eval", "batch", "--grad_clip", "0.1")
    _check_run(out, res_dir, capsys)


def test_run_graphcount_twin_ckpt_warm_start_and_ppgn(tmp_path, capsys):
    """Best-val checkpoints in res_dir/ckpt (at most 3); --load_ckpt warm
    starts a 1-epoch run from them; PPGN_eff runs; --analyze logs the
    per-count table."""
    out, res_dir = _run(run_graphcount.main, tmp_path, "--analyze")
    _check_run(out, res_dir, capsys)
    steps = sorted(int(f[:-3]) for f in os.listdir(res_dir / "ckpt"))
    assert steps and len(steps) <= 3
    starred = [e["epoch"] for e in out["epochs"] if e["test_mae"] is not None]
    assert steps == starred[-3:]
    assert re.search(r"^\s+\d+\s+\d+ \d+\.\d{5}$",
                     (res_dir / "log.txt").read_text(), re.M)
    assert sorted(os.listdir(tmp_path / "data" / "count_cycle")) == [
        f"{s}_n40_s0_y4_esc_h3_rd_sl.v2.npz" for s in ("test", "train", "val")]

    warm, _ = _run(run_graphcount.main, tmp_path, "--epochs", "1",
                   "--load_ckpt", str(res_dir / "ckpt"), res="warm")
    assert "warm-started from" in capsys.readouterr().out
    assert warm["epochs"][0]["loss"] < out["epochs"][0]["loss"]
    ppgn, ppgn_dir = _run(run_graphcount.main, tmp_path, "--epochs", "1",
                          "--model", "PPGN_eff", res="ppgn")
    assert torch.isfinite(torch.tensor(ppgn["epochs"][0]["loss"]))
    assert os.listdir(ppgn_dir / "ckpt") == ["1.pt"]
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _run(run_graphcount.main, tmp_path, "--load_ckpt",
             str(tmp_path / "empty"), res="none")


@pytest.mark.parametrize("main,flags,queue", [
    (run_zinc.main, ["--model", "NGNN"], "8.4"),
    (run_zinc.main, ["--model", "I2GNN"], "8.4"),
    (run_zinc.main, ["--model", "GNN"], "8.7"),
    (run_zinc.main, ["--copy_layout", "bucketed"], "8.4"),
    (run_zinc.main, ["--mesh", "dp"], "10"),
    (run_zinc.main, ["--compress_pools"], "9"),
    (run_graphcount.main, ["--mesh", "ep"], "10"),
    (run_graphcount.main, ["--multihost"], "10"),
    (run_graphcount.main, ["--compress_pools"], "9"),
])
def test_unported_flags_raise_with_their_queue(tmp_path, main, flags, queue):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue {queue}"):
        main(flags + ["--res_dir", str(tmp_path / "res")])
    assert not (tmp_path / "res").exists()


@pytest.mark.parametrize("main", [run_zinc.main, run_graphcount.main])
def test_twins_default_to_cuda_and_raise_without_it(tmp_path, main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot run")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--res_dir", str(tmp_path / "res")])
    assert not (tmp_path / "res").exists()
