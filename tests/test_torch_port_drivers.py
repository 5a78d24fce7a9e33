"""The driver twins, run on the CPU at a tiny size in temporary
directories: `run_zinc`, `run_graphcount`, `run_zinc_cycle` and `run_qm9`
at 40 graphs, hidden 16, 2 layers, batch 8, 2 epochs (the files they
write, their epoch lines in the JAX drivers' format, the warm start and
PPGN_eff); `run_sr`, `run_csl` and `run_exp` at the sizes named in their
tests, their result lines in the JAX drivers' format; the unported
flags; the default device."""

import json
import os
import re

import pytest
import torch

from escgnn_tpu_torch import (
    run_csl,
    run_exp,
    run_graphcount,
    run_qm9,
    run_sr,
    run_zinc,
    run_zinc_cycle,
)

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


def test_run_zinc_cycle_twin(tmp_path, capsys):
    """Node-level targets: 32 train graphs in 4 steps, the val MAE over
    real nodes in cycle counts. (The JAX driver has no --data_dir: it
    caches nothing.)"""
    res_dir = tmp_path / "res"
    out = run_zinc_cycle.main(TINY + ["--res_dir", str(res_dir)])
    _check_run(out, res_dir, capsys)
    assert out["spec"].y_is_node_level
    assert (res_dir / "cmd_input.txt").read_text().startswith(
        "python -m escgnn_tpu_torch.run_zinc_cycle --num_graphs 40")


def test_run_qm9_twin(tmp_path, capsys):
    """Synthetic QM9 (no gdb9.sdf under --data_dir): the 10/10/80 split
    leaves 32 train graphs in 4 steps; MAE in the target's units."""
    out, res_dir = _run(run_qm9.main, tmp_path)
    _check_run(out, res_dir, capsys)
    assert not out["is_real"] and out["conversion"] == 1.0
    out2, _ = _run(run_qm9.main, tmp_path, "--target", "2",
                   "--epochs", "1", "--reshuffle_membership", res="t2")
    assert out2["conversion"] == pytest.approx(27.2113825435)


@pytest.fixture
def no_fork(monkeypatch):
    """The expressiveness twins featurize with the JAX drivers' two
    forked workers; this process has JAX loaded, so the tests keep the
    featurizer in process."""
    for twin in (run_sr, run_csl, run_exp):
        monkeypatch.setattr(twin, "FEATURIZE_WORKERS", 0)


def test_run_sr_twin(no_fork, capsys):
    """The real SR25 graphs at the defaults (8 layers x 64)."""
    bad, total = run_sr.main(["--device", "cpu"])
    assert total == 105 and 0 <= bad < total
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"SR25: \d+/105 indistinguishable pairs "
                        r"\((PASS|FAIL)\)", line), line


def test_run_csl_twin(no_fork, capsys):
    """2 folds x 3 epochs at hidden 16 x 2 layers: 75 train graphs in 3
    steps per epoch; the JAX driver's fold and summary lines."""
    out = run_csl.main(["--folds", "2", "--epochs", "3", "--hidden", "16",
                        "--layers", "2", "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"featurize: \d+\.\ds", printed[0])
    assert [ln for ln in printed if ln.startswith("fold")] == [
        f"fold {i}: acc {f['acc']:.3f}" for i, f in enumerate(out["folds"])]
    assert re.fullmatch(r"CSL 2-fold acc: \d\.\d{4} \+- \d\.\d{4}",
                        printed[-1])
    for f in out["folds"]:
        assert f["steps"] == 3 and len(f["losses"]) == 3
        assert f["losses"][-1] < f["losses"][0]


@pytest.mark.parametrize("trials", [1, 3])
def test_run_exp_twin(no_fork, capsys, trials):
    """EXP cut to 40 graphs, 2 splits x 3 epochs at hidden 16 x 2 layers;
    `--nb_trials 3` takes the majority vote of the per-graph step."""
    out = run_exp.main(["--max_graphs", "40", "--splits", "2", "--epochs",
                        "3", "--hidden", "16", "--layers", "2",
                        "--nb_trials", str(trials), "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"featurize 40 graphs: \d+\.\ds", printed[0])
    split_re = (r"split \d: test \d\.\d{3} expressivity \d\.\d{3} "
                r"learning \d\.\d{3}")
    assert sum(bool(re.fullmatch(split_re, ln)) for ln in printed) == 2
    assert re.fullmatch(r"EXP: test \d\.\d{4} expressivity \d\.\d{4} "
                        r"learning \d\.\d{4}", printed[-1])
    for r in out["splits"]:
        assert r["steps"] == 1 and len(r["losses"]) == 3
        assert all(0.0 <= a <= 1.0 for a in r["accs"])


@pytest.mark.parametrize("main,flags,queue", [
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


@pytest.mark.parametrize("main", [run_zinc.main, run_graphcount.main,
                                  run_zinc_cycle.main, run_qm9.main])
def test_twins_default_to_cuda_and_raise_without_it(tmp_path, main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot run")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--res_dir", str(tmp_path / "res")])
    assert not (tmp_path / "res").exists()


@pytest.mark.parametrize("main", [run_sr.main, run_csl.main, run_exp.main])
def test_expressiveness_twins_default_to_cuda(capsys, main):
    """They raise before loading or featurizing anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot run")
    with pytest.raises(RuntimeError, match="cuda"):
        main([])
    assert capsys.readouterr().out == ""
