"""`tools/quality_curve.py` on small logs written here: the epoch lines
of the drivers' three formats are read (gzip or text), the two curves
are put side by side, and the first epoch from which the port's
best-so-far val metric stays outside the verdict band is named (MAE:
1.5 x JAX's; a score: JAX's - 0.02); a log against itself never leaves
the band.
"""

import gzip
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "quality_curve", os.path.join(ROOT, "tools", "quality_curve.py"))
qc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(qc)


def _mae_line(e, lr, loss, val, prefix=""):
    return (f"{prefix}epoch {e:03d} lr {lr:.6f} loss {loss:.5f} val MAE "
            f"{val:.5f} test MAE {val:.5f} * (0.2s)\n")


def _auc_line(e, loss, val):
    return f"epoch {e:03d} loss {loss:.5f} val rocauc {val:.5f} (0.4s)\n"


def _write(path, lines, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        f.write("dataset: ZINC (synthetic)\n")
        f.writelines(lines)
        f.write("best val 0.1 test 0.1\n")
    return str(path)


JAX_MAE = [0.10, 0.05, 0.04, 0.030, 0.020, 0.010]
CASES = {
    # best-so-far 0.06 at epoch 3 is 1.5 x JAX's 0.04, inside; out from
    # epoch 4 on
    "mae_diverges": (JAX_MAE, [0.10, 0.06, 0.07, 0.060, 0.050, 0.040], 4),
    # out at epoch 4, back inside by the end
    "mae_recovers": (JAX_MAE, [0.10, 0.06, 0.07, 0.050, 0.025, 0.012],
                     None),
    # better than JAX is inside
    "mae_better": (JAX_MAE, [0.09, 0.04, 0.03, 0.020, 0.010, 0.005], None),
    # 1.5x exactly is inside; just over it at the end is out
    "mae_edge": ([0.1, 0.05], [0.15, 0.076], 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mae_band(tmp_path, case, capsys):
    jax, port, first_out = CASES[case]
    jlog = _write(tmp_path / "log.txt.gz",
                  [_mae_line(e + 1, 5e-4, 1.0 / (e + 1), v)
                   for e, v in enumerate(jax)], gz=True)
    plog = _write(tmp_path / "port.log",
                  [_mae_line(e + 1, 5e-4, 1.1 / (e + 1), v)
                   for e, v in enumerate(port)])
    res = qc.main([jlog, plog])
    assert res["first_out"] == first_out
    assert res["jax_best"] == min(jax) and res["port_best"] == min(port)
    out = capsys.readouterr().out
    assert f"stays outside the band: {first_out or 'none'}" in out
    # one printed row per epoch, both curves' lr, loss and val on it
    rows = [ln for ln in out.splitlines() if ln[:5].strip().isdigit()]
    assert len(rows) == len(jax)
    assert rows[0].split()[:7] == ["1", "0.000500", "0.000500", "1.00000",
                                   "1.10000", f"{jax[0]:.5f}",
                                   f"{port[0]:.5f}"]


def test_score_band_and_formats(tmp_path):
    """ROC-AUC lines without `lr`; a nan val keeps the best so far; the
    GPS driver's `[seed 0]` prefix parses."""
    jax = [0.70, 0.80, 0.90, 0.95]
    port = [0.70, 0.79, float("nan"), 0.92]
    jlog = _write(tmp_path / "j.txt", [_auc_line(e + 1, 0.5, v)
                                       for e, v in enumerate(jax)])
    plog = _write(tmp_path / "p.txt", [_auc_line(e + 1, 0.5, v)
                                       for e, v in enumerate(port)])
    res = qc.main([jlog, plog])
    # epoch 3: best 0.79 < 0.90 - 0.02; epoch 4: 0.92 >= 0.93? no
    assert res["first_out"] == 3
    assert [r[4] for r in res["rows"]] == [0.70, 0.79, 0.79, 0.92]
    assert res["rows"][0][1][0] is None  # no lr on OGB lines
    gps = _write(tmp_path / "g.txt", [_mae_line(e + 1, 1e-3, 0.5, v,
                                                prefix="[seed 0] ")
                                      for e, v in enumerate(JAX_MAE)])
    curve = qc.read_curve(gps)
    assert curve["metric"] == "MAE" and sorted(curve["epochs"]) == list(
        range(1, 7))


def test_last_line_of_an_epoch_wins_and_metrics_must_agree(tmp_path):
    jlog = _write(tmp_path / "j.txt", [_mae_line(1, 1e-3, 1.0, 0.5),
                                       _mae_line(1, 1e-3, 1.0, 0.2)])
    assert qc.read_curve(jlog)["epochs"][1][2] == 0.2
    plog = _write(tmp_path / "p.txt", [_auc_line(1, 0.5, 0.9)])
    with pytest.raises(SystemExit, match="metrics differ"):
        qc.main([jlog, plog])


def test_archived_record_against_itself(capsys):
    """A JAX record's log against itself stays in the band throughout."""
    log = os.path.join(ROOT, "results_archive", "zc_i2gnn_t0", "log.txt.gz")
    res = qc.main([log, log])
    assert res["first_out"] is None and len(res["rows"]) == 200
    assert res["jax_best"] == res["port_best"] == pytest.approx(0.00020)
