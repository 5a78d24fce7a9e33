"""The quality rows of `tools/torch_quality_runs.sh` against the JAX
package's records: each row whose record keeps its command
(`results_archive/<dir>/cmd_input.txt`) runs the twin of the same driver
with the same flags and values, the output and data directories aside;
the twin's parser takes every flag and resolves it, defaults included,
to the flags the JAX run recorded (`config.json`, GPS: `config.yaml`).
The two GPS rows whose records keep only their stdout are held to the
graph and epoch counts `BASELINE.md` states for them and to the epochs
their archived stdout logs. The three clipped PPGN_eff rows differ from
their records in `--epochs` alone: the last epoch their JAX logs reached
(the budget ran out there); their JAX test MAE and best-val epoch are
the ones `BASELINE.md` states and their logs show, and each limit is
1.5 x that MAE.
"""

import gzip
import importlib
import json
import os
import re
import shlex
import subprocess

import pytest

from escgnn_tpu_torch.config import load_cfg, parse_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "tools", "torch_quality_runs.sh")
ARCHIVE = os.path.join(ROOT, "results_archive")

# script row -> the JAX record it reruns
RECORDS = {
    "zinc_cycle": "zinc_cycle_canonical",
    "qm9": "qm9_t0_canonical",
    "ogb_tri_gnn": "ogb_tri_gnn",
    "zinc": "zinc_canonical",
    "zc_ngnn": "zc_ngnn_t0",
    "zc_i2gnn": "zc_i2gnn_t0",
    "qm9_k123": "qm9_k123_t0",
    "ogb_tri_ginep": "ogb_tri_ginep",
    "ogb_tri_nppgn": "ogb_tri_nppgn",
    "gps_zinc": "gps_canonical",
    "count_ppgn": "count_cycle_t0_ppgn",
    "count_ppgn_clip_t0": "count_cycle_t0_ppgn_clip",
    "count_ppgn_clip_t1": "count_cycle_t1_ppgn_clip",
    "cgra_ppgn_clip_t0": "count_graphlet_t0_ppgn_clip",
}
# rows cut to the epochs their JAX log reached: row -> (epochs, JAX test
# MAE raw, its best-val epoch, the quality limit)
CUT = {
    "count_ppgn_clip_t0": (487, 0.00639, 429, 0.00959),
    "count_ppgn_clip_t1": (858, 0.05914, 854, 0.08871),
    "cgra_ppgn_clip_t0": (800, 0.12044, 727, 0.18066),
}
# GPS rows whose record has no cmd_input.txt: row -> (config, record)
STDOUT_ONLY = {
    "gps_pepstruct_full": ("peptides-struct", "gps_pepstruct_full"),
    "gps_aqsol": ("aqsol", "gps_aqsol"),
}
# what a twin may add: where it writes and where it caches data
OUTPUT_FLAGS = {"--res_dir", "--data_dir", "out_dir", "dataset.dir"}


def run_script(out, *names, seed=None, init=None) -> dict:
    """name -> (module, argv) of each row the script starts, read from a
    stand-in `python3` that logs its arguments in place of running (with
    `init`, the row's argv as `tools/carry_jax_init.py run` gets it)."""
    bin_dir = os.path.join(out, "bin")
    os.makedirs(bin_dir, exist_ok=True)
    for tool, body in (("python3", 'printf "%s\\n" "$@"'),
                       ("nvidia-smi", "echo card")):
        path = os.path.join(bin_dir, tool)
        with open(path, "w") as f:
            f.write(f"#!/bin/sh\n{body}\n")
        os.chmod(path, 0o755)
    env = dict(os.environ, PATH=bin_dir + os.pathsep + os.environ["PATH"])
    env.pop("SEED", None)
    env.pop("INIT", None)
    if seed is not None:
        env["SEED"] = str(seed)
    if init is not None:
        env["INIT"] = init
    runs = os.path.join(out, "runs")
    done = subprocess.run(["bash", SCRIPT, runs, *names], env=env,
                          capture_output=True, text=True, check=True)
    assert "FAILED" not in done.stdout
    tag = ("" if init is None else "_jaxinit") + (
        "" if seed is None else f"_s{seed}")
    rows = {}
    for log in os.listdir(runs):
        assert log.endswith(tag + ".log"), log
        with open(os.path.join(runs, log)) as f:
            argv = [a.replace(runs, "$out") for a in f.read().splitlines()]
        if init is None:
            assert argv[0] == "-m" and argv[1].startswith("escgnn_tpu_torch.")
            module, argv = argv[1].split(".", 1)[1], argv[2:]
        else:
            assert argv[:3] == ["tools/carry_jax_init.py", "run", init]
            assert argv[4] == "--"
            module, argv = argv[3], argv[5:]
        rows[log[:-len(tag + ".log")]] = (module, argv)
    return rows


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    return run_script(str(tmp_path_factory.mktemp("quality")))


def flag_values(argv) -> dict:
    """`--flag value` pairs and GPS's dotted `key value` pairs, output
    and data directories dropped."""
    out, i = {}, 0
    while i < len(argv):
        key = argv[i]
        if key.startswith("--") or "." in key or key in (
                "out_dir", "seed"):
            out[key] = argv[i + 1]
            i += 2
        else:
            raise AssertionError(f"unpaired argument {key!r} in {argv}")
    return {k: v for k, v in out.items() if k not in OUTPUT_FLAGS}


def jax_command(record: str):
    """(driver module name, argv) of the record's first command line."""
    with open(os.path.join(ARCHIVE, record, "cmd_input.txt")) as f:
        words = shlex.split(f.readline())
    assert words[0] == "python" and words[1].endswith(".py")
    return os.path.basename(words[1])[:-3], words[2:]


def parse(module: str, argv):
    parser = importlib.import_module(
        f"escgnn_tpu_torch.{module}").build_parser()
    if module == "run_gps":
        return parser.parse_intermixed_args(argv)
    return parser.parse_args(argv)


def flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def test_every_record_row_is_checked(rows):
    assert set(RECORDS) | set(STDOUT_ONLY) <= set(rows)
    for record in RECORDS.values():
        assert os.path.isfile(os.path.join(ARCHIVE, record, "cmd_input.txt"))


@pytest.mark.parametrize("name", sorted(RECORDS) + sorted(STDOUT_ONLY))
def test_row_runs_the_jax_recipe(name, rows):
    module, argv = rows[name]
    ns = parse(module, argv)  # the twin's parser takes every flag
    if name in STDOUT_ONLY:
        cfg_name, record = STDOUT_ONLY[name]
        assert module == "run_gps"
        assert ns.cfg == f"configs/gps/{cfg_name}-GPS.yaml"
        ns.cfg = os.path.join(ROOT, ns.cfg)
        line = next(ln for ln in open(os.path.join(ROOT, "BASELINE.md"))
                    if f"results_archive/{record}/" in ln)
        cfg = load_cfg(ns.cfg, ns.opts)
        graphs = re.search(r"\((\d+) graphs, (\d+) ep\b", line)
        epochs = re.search(r"\b(\d+) ep\)", line)
        if graphs:
            assert cfg.dataset.num_graphs == int(graphs.group(1)), line
            assert cfg.train.epochs == int(graphs.group(2)), line
        else:  # the config's own graph count, no override
            assert epochs and cfg.train.epochs == int(epochs.group(1))
            assert "dataset.num_graphs" not in flag_values(argv)
            assert cfg.dataset.num_graphs == load_cfg(
                ns.cfg).dataset.num_graphs
        with gzip.open(os.path.join(ARCHIVE, record, "stdout.txt.gz"),
                       "rt") as f:
            logged = [ln for ln in f if re.match(r"\[seed 0\] epoch \d+", ln)]
        assert len(logged) == cfg.train.epochs
        return
    record = RECORDS[name]
    jax_module, jax_argv = jax_command(record)
    assert module == jax_module
    want_flags, got_flags = flag_values(jax_argv), flag_values(argv)
    if name in CUT:
        assert int(got_flags.pop("--epochs")) == CUT[name][0]
        assert int(want_flags.pop("--epochs")) >= CUT[name][0]
    assert got_flags == want_flags
    # the twin resolves the flags, defaults included, as JAX's run did
    if module == "run_gps":
        ns.cfg = os.path.join(ROOT, ns.cfg)
        with open(os.path.join(ARCHIVE, record, "config.yaml")) as f:
            want = flat(parse_yaml(f.read()))
        got = flat(load_cfg(ns.cfg, ns.opts).to_plain())
        for key in ("out_dir", "dataset.dir"):
            want.pop(key), got.pop(key)
        assert got == want
    else:
        with open(os.path.join(ARCHIVE, record, "config.json")) as f:
            want = json.load(f)
        got = vars(ns)
        skip = ("res_dir", "data_dir") + (("epochs",) if name in CUT else ())
        diff = {k: (v, got.get(k, "missing")) for k, v in want.items()
                if k not in skip and got.get(k) != v}
        assert not diff, diff


def _epoch_lines(record: str) -> list:
    with gzip.open(os.path.join(ARCHIVE, record, "log.txt.gz"), "rt") as f:
        return [ln for ln in f if re.match(r"epoch \d+ ", ln)]


@pytest.mark.parametrize("name", sorted(CUT))
def test_cut_row_ends_where_its_jax_log_ends(name):
    lines = _epoch_lines(RECORDS[name])
    last = int(re.match(r"epoch (\d+) ", lines[-1]).group(1))
    assert last == len(lines) == CUT[name][0]


@pytest.mark.parametrize("name", sorted(CUT))
def test_cut_row_numbers_are_the_baseline_records(name):
    """The JAX test MAE is the one BASELINE.md states for the record and
    the one its log prints at the best-val epoch; the limit is 1.5 x it
    (the rows' quality rule), to the fifth decimal."""
    _, mae, best, limit = CUT[name]
    record = RECORDS[name]
    text = open(os.path.join(ROOT, "BASELINE.md")).read()
    para = next(p for p in text.split("\n\n")
                if f"results_archive/{record}/" in p)
    assert re.search(rf"best test MAE\s+{mae:.5f}\s+raw", para), para
    starred = [ln for ln in _epoch_lines(record) if ln.rstrip().endswith(
        "*") or " * (" in ln]
    assert re.match(rf"epoch {best:03d} .* test MAE {mae:.5f} \*",
                    starred[-1]), starred[-1]
    assert abs(limit - 1.5 * mae) <= 5e-6


def test_seed_env_tags_each_row(tmp_path, rows):
    """`SEED=n` appends the driver's own seed flag to a row, names its
    log `<name>_s<n>.log` and moves its results under `_s<n>`; the rows
    are otherwise the ones checked above."""
    names = ("zc_ngnn", "gps_aqsol")
    seeded = run_script(str(tmp_path), *names, seed=2)
    assert set(seeded) == set(names)
    for name in names:
        module, argv = seeded[name]
        assert module == rows[name][0]
        flag = "seed" if module == "run_gps" else "--seed"
        assert argv[-2:] == [flag, "2"]
        assert argv[:-2] == [a.replace(f"/{name}_res", f"/{name}_s2_res")
                             for a in rows[name][1]]


def test_init_env_starts_a_row_from_the_jax_weights(tmp_path, rows):
    """`INIT=npz` runs a driver row through `carry_jax_init.py run` with
    the row's own flags, its log and results tagged `_jaxinit` (then the
    seed's tag)."""
    started = run_script(str(tmp_path), "count_ppgn", seed=1,
                         init="chip_archive/init_s1.npz")
    module, argv = started["count_ppgn"]
    assert module == rows["count_ppgn"][0]
    assert argv[-2:] == ["--seed", "1"]
    assert argv[:-2] == [a.replace("/count_ppgn_res",
                                   "/count_ppgn_jaxinit_s1_res")
                         for a in rows["count_ppgn"][1]]
