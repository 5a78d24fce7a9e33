"""Per-run reproducibility scaffolding (counterpart of
`escgnn_tpu/utils/rundir.py`).

Every results directory gets the exact command line, appended to
`cmd_input.txt`, and a copy of the invoking script plus any extra files;
the twins' runs also get their flags in `config.json` (`start_run`) and
their epoch lines in `log.txt` (`log_line`).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time


def backup_run(res_dir: str, *extra_files: str, argv=None) -> None:
    """Append the command line `argv` (sys.argv when None) to
    `<res_dir>/cmd_input.txt` and copy its script (argv[0]) and
    `extra_files` into `res_dir`."""
    argv = sys.argv if argv is None else argv
    os.makedirs(res_dir, exist_ok=True)
    with open(os.path.join(res_dir, "cmd_input.txt"), "a") as f:
        f.write("python " + " ".join(argv) + "\n")
    for path in (argv[0], *extra_files):
        if path and os.path.isfile(path):
            shutil.copy(path, res_dir)


def start_run(args, prog: str, default_name: str, script: str,
              argv=None) -> str:
    """The run's results directory (`args.res_dir`, else
    results/<default_name>_<time>), holding `config.json` (the flags),
    the command line `python -m <prog> <argv>` and a copy of `script`."""
    res_dir = args.res_dir or os.path.join(
        "results", default_name + "_" + time.strftime("%Y%m%d%H%M%S"))
    os.makedirs(res_dir, exist_ok=True)
    with open(os.path.join(res_dir, "config.json"), "w") as f:
        json.dump(vars(args), f, indent=2)
    backup_run(res_dir, os.path.abspath(script), argv=[
        "-m", prog, *(sys.argv[1:] if argv is None else argv)])
    return res_dir


def log_line(path: str, line: str) -> None:
    """Print `line` and append it to the file at `path`."""
    print(line, flush=True)
    with open(path, "a") as f:
        f.write(line + "\n")
