"""Per-run reproducibility scaffolding (counterpart of
`escgnn_tpu/utils/rundir.py`).

Every results directory gets the exact command line, appended to
`cmd_input.txt`, and a copy of the invoking script plus any extra files.
"""

from __future__ import annotations

import os
import shutil
import sys


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
