#!/usr/bin/env python3
"""Train a driver twin from the JAX driver's own initial weights.

    # on the CPU, with JAX: the JAX driver's init for these flags
    JAX_PLATFORMS=cpu python tools/carry_jax_init.py dump INIT.npz \
        run_graphcount -- --model PPGN_eff --target 0 --h 3 ...
    # on the card, without JAX: the twin's run from those weights
    python tools/carry_jax_init.py run INIT.npz run_graphcount -- \
        --model PPGN_eff --target 0 --h 3 ... --res_dir DIR

`dump` runs the repository's JAX driver (`<driver>.py`) with the flags
until its model's `init` returns (the driver's own seed and first batch;
its featurizer pool off, `--num_workers 0`, which changes no data) and
writes the variables to INIT.npz, one array per leaf ("params/a/b",
"batch_stats/..."). `run` builds the twin's model as its `main` does,
loads INIT.npz into it (`weights.load_flax_variables`) and runs the
twin's `main` with the flags. Its log then starts from the weights the
JAX record started from, so `tools/quality_curve.py` compares two runs
that differ only in the programs. A driver qualifies when its twin
builds its model through `build_model`.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Stop(Exception):
    pass


def load_jax_driver(driver: str):
    """The repository's JAX `<driver>.py` as a fresh module on the CPU,
    its compile cache set-up (`setup_jax`, run at import) skipped."""
    sys.path.insert(0, ROOT)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import escgnn_tpu.utils

    spec = importlib.util.spec_from_file_location(
        f"_jax_{driver}", os.path.join(ROOT, f"{driver}.py"))
    mod = importlib.util.module_from_spec(spec)
    setup_jax = escgnn_tpu.utils.setup_jax
    escgnn_tpu.utils.setup_jax = lambda *a, **k: None
    try:
        spec.loader.exec_module(mod)
    finally:
        escgnn_tpu.utils.setup_jax = setup_jax
    return mod


def dump(path: str, driver: str, flags: list) -> None:
    """Run the JAX driver until its model is initialised; save the
    variables."""
    mod = load_jax_driver(driver)
    import jax
    import flax.linen as nn

    argv, original = sys.argv, nn.Module.init
    captured = {}

    def init(self, *args, **kwargs):
        captured["variables"] = jax.tree.map(
            np.asarray, original(self, *args, **kwargs))
        raise _Stop

    nn.Module.init = init
    sys.argv = [f"{driver}.py", *flags, "--num_workers", "0"]
    try:
        mod.main()
    except _Stop:
        pass
    finally:
        sys.argv, nn.Module.init = argv, original
    flat = {}
    for group, tree in captured["variables"].items():
        for keys, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat["/".join([group, *(k.key for k in keys)])] = leaf
    np.savez(path, **flat)
    print(f"{path}: {len(flat)} arrays from {driver}.py {' '.join(flags)}")


def load(path: str) -> dict:
    """The npz back as nested {'params': ..., 'batch_stats': ...}."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return out


def run(path: str, driver: str, flags: list):
    """The twin's main with its model built on the dumped weights."""
    sys.path.insert(0, ROOT)
    from escgnn_tpu_torch.weights import load_flax_variables

    twin = importlib.import_module(f"escgnn_tpu_torch.{driver}")
    variables = load(path)
    build = twin.build_model

    def build_from_init(*args, **kwargs):
        model = build(*args, **kwargs)
        load_flax_variables(model, variables["params"],
                            variables.get("batch_stats", {}))
        return model

    twin.build_model = build_from_init
    try:
        return twin.main(flags)
    finally:
        twin.build_model = build


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=["dump", "run"])
    p.add_argument("init")
    p.add_argument("driver", help="run_graphcount, run_zinc, ...")
    p.add_argument("flags", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    flags = args.flags[1:] if args.flags[:1] == ["--"] else args.flags
    (dump if args.mode == "dump" else run)(args.init, args.driver, flags)


if __name__ == "__main__":
    main()
