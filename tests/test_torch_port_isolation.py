"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never move work to the CPU on their own.

Import checks run in a fresh interpreter (this test process has JAX
loaded by tests/conftest.py).
"""

import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import escgnn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    escgnn_tpu_torch.__path__, "escgnn_tpu_torch.")]
for n in names:
    importlib.import_module(n)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "escgnn_tpu"))
assert not bad, bad
print(len(names))
"""


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_imports_no_jax_and_no_jax_package():
    """Every module of escgnn_tpu_torch, and chip_smoke.py, imported in a
    fresh interpreter leave jax/flax/optax/escgnn_tpu out of sys.modules."""
    r = _run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20  # every module was walked


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot run")


def test_entry_points_default_to_cuda_and_raise_without_it(no_card):
    from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
    from escgnn_tpu_torch.data.molecules import synthetic_zinc
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.models.nested_gin_eff import (
        NestedGINEff,
        NestedGINEffConfig,
    )

    graphs = featurize_many(synthetic_zinc(2), EscConfig(h=2))
    spec = BatchSpec.uniform(graphs, 2, enc_layout="dedup")
    with pytest.raises(RuntimeError, match="cuda"):
        pad_and_batch(graphs, spec)
    batch = pad_and_batch(graphs, spec, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        batch.to()
    with pytest.raises(RuntimeError, match="cuda"):
        NestedGINEff(NestedGINEffConfig(hidden=8, num_layers=1))
    assert isinstance(batch.x, torch.Tensor)
    assert np.asarray(batch.x).shape[0] == spec.num_nodes


def test_slice_modules_are_walked():
    """The import walk reaches every slice's modules, the driver twins
    and their data modules included (and still finds no JAX)."""
    r = _run([sys.executable, "-c", _IMPORT_ALL + "print(' '.join(names))"],
             cwd=REPO)
    assert r.returncode == 0, r.stderr
    names = r.stdout.split()
    for mod in ("data.counting", "data.graphlets", "models.ppgn",
                "ops.ppgn_pool", "ops.zemb_gather", "data.prefetch",
                "featurize.cache", "train.checkpoint", "utils.rundir",
                "run_zinc", "run_graphcount", "train.fit", "data.qm9",
                "data.csl", "data.sr", "data.planar_sat", "run_zinc_cycle",
                "run_qm9", "run_sr", "run_exp", "run_csl", "data.compress",
                "parallel", "parallel.mesh", "parallel.multihost",
                "parallel.data_parallel", "parallel.edge_partition",
                "parallel.halo", "bench", "utils.cost"):
        assert f"escgnn_tpu_torch.{mod}" in names, mod


def test_importing_the_twins_runs_nothing(tmp_path):
    """Importing the driver twins (as the import walk and spawned
    featurizer workers do) parses no arguments, prints nothing and writes
    nothing."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-c", "import escgnn_tpu_torch.run_zinc, "
         "escgnn_tpu_torch.run_graphcount, escgnn_tpu_torch.run_zinc_cycle, "
         "escgnn_tpu_torch.run_qm9, escgnn_tpu_torch.run_sr, "
         "escgnn_tpu_torch.run_exp, escgnn_tpu_torch.run_csl, "
         "escgnn_tpu_torch.bench",
         "--epochs", "x"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout == ""
    assert os.listdir(tmp_path) == []


def test_ppgn_defaults_to_cuda_and_raises_without_it(no_card):
    from escgnn_tpu_torch.models.ppgn import PPGN, PPGNConfig

    with pytest.raises(RuntimeError, match="cuda"):
        PPGN(PPGNConfig(emb_dim=8, num_rb_layers=1))
    assert isinstance(PPGN(PPGNConfig(emb_dim=8, num_rb_layers=1),
                           device="cpu"), torch.nn.Module)


def test_chip_smoke_fails_without_a_card(no_card, tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    from the checkout and alone in an empty directory."""
    r = _run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Building a kernel with no nvcc raises instead of falling back."""
    from escgnn_tpu_torch import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed at its default path")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


def test_gps_slice_is_walked_and_needs_no_yaml_or_sklearn():
    """The GPS slice's modules are reached by the import walk, and no
    module of the port (nor chip_smoke.py) imports PyYAML or sklearn,
    which the card's machine does not have."""
    r = _run([sys.executable, "-c", _IMPORT_ALL + (
        "print(' '.join(names)); print(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('yaml', 'sklearn')))")], cwd=REPO)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    names = lines[1].split()
    for mod in ("run_gps", "config", "models.gps", "data.contact",
                "featurize.spd", "featurize.posenc"):
        assert f"escgnn_tpu_torch.{mod}" in names, mod
    assert lines[2] == "[]"


def test_run_gps_defaults_to_cuda_and_raises_without_it(no_card, tmp_path):
    """`run_gps.main` (and its model) take the card by default and raise
    without one, before any data is built; `--device cpu` runs."""
    from escgnn_tpu_torch import run_gps
    from escgnn_tpu_torch.models.gps import GPSConfig, GPSModel

    cfg = os.path.join(REPO, "configs", "gps", "zinc-GPS.yaml")
    opts = ["out_dir", str(tmp_path / "runs"), "dataset.dir",
            str(tmp_path / "data")]
    with pytest.raises(RuntimeError, match="cuda"):
        run_gps.main(["--cfg", cfg, *opts])
    assert os.listdir(tmp_path) == []
    with pytest.raises(RuntimeError, match="cuda"):
        GPSModel(GPSConfig(dim_h=8, num_layers=1, num_heads=2))
    res = run_gps.main(["--cfg", cfg, *opts, "dataset.num_graphs", "20",
                        "model.dim_h", "8", "model.num_layers", "1",
                        "model.num_heads", "2", "train.batch_size", "8",
                        "train.epochs", "1", "--device", "cpu"])
    assert math.isfinite(res["runs"][0]["best_val_mae"])


def test_no_module_imports_sklearn():
    """No source of the port, nor chip_smoke.py, imports sklearn anywhere,
    inside functions included (read with `ast`, so an import that only a
    rare branch reaches is caught too): the card's machine has no
    sklearn."""
    import ast
    import glob

    paths = glob.glob(os.path.join(REPO, "escgnn_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(paths) > 60
    found = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [(os.path.relpath(path, REPO), n) for n in names
                      if n.split(".")[0] == "sklearn"]
    assert found == []
