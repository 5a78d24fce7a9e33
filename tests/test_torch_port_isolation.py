"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never move work to the CPU on their own.

Import checks run in a fresh interpreter (this test process has JAX
loaded by tests/conftest.py).
"""

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
