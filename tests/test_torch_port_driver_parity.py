"""The driver twins track the JAX drivers on the same data and initial
weights, on the CPU.

The JAX `run_zinc.py` and `run_graphcount.py` mains run in this process
(`sys.argv` patched, `--num_workers 0`: JAX is initialised, so nothing
forks) at 40 graphs, hidden 16, 2 layers, batch 8, 3 epochs; the
counting driver with NestedGIN_eff and with PPGN_eff. The flax
variables each one initialises (`model.init(jax.random.key(seed), first
batch of splits["train"][:2])`, read as the driver makes them) are
carried into the twin's model by `weights.load_flax_variables`, through
the twin's model factory patched here. Both runs' `log.txt` epoch lines
then agree: the loss at rel 1e-4, or 1e-5 absolute (one unit of the
lines' fifth decimal), and the val MAE at that tolerance too, except
for the counting twin under `--bn_eval running`, where it holds at rel
3e-3: the counting graphs' node features are all ones, so the first
BatchNorm of its x_embedding sees a constant column whose batch variance
is 0. The refresh recovers each batch's moments from one momentum update,
(new - 0.9 * old) / 0.1, so that variance comes out as the rounding
residue of the f32 update, and eval divides the equally small residue of
x - mean by sqrt(var + 1e-5): the two packages' last-bit differences
reach the output at ~1e-3 (with `--bn_eval batch` the counting twin
agrees at 1e-4). Data, batches, pools and epoch orders are already equal
(test_torch_port_pools.py); what this adds is the whole loop: the
graphed-step-shaped pool epochs, the BN refresh, the pool eval and the
plateau scheduler, over 12 Adam steps.
"""

import importlib.util
import math
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

import escgnn_tpu.utils
from escgnn_tpu_torch import run_graphcount, run_zinc
from escgnn_tpu_torch.weights import load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--num_graphs", "40", "--hidden", "16", "--layers", "2",
        "--batch_size", "8", "--epochs", "3", "--num_workers", "0"]
LINE = re.compile(r"epoch (\d{3}) lr \S+ loss (\S+) val MAE (\S+)")


def load_jax_driver(name: str):
    """The repository's `<name>.py` as a fresh module, its persistent
    compilation cache set-up (`setup_jax`, run at import) skipped so that
    this process's JAX configuration stays as the tests set it."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_driver_{name}", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    saved = escgnn_tpu.utils.setup_jax
    escgnn_tpu.utils.setup_jax = lambda *a, **k: None
    try:
        spec.loader.exec_module(mod)
    finally:
        escgnn_tpu.utils.setup_jax = saved
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_jax(monkeypatch, name, flags, data_dir, res_dir):
    """Run the JAX driver's main; returns the flax variables it
    initialised."""
    import escgnn_tpu.models.ppgn as jax_ppgn

    mod = load_jax_driver(name)
    captured = {}

    def capturing(cls):
        class Capturing(cls):
            def init(self, *args, **kwargs):
                variables = super().init(*args, **kwargs)
                # a host copy: the driver's jitted step donates the state
                captured["variables"] = jax.tree.map(np.array, variables)
                return variables

        return Capturing

    monkeypatch.setattr(mod, "NestedGINEff", capturing(mod.NestedGINEff))
    # the counting driver imports PPGN inside main()
    monkeypatch.setattr(jax_ppgn, "PPGN", capturing(jax_ppgn.PPGN))
    monkeypatch.setattr(sys, "argv", [os.path.join(REPO, f"{name}.py"),
                                      *flags, "--data_dir", str(data_dir),
                                      "--res_dir", str(res_dir)])
    mod.main()
    return captured["variables"]


def _carry(monkeypatch, twin, variables):
    """Patch the twin's model factory to load `variables` into the model
    it builds."""
    build = twin.build_model

    def build_with_jax_init(*args, **kwargs):
        model = build(*args, **kwargs)
        load_flax_variables(model, variables["params"],
                            variables["batch_stats"])
        return model

    monkeypatch.setattr(twin, "build_model", build_with_jax_init)


def _epochs(res_dir):
    lines = (res_dir / "log.txt").read_text().splitlines()
    return [tuple(float(v) for v in m.groups()[1:])
            for m in map(LINE.match, lines) if m]


def _close(a, b, rel=1e-4):
    return math.isclose(a, b, rel_tol=rel, abs_tol=1e-5)


@pytest.mark.parametrize("name,twin,extra,val_rel", [
    ("run_zinc", run_zinc, [], 1e-4),
    ("run_zinc", run_zinc, ["--bn_eval", "batch"], 1e-4),
    ("run_graphcount", run_graphcount, [], 3e-3),
    ("run_graphcount", run_graphcount, ["--bn_eval", "batch"], 1e-4),
    ("run_graphcount", run_graphcount, ["--model", "PPGN_eff"], 3e-3),
    ("run_graphcount", run_graphcount, ["--model", "PPGN_eff",
                                        "--bn_eval", "batch"], 1e-4),
])
def test_twin_tracks_the_jax_driver(monkeypatch, tmp_path, name, twin,
                                    extra, val_rel):
    flags = ARGS + extra
    variables = _run_jax(monkeypatch, name, flags, tmp_path / "jdata",
                         tmp_path / "jres")
    _carry(monkeypatch, twin, variables)
    out = twin.main(flags + ["--device", "cpu",
                             "--data_dir", str(tmp_path / "tdata"),
                             "--res_dir", str(tmp_path / "tres")])
    want = _epochs(tmp_path / "jres")
    got = _epochs(tmp_path / "tres")
    assert len(want) == len(got) == 3
    for (jl, jv), (tl, tv), e in zip(want, got, out["epochs"]):
        assert _close(tl, jl), (got, want)
        assert _close(tv, jv, val_rel), (got, want)
        # the twin's unrounded numbers print as its log line does
        assert f"{e['loss']:.5f}" == f"{tl:.5f}"
    # the loss moved: a twin that ignored the carried weights or skipped
    # the updates would not track the JAX run
    assert want[-1][0] < want[0][0]
