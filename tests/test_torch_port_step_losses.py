"""`tools/step_losses.py`: the JAX counting driver and its twin, run from
one initial state (the JAX driver's own init, carried by
`tools/carry_jax_init.py`), give the same loss at every step of every
epoch, on the driver's batches in its order (PPGN_eff at the carry
test's size: 40 graphs, hidden 16, 2 layers, batch 8, 2 epochs; rel
1e-4 or 1e-5 absolute). The same holds when both start from the same
perturbation of those weights (1e-3 here, large enough to move the
losses at this size), and when the twin's BatchNorms take
JAX's one-pass statistics. The table's verdicts read those gaps, and the
bf16-operand probe moves the twin's losses off the f32 ones; each probe
is undone after its run.
"""

import importlib.util
import math
import os

import pytest
import torch

from escgnn_tpu_torch.models import layers, ppgn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


steps_tool, carry = _tool("step_losses"), _tool("carry_jax_init")
FLAGS = ["--model", "PPGN_eff", "--num_graphs", "40", "--hidden", "16",
         "--layers", "2", "--batch_size", "8", "--epochs", "2"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("steps")
    init = str(tmp / "init.npz")
    carry.dump(init, "run_graphcount", FLAGS + [
        "--data_dir", str(tmp / "jd"), "--res_dir", str(tmp / "jr")])
    jax_run = steps_tool.jax_steps("run_graphcount", FLAGS + [
        "--data_dir", str(tmp / "jd2"), "--res_dir", str(tmp / "ja")])
    jax_perturbed = steps_tool.jax_steps("run_graphcount", FLAGS + [
        "--data_dir", str(tmp / "jd2"), "--res_dir", str(tmp / "jp")],
        perturb=1e-3, draw=1)

    def port(name, **kw):
        return steps_tool.port_steps("run_graphcount", init, FLAGS + [
            "--device", "cpu", "--num_workers", "0",
            "--data_dir", str(tmp / "td"), "--res_dir", str(tmp / name)],
            **kw)

    return dict(jax=jax_run, port=port("tp"),
                bf16=port("tb", bf16_operands=True),
                one_pass=port("t1", one_pass_bn=True),
                jax_perturbed=jax_perturbed,
                port_perturbed=port("tq", perturb=1e-3, draw=1))


def _agree(want, got):
    assert len(want["epochs"]) == len(got["epochs"]) == 2
    for je, te in zip(want["epochs"], got["epochs"]):
        assert je["epoch"] == te["epoch"]
        assert len(je["step_losses"]) == len(te["step_losses"]) == 4
        for a, b in zip(je["step_losses"], te["step_losses"]):
            assert math.isclose(b, a, rel_tol=1e-4, abs_tol=1e-5), (a, b)
        assert math.isclose(te["loss"], je["loss"], rel_tol=1e-4,
                            abs_tol=1e-5)


@pytest.mark.parametrize("jax_run,port_run", [
    ("jax", "port"), ("jax", "one_pass"),
    ("jax_perturbed", "port_perturbed")])
def test_every_step_agrees_with_the_jax_driver(runs, jax_run, port_run):
    _agree(runs[jax_run], runs[port_run])
    for e in runs[jax_run]["epochs"]:  # the epoch line's loss: the mean
        assert math.isclose(e["loss"], sum(e["step_losses"]) / 4,
                            abs_tol=1e-5)


def test_the_perturbation_moves_the_losses(runs):
    a = runs["jax"]["epochs"][1]["step_losses"]
    b = runs["jax_perturbed"]["epochs"][1]["step_losses"]
    assert max(abs(x - y) / abs(x) for x, y in zip(a, b)) > 1e-6


def test_table_verdicts(runs):
    c = steps_tool.compare(runs["jax"], runs["port"])
    assert c["step1_ok"] and c["steps_ok"] and c["mean_ok"]
    assert c["steps_before_blowup"] == 4  # no step passes 10x step 1
    text = steps_tool.table([runs["jax"], runs["port"], runs["bf16"],
                             runs["port_perturbed"]])
    assert text.count("\nstep ") == 4
    assert "verdict port-cpu vs jax-cpu: step 1 rel" in text
    assert "verdict port-cpu+bf16 vs jax-cpu" in text
    assert "verdict port-cpu~0.001#1 vs jax-cpu" in text


def test_probes_move_the_losses_and_are_undone(runs):
    assert runs["bf16"]["bf16_operands"] and runs["one_pass"]["one_pass_bn"]
    a = runs["port"]["epochs"][0]["step_losses"]
    b = runs["bf16"]["epochs"][0]["step_losses"]
    gaps = [abs(x - y) / abs(x) for x, y in zip(a, b)]
    assert 1e-6 < max(gaps) < 0.1
    assert layers.TorchDense.forward.__name__ == "forward"
    assert ppgn.RegularBlock.forward.__name__ == "forward"
    assert layers.MaskedBatchNorm.forward.__name__ == "forward"
