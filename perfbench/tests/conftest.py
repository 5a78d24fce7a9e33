"""Helpers for the benchmark's tests: a cell cut to a size the CPU runs in
seconds, and the `card` marker for tests that need a CUDA card (they
skip on a machine without one)."""

import copy
import time

import pytest
import torch

from perfbench import cell


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run `python3 -m pytest "
                    "perfbench/tests -m card` on the chip)")
    return torch.device("cuda", 0)


def tiny(workload: str, graphs: int = 160, batch: int = 16,
         width: int = 16, layers: int = 2) -> dict:
    """The resolved cell `workload` at a small width, depth and data set."""
    res = copy.deepcopy(cell.resolve(workload))
    f = res["config"]["model"]["fields"]
    for k in ("hidden", "emb_dim"):
        if k in f:
            f[k] = width
    for k in ("num_layers", "num_rb_layers"):
        if k in f:
            f[k] = layers
    res["traffic"]["data"]["num_graphs"] = graphs
    res["traffic"]["batch_size"] = batch
    if "refresh_batches" in res["traffic"]:
        res["traffic"]["refresh_batches"] = 2
    return res


def run_tiny(res: dict, seed: int = 5, device="cpu") -> dict:
    torch.set_num_threads(2)
    return cell.run(res, seed, 0.5, False, torch.device(device),
                    time.time(), 1)
