"""The copied traffic generators: the same graphs from the same seed, and
the graphs of the system's own generators they were copied from."""

import numpy as np
import pytest

from perfbench.gen import counting_graphs, zinc_molecules

COUNT = dict(num_graphs=40, n_min=10, n_max=24, avg_degree=3.0,
             task="cycle")


def _same(a, b):
    return all(
        x.num_nodes == y.num_nodes
        and np.array_equal(x.edge_index, y.edge_index)
        and np.array_equal(x.x, y.x) and np.array_equal(x.y, y.y)
        and (x.edge_attr is None) == (y.edge_attr is None)
        and (x.edge_attr is None or np.array_equal(x.edge_attr, y.edge_attr))
        for x, y in zip(a, b)) and len(a) == len(b)


@pytest.mark.parametrize("gen,params", [
    (zinc_molecules, dict(num_graphs=60)),
    (counting_graphs, COUNT),
])
def test_same_seed_same_graphs(gen, params):
    seed = 2**31 + 12345  # seeds beyond 32 signed bits
    a = gen.generate(params, seed)
    assert _same(a, gen.generate(params, seed))
    assert not _same(a, gen.generate(params, seed + 1))


def test_zinc_matches_the_systems_generator():
    from escgnn_tpu_torch.data.molecules import synthetic_zinc

    a = zinc_molecules.generate(dict(num_graphs=50), 7)
    assert _same(a, synthetic_zinc(50, 7))


def test_counting_matches_the_systems_generator():
    from escgnn_tpu_torch.data.counting import (
        CountingDatasetConfig,
        generate_counting_graphs,
    )

    a = counting_graphs.generate(COUNT, 9)
    b = generate_counting_graphs(CountingDatasetConfig(
        num_graphs=40, seed=9, train_frac=1.0, val_frac=0.0))["train"]
    assert _same(a, b)


def test_counting_workers_give_the_same_counts():
    a = counting_graphs.generate(dict(COUNT, num_graphs=80), 3, workers=1)
    b = counting_graphs.generate(dict(COUNT, num_graphs=80), 3, workers=2)
    assert _same(a, b)
