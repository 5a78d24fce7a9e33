"""The baseline zoo of the PyTorch port against the JAX package, on the
CPU: BaselineGNN, every conv and every graph pooling. Its heads
(`test_torch_port_zoo_heads.py`), the RGCN baseline, IDGNN and the
registry (`test_torch_port_idgnn.py`) run on this file's helpers.

Each case builds the flax model through the JAX registry and the port's
through its own, from the same config, on numpy-seeded synthetic ZINC
molecules (or their h-2 node copies), draws the flax variables with
numpy (`numpy_variables`) and carries them across with
`weights.load_flax_variables` (strict: no leaf unused, no tensor left
unfilled). It compares the eval-mode outputs at rtol 1e-5 of the largest
and the gradients of a fixed linear functional of the train-mode outputs
(batch statistics, dropout 0) at rtol 1e-4, atol 1e-4 of the tensor's
largest entry (PNA's std aggregator differentiates
sqrt(E[m^2] - E[m]^2 + 1e-5), which turns the rounding of that
difference into 1.5e-4 relative on a gradient entry). A gradient that is
zero but for rounding (a bias that feeds a BatchNorm), its largest entry
on JAX's side under 1e-4 of the model's largest gradient, must be under
that bound on the port's side too: a graph-level BatchNorm over 8 rows
amplifies that rounding to 3.6e-5 of the largest. One JAX program per
case, compiled at XLA's optimization level 0 (`jax_run`), computes the
forward and the gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import escgnn_tpu.models as j_models
from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.molecules import synthetic_zinc as j_synthetic_zinc
from escgnn_tpu.featurize import node_subgraphs as j_node
from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.data.molecules import synthetic_zinc
from escgnn_tpu_torch.featurize import node_subgraphs
from escgnn_tpu_torch.models import registry
from escgnn_tpu_torch.models.baselines import BASELINE_CONVS
from escgnn_tpu_torch.models.pooling import GRAPH_POOLS
from escgnn_tpu_torch.weights import flax_to_state_dict, load_flax_variables

BS = 3
IN_DIM = 28  # ZINC-shaped atom types


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_BATCHES = {}


def _batches(copies: bool, onehot: bool = True, graphs: int = BS):
    """(JAX batch, port batch) of `graphs` of `graphs` + 1 synthetic ZINC
    molecules, or of their h-2 node copies with the hop labels `z`; x is
    the one-hot of the atom type over 28 columns (the TU models' float
    input), or with `onehot=False` the type id."""
    key = (copies, onehot, graphs)
    if key not in _BATCHES:
        jg = j_synthetic_zinc(graphs + 1, 1)
        tg = synthetic_zinc(graphs + 1, 1)
        if copies:
            jg = [j_node.create_node_subgraphs(
                g, j_node.NodeSubgraphConfig(h=2)) for g in jg]
            tg = [node_subgraphs.create_node_subgraphs(
                g, node_subgraphs.NodeSubgraphConfig(h=2)) for g in tg]
        if onehot:
            for g in jg + tg:
                g.x = np.eye(IN_DIM, dtype=np.float32)[g.x[:, 0]]
        jb = jax.tree.map(jnp.asarray, j_pad_and_batch(
            jg[:graphs], JBatchSpec.from_graphs(jg, graphs)))
        tb = pad_and_batch(tg[:graphs], BatchSpec.from_graphs(tg, graphs),
                           device="cpu")
        _BATCHES[key] = (jb, tb)
    return _BATCHES[key]


# XLA's CPU backend at optimization level 0: these small programs compile
# 2.5x faster (CPU seconds) and the parities hold by tolerance either way
_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def jax_run(f, *args):
    """`jax.jit(f)(*args)`, compiled at `_FAST_COMPILE`."""
    return jax.jit(f).lower(*args).compile(
        compiler_options=_FAST_COMPILE)(*args)


def numpy_variables(jax_model, *init_args, seed: int = 0) -> dict:
    """The flax variables of `jax_model`, the tree its init makes on
    `init_args` (read by `jax.eval_shape`, nothing compiled: the init's
    random draws compile slower than the gradient), drawn with numpy from
    `seed`: weight tensors N(0, 1/fan_in), embeddings N(0, 1), BN scales
    1 + N(0, 0.1), running means N(0, 0.2) and variances U(0.5, 1.5), the
    rest (biases, GINE+'s eps and v0, ...) N(0, 0.1). The JAX package
    starts those last ones at zero; drawn, every term they enter counts."""
    abstract = jax.eval_shape(jax_model.init, jax.random.key(0), *init_args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "embedding":
            a = rng.normal(0.0, 1.0, shape)
        elif name == "scale":
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        elif name == "mean":
            a = rng.normal(0.0, 0.2, shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif len(shape) >= 2:
            a = rng.normal(0.0, 1.0 / np.sqrt(shape[-2]), shape)
        else:
            a = rng.normal(0.0, 0.1, shape)
        return np.asarray(a, np.float32)

    return {k: jax.tree_util.tree_map_with_path(draw, v)
            for k, v in abstract.items()}


def _weights(shape):
    return np.random.default_rng(int(np.prod(shape))).normal(
        size=shape).astype(np.float32)


def _outputs(out):
    return [out[0], *out[1]] if isinstance(out, tuple) else [out]


def _check(name, cfg, copies=False, onehot=True, graphs=BS, grads=True,
           **ctor):
    """Eval outputs and (with `grads`) train-mode gradients of one
    registered model (the tolerances of the module docstring)."""
    jb, tb = _batches(copies, onehot, graphs)
    jm = j_models.get_model(name, **cfg)
    v = numpy_variables(jm, jb)
    stats = v.get("batch_stats", {})
    shapes = [o.shape for o in _outputs(jax.eval_shape(jm.apply, v, jb))]
    ws = [_weights(s) for s in shapes]

    def run(params, batch):
        eval_out = jm.apply({"params": params, "batch_stats": stats}, batch)

        def functional(p):
            out, _ = jm.apply({"params": p, "batch_stats": stats}, batch,
                              deterministic=True, use_running_average=False,
                              mutable=["batch_stats"])
            return sum(jnp.sum(o * w) for o, w in zip(_outputs(out), ws))

        return eval_out, jax.grad(functional)(params)

    want, jgrads = jax_run(run, v["params"], jb)
    m = registry.get_model(name, device="cpu", **cfg, **ctor)
    load_flax_variables(m, v["params"], stats)
    m.eval()
    with torch.no_grad():
        got = _outputs(m(tb))
    for g, w in zip(got, _outputs(want)):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=1e-5,
                                   atol=1e-5)
    if not grads:
        return
    m.train()
    sum((o * torch.from_numpy(w)).sum()
        for o, w in zip(_outputs(m(tb)), ws)).backward()
    want_g = flax_to_state_dict(jax.tree.map(np.asarray, jgrads), {},
                                getattr(m, "flax_mlps_per_conv", 1))
    got_g = {k: p.grad for k, p in m.named_parameters()}
    assert set(got_g) == set(want_g)
    noise = 1e-4 * max(float(w.abs().max()) for w in want_g.values())
    for k, w in want_g.items():
        tmax = float(w.abs().max())
        if tmax < noise:
            assert float(got_g[k].abs().max()) < noise, k
            continue
        np.testing.assert_allclose(got_g[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * tmax, err_msg=k)


# each conv with a graph pooling: every conv and every pooling once
CONV_POOLS = [("gcn", "mean"), ("gcn_dir", "add"), ("sage", "max"),
              ("gin0", "attention"), ("gin", "set2set"), ("gat", "sort"),
              ("rgcn", "center"), ("pna", "mean")]


@pytest.mark.parametrize("conv,pool", CONV_POOLS,
                         ids=[f"{c}-{p}" for c, p in CONV_POOLS])
def test_baseline_conv_and_pool(conv, pool):
    """Each BaselineGNN conv (gcn_dir on node copies, whose hop labels it
    reads) under a graph pooling of `graph_pool`, 2 layers x 8, dropout
    0."""
    _check("BaselineGNN", dict(conv=conv, pool=pool, hidden=8, num_layers=2,
                               dropout=0.0, sort_k=4),
           copies=conv == "gcn_dir", in_dim=IN_DIM)


def test_conv_pool_pairs_cover_the_zoo():
    """The pairs above hold every conv and every graph pooling."""
    assert {c for c, _ in CONV_POOLS} == set(BASELINE_CONVS)
    assert {p for _, p in CONV_POOLS} == set(GRAPH_POOLS)
