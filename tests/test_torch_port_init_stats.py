"""The port's initial draws follow the JAX package's laws, leaf by leaf.

Two models at full width, each initialised by both packages from one
tiny batch: count_ppgn's PPGN_eff (256 x 5, ESC h 3, node level) and the
flagship NestedGIN_eff at the ZINC twin's config (256 x 5). Every flax
leaf is read beside the port tensor its path maps to
(`weights._torch_key`), and both are held to the leaf's law: a Dense
kernel and its bias uniform on [-1/sqrt(fan_in), 1/sqrt(fan_in)] (fan_in
the kernel's input width), with max |x| >= 0.98 of that bound and a std
within 3% of bound/sqrt(3) where the leaf has at least 10,000 entries;
`z_initial` and embedding tables N(0, 1), their std within 3% at that
size; BatchNorm scale exactly 1, bias exactly 0, running mean 0 and
variance 1; GIN's epsilon exactly 0. The leaves are large, so one draw
of each suffices: the sample std of 10,000 uniform entries has a
relative spread of 0.45%, of normal ones 0.71%, and the chance that
none lies above 0.98 of the bound is 0.99^10000.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from escgnn_tpu.data import counting as j_counting
from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.molecules import synthetic_zinc as j_synthetic_zinc
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu.models.nested_gin_eff import NestedGINEff as JNestedGINEff
from escgnn_tpu.models.nested_gin_eff import NestedGINEffConfig as JConfig
from escgnn_tpu.models.ppgn import PPGN as JPPGN
from escgnn_tpu.models.ppgn import PPGNConfig as JPPGNConfig
from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff
from escgnn_tpu_torch.models.ppgn import PPGN, PPGNConfig
from escgnn_tpu_torch.run_zinc import zinc_model_config
from escgnn_tpu_torch.weights import _PARAM_LEAF, _STAT_LEAF, _torch_key

LARGE = 10_000  # entries from which a leaf's std and max are held
STD_RTOL, MAX_FRAC = 0.03, 0.98


def _ppgn():
    graphs = j_counting.generate_counting_graphs(
        j_counting.CountingDatasetConfig(num_graphs=12, seed=0))["train"][:2]
    graphs = j_featurize_many(graphs, JEscConfig(h=3, use_rd=True,
                                                 self_loop=True))
    spec = JBatchSpec.uniform(graphs, 2, enc_layout="dedup")
    kw = dict(emb_dim=256, num_rb_layers=5, node_level=True, use_esc=True,
              max_nodes=max(spec.max_nodes_per_graph, spec.uniform_nodes))
    return (JPPGN(JPPGNConfig(**kw)), spec, graphs,
            PPGN(PPGNConfig(**kw), device="cpu",
                 generator=torch.Generator().manual_seed(0)))


def _flagship():
    graphs = j_featurize_many(j_synthetic_zinc(2, seed=0), JEscConfig(h=3))
    spec = JBatchSpec.uniform(graphs, 2, enc_layout="dedup")

    class Args:
        hidden, layers = 256, 5

    cfg = zinc_model_config(Args)
    jcfg = JConfig(**{f: getattr(cfg, f) for f in (
        "hidden", "num_layers", "dropout", "act", "graph_pred", "pool",
        "use_x_embedding_jk", "head_order", "node_embed_vocab",
        "edge_embed_vocab", "out_dim")})
    return (JNestedGINEff(jcfg), spec, graphs,
            NestedGINEff(cfg, in_dim=graphs[0].x.shape[1], device="cpu",
                         generator=torch.Generator().manual_seed(0)))


@pytest.fixture(scope="module", params=["ppgn_eff", "flagship"])
def draws(request):
    jmodel, spec, graphs, tmodel = (_ppgn if request.param == "ppgn_eff"
                                    else _flagship)()
    batch = jax.tree.map(jnp.asarray, j_pad_and_batch(graphs, spec))
    variables = jax.jit(jmodel.init)(jax.random.key(0), batch)
    state = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    leaves = []
    for group, leaf_map in (("params", _PARAM_LEAF),
                            ("batch_stats", _STAT_LEAF)):
        tree = variables.get(group, {})
        flat = {tuple(k.key for k in keys): np.asarray(v)
                for keys, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        for path, a in flat.items():
            t = state.pop(_torch_key(path, leaf_map))
            siblings = {p[-1]: v for p, v in flat.items()
                        if p[:-1] == path[:-1]}
            leaves.append((group, path, a, t, siblings))
    # every port tensor is a flax leaf's (BatchNorm's step counter aside)
    assert not [k for k in state if not k.endswith("num_batches_tracked")]
    return request.param, leaves


def _law(group, path, siblings):
    """('uniform', bound) | ('normal', None) | ('const', value)."""
    name = path[-1]
    if group == "batch_stats":
        return "const", {"mean": 0.0, "var": 1.0}[name]
    if name == "scale":
        return "const", 1.0
    if name == "eps":  # GIN's learnable epsilon starts at 0
        return "const", 0.0
    if name == "bias" and "scale" in siblings:
        return "const", 0.0
    if name in ("kernel", "bias") and "kernel" in siblings:
        return "uniform", 1.0 / math.sqrt(siblings["kernel"].shape[0])
    if name in ("z_initial", "embedding"):
        return "normal", None
    raise AssertionError(f"no law for {group}/{'/'.join(path)}")


def _check(x, law, arg, where):
    x = np.asarray(x, np.float64).ravel()
    if law == "const":
        np.testing.assert_array_equal(x, arg, err_msg=where)
        return
    if law == "uniform":
        assert np.abs(x).max() <= arg * (1 + 1e-6), where
        if x.size >= LARGE:
            assert np.abs(x).max() >= MAX_FRAC * arg, where
            want = arg / math.sqrt(3)
            assert abs(x.std() - want) <= STD_RTOL * want, (where, x.std())
        return
    if x.size >= LARGE:
        assert abs(x.std() - 1.0) <= STD_RTOL, (where, x.std())


def test_every_leaf_follows_the_jax_law_in_both_packages(draws):
    model, leaves = draws
    laws = set()
    for group, path, a, t, siblings in leaves:
        assert a.shape == (t.T.shape if path[-1] == "kernel" else t.shape)
        law, arg = _law(group, path, siblings)
        laws.add(law)
        where = f"{model} {group}/{'/'.join(path)}"
        _check(a, law, arg, "jax " + where)
        _check(t, law, arg, "port " + where)
    assert laws == {"uniform", "normal", "const"}


def test_large_leaves_are_checked(draws):
    """The std and max checks see most of each model's entries."""
    _, leaves = draws
    sizes = [(a.size, _law(g, p, s)[0]) for g, p, a, _, s in leaves]
    large = sum(n for n, law in sizes if law != "const" and n >= LARGE)
    total = sum(n for n, law in sizes if law != "const")
    assert large >= 0.95 * total
