"""`models/gps.py` of the port against `escgnn_tpu/models/gps.py`, on the
CPU: every global model (transformer with and without the SPD bias,
BigBird, Graphormer, linear, FAVOR+ with JAX's projection loaded, SAN,
SAN2), every local model (GINE, GatedGCN, PNA), every node and edge
encoder (embed, linear, ogb_atom / ogb_bond, ppa_uniform, ast, none;
LapPE, SignNet, RWSE, degree, EquivStable) and the link head, each on
the width and on the uniform + dedup layout, at 16 x 2 with 2 heads.

Each case featurizes numpy-seeded synthetic graphs with both packages
(ESC h 2, the SPD bias, LapPE and RWSE k 4, degree), batches 3 graphs
into a 4-graph spec (one empty graph slot, so padding graphs and their
out-of-range node slots are in every case), draws the flax variables
with numpy (`numpy_variables`) and carries them across with
`weights.load_flax_variables` (strict). Held: the eval-mode output,
every row, padding rows included, at rtol/atol 1e-5 of its largest
entry; the train-mode loss (batch statistics) at rtol 1e-5; each
parameter's gradient at 1e-4 of its norm (a gradient that is rounding
noise on JAX's side, its norm under 1e-4 of the largest gradient norm,
must be under that bound here too). The captured dense-attention
weights equal JAX's `intermediates`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import escgnn_tpu.train.loop as jloop
from escgnn_tpu.data.batching import BatchSpec as JBatchSpec
from escgnn_tpu.data.batching import pad_and_batch as j_pad_and_batch
from escgnn_tpu.data.contact import synthetic_contact as j_synthetic_contact
from escgnn_tpu.data.counting import CountingDatasetConfig as JCountingCfg
from escgnn_tpu.data.counting import generate_counting_graphs as j_counting
from escgnn_tpu.data import molecules as jmol
from escgnn_tpu.featurize import posenc as jposenc
from escgnn_tpu.featurize.escgnn import EscConfig as JEscConfig
from escgnn_tpu.featurize.spd import attach_attn_bias as j_attach_attn_bias
from escgnn_tpu.featurize.transform import featurize_many as j_featurize_many
from escgnn_tpu.models.gps import GPSConfig as JGPSConfig
from escgnn_tpu.models.gps import GPSModel as JGPSModel
from escgnn_tpu.models.gps import _favor_projection
from escgnn_tpu.train.metrics import link_pair_loss as j_link_pair_loss
import escgnn_tpu_torch.train.loop as loop
from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.data.contact import synthetic_contact
from escgnn_tpu_torch.data.counting import (
    CountingDatasetConfig,
    generate_counting_graphs,
)
from escgnn_tpu_torch.data import molecules
from escgnn_tpu_torch.featurize import posenc
from escgnn_tpu_torch.featurize.escgnn import EscConfig
from escgnn_tpu_torch.featurize.spd import attach_attn_bias
from escgnn_tpu_torch.featurize.transform import featurize_many
from escgnn_tpu_torch.models.gps import GPSConfig, GPSModel
from escgnn_tpu_torch.train.metrics import link_pair_loss
from escgnn_tpu_torch.weights import flax_to_state_dict, load_flax_variables
from tests.test_torch_port_zoo import jax_run, numpy_variables

BS = 3
K = 4  # LapPE / RWSE width
WIDTH = dict(dim_h=16, num_layers=2, num_heads=2)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _raw(kind: str, pkg: str):
    """`BS` + 1 raw graphs of a data kind from one package's generators
    (bit-equal across packages)."""
    mol = molecules if pkg == "torch" else jmol
    n = BS + 1
    if kind in ("zinc", "ast"):
        gs = mol.synthetic_zinc(n, seed=1)
        if kind == "ast":  # (type, depth) node columns
            for g in gs:
                g.x = np.concatenate(
                    [g.x, np.arange(g.num_nodes)[:, None] % 25],
                    axis=1).astype(np.int32)
        return gs
    if kind == "ogb":
        return mol.synthetic_ogb_mol(n, seed=2, num_tasks=2)
    if kind == "ppa":
        return mol.synthetic_ppa(n, seed=3)
    if kind == "count":
        cfg_cls, gen = ((CountingDatasetConfig, generate_counting_graphs)
                        if pkg == "torch" else (JCountingCfg, j_counting))
        gs = gen(cfg_cls(num_graphs=12, seed=4))["train"][:n]
        # the counting graphs' x is all ones, which leaves the first
        # BatchNorm a zero batch variance whose rounding residue the two
        # packages round apart (the counting driver parity's 3e-3): the
        # linear encoder reads numpy-seeded features instead
        rng = np.random.default_rng(4)
        for g in gs:
            g.y = np.asarray(g.y, np.float32)[:, :1]
            g.x = rng.normal(size=g.x.shape).astype(np.float32)
        return gs
    assert kind == "link"
    return (synthetic_contact if pkg == "torch" else j_synthetic_contact)(
        n, seed=5)


def _prep(graphs, pkg: str):
    if pkg == "torch":
        fm, ab, pe, esc = featurize_many, attach_attn_bias, posenc, EscConfig
    else:
        fm, ab, pe, esc = (j_featurize_many, j_attach_attn_bias, jposenc,
                           JEscConfig)
    return [pe.attach_degree(pe.attach_rwse(pe.attach_lap_pe(ab(g), k=K),
                                            k=K))
            for g in fm(graphs, esc(h=2))]


_BATCHES = {}


def _batches(kind: str, layout: str):
    """(JAX batch, port batch, port graphs): `BS` graphs in a spec sized
    for `BS` + 1, so the last graph slot is empty."""
    key = (kind, layout)
    if key not in _BATCHES:
        tg, jg = _prep(_raw(kind, "torch"), "torch"), _prep(_raw(kind, "jax"),
                                                           "jax")
        if layout == "width":
            spec = BatchSpec.from_graphs(tg, BS + 1)
            jspec = JBatchSpec.from_graphs(jg, BS + 1)
        else:
            spec = BatchSpec.uniform(tg, BS + 1, enc_layout="dedup")
            jspec = JBatchSpec.uniform(jg, BS + 1, enc_layout="dedup")
        jb = jax.tree.map(jnp.asarray, j_pad_and_batch(jg[:BS], jspec))
        tb = pad_and_batch(tg[:BS], spec, device="cpu")
        _BATCHES[key] = (jb, tb, tg)
    return _BATCHES[key]


# name: (data kind, GPSConfig fields, loss)
CASES = {
    "transformer_bias": ("zinc", dict(use_attn_bias=True), "l1"),
    "transformer_no_bias": ("zinc", dict(use_attn_bias=False), "l1"),
    "bigbird_pna": ("zinc", dict(global_model="bigbird", local_model="pna",
                                 avg_deg_log=1.3), "l1"),
    "graphormer_degree": ("zinc", dict(global_model="graphormer",
                                       use_degree=True), "l1"),
    "gatedgcn_linear_lappe_rwse": ("zinc", dict(
        local_model="gatedgcn", global_model="linear", use_lap_pe=True,
        use_rwse=True), "l1"),
    "gatedgcn_san": ("zinc", dict(local_model="gatedgcn",
                                  global_model="san"), "l1"),
    "san2": ("zinc", dict(global_model="san2"), "l1"),
    "performer": ("zinc", dict(global_model="performer"), "l1"),
    "equivstable": ("zinc", dict(local_model="gatedgcn",
                                 use_equivstable_pe=True,
                                 use_attn_bias=True), "l1"),
    "signnet": ("zinc", dict(use_signnet=True, pool="mean"), "l1"),
    "enc_ogb_atom_bond": ("ogb", dict(node_encoder_kind="ogb_atom",
                                      edge_encoder_kind="ogb_bond",
                                      out_dim=2), "bce"),
    "enc_ppa_uniform_linear": ("ppa", dict(node_encoder_kind="ppa_uniform",
                                           edge_encoder_kind="linear",
                                           out_dim=37, pool="mean"), "ce"),
    "enc_linear_none_node_level": ("count", dict(
        node_encoder_kind="linear", edge_encoder_kind="none",
        graph_pred=False), "l1_node"),
    "enc_ast": ("ast", dict(node_encoder_kind="ast"), "l1"),
    "link_head": ("link", dict(node_encoder_kind="ogb_atom",
                               edge_encoder_kind="ogb_bond",
                               head="inductive_edge"), "link"),
}
LOSSES = {
    "l1": (jloop.l1_graph_loss, loop.l1_graph_loss),
    "l1_node": (jloop.l1_node_loss, loop.l1_node_loss),
    "bce": (jloop.bce_graph_loss, loop.bce_graph_loss),
    "ce": (jloop.ce_graph_loss, loop.ce_graph_loss),
    "link": (j_link_pair_loss, link_pair_loss),
}
LAYOUTS = ("width", "uniform_dedup")


def _widths(graphs) -> dict:
    from escgnn_tpu_torch.run_gps import _width

    g = graphs[0]
    return dict(node_dim=_width(g.x, g.num_nodes),
                edge_dim=_width(g.edge_attr, g.num_edges), lap_k=K,
                rwse_k=K)


def _constants(fields) -> dict:
    """JAX's FAVOR+ projection for every layer of a performer model."""
    if fields.get("global_model") != "performer":
        return {}
    W = np.asarray(_favor_projection(64, WIDTH["dim_h"] // WIDTH["num_heads"]))
    return {f"layer{i}.self_attn.favor_proj": W
            for i in range(WIDTH["num_layers"])}


def _port_model(name, layout):
    kind, fields, _ = CASES[name]
    jb, tb, tg = _batches(kind, layout)
    jm = JGPSModel(JGPSConfig(**WIDTH, **fields))
    v = numpy_variables(jm, jb)
    stats = v.get("batch_stats", {})
    m = GPSModel(GPSConfig(**WIDTH, **fields), device="cpu", **_widths(tg))
    load_flax_variables(m, v["params"], stats, _constants(fields))
    return jm, v, stats, m, jb, tb


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", list(CASES))
def test_gps_variant_matches_jax(name, layout):
    jm, v, stats, m, jb, tb = _port_model(name, layout)
    j_loss, t_loss = LOSSES[CASES[name][2]]

    def run(params, batch):
        eval_out = jm.apply({"params": params, "batch_stats": stats}, batch)

        def loss(p):
            out, _ = jm.apply({"params": p, "batch_stats": stats}, batch,
                              deterministic=True, use_running_average=False,
                              mutable=["batch_stats"])
            return j_loss(out, batch)

        return (eval_out,) + jax.value_and_grad(loss)(params)

    want, want_loss, jgrads = jax_run(run, v["params"], jb)
    want = np.asarray(want)
    m.eval()
    with torch.no_grad():
        got = m(tb).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5,
                               atol=1e-5)
    m.train()
    loss = t_loss(m(tb), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_g = flax_to_state_dict(jax.tree.map(np.asarray, jgrads), {})
    got_g = {k: p.grad for k, p in m.named_parameters()}
    assert set(want_g) == set(got_g)
    norms = {k: float(np.linalg.norm(w.numpy())) for k, w in want_g.items()}
    noise = 1e-4 * max(norms.values())
    for k, w in want_g.items():
        g = (got_g[k] if got_g[k] is not None
             else torch.zeros_like(w)).numpy()
        if norms[k] < noise:
            assert float(np.linalg.norm(g)) < noise, k
            continue
        assert np.linalg.norm(g - w.numpy()) <= 1e-4 * norms[k], k


def test_cases_cover_every_model_and_encoder():
    """The cases hold every global and local model, every node and edge
    encoder kind, every positional encoder and both heads."""
    fields = [f for _, f, _ in CASES.values()]
    seen = lambda key, default: {f.get(key, default) for f in fields}  # noqa
    from escgnn_tpu_torch.models.gps import (
        EDGE_ENCODERS,
        GLOBAL_MODELS,
        LOCAL_MODELS,
        NODE_ENCODERS,
    )

    assert seen("global_model", "transformer") == set(GLOBAL_MODELS)
    assert seen("local_model", "gine") == set(LOCAL_MODELS)
    assert seen("node_encoder_kind", "embed") == set(NODE_ENCODERS)
    assert seen("edge_encoder_kind", "embed") == set(EDGE_ENCODERS)
    assert seen("head", "default") == {"default", "inductive_edge"}
    for flag in ("use_lap_pe", "use_signnet", "use_rwse", "use_degree",
                 "use_equivstable_pe", "use_attn_bias"):
        assert True in seen(flag, False), flag


@pytest.mark.parametrize("name", ["transformer_bias", "graphormer_degree"])
def test_attention_capture_and_padding_graph(name):
    """The weights `forward(..., return_attention=True)` returns equal
    JAX's sown `intermediates` (every (G, heads, M, M) entry, the empty
    graph slot's uniform rows included), and the empty graph's output row
    is finite and JAX's."""
    jm, v, stats, m, jb, tb = _port_model(name, "width")

    def run(params, batch):
        return jm.apply({"params": params, "batch_stats": stats}, batch,
                        mutable=["intermediates"])

    out, inter = jax_run(run, v["params"], jb)
    m.eval()
    with torch.no_grad():
        got, weights = m(tb, return_attention=True)
    assert sorted(weights) == ["layer0/self_attn", "layer1/self_attn"]
    for key, w in weights.items():
        layer, mod = key.split("/")
        want = np.asarray(inter["intermediates"][layer][mod]["attn_weights"][0])
        assert w.shape == want.shape
        np.testing.assert_allclose(w.numpy(), want, rtol=1e-5, atol=1e-6)
        # the empty graph slot: every row a finite uniform softmax
        np.testing.assert_allclose(w[BS].numpy(), 1.0 / want.shape[-1],
                                   rtol=1e-6)
    assert not m.layer0.self_attn.capture and m.layer0.self_attn.last_attn \
        is None
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5 * float(np.abs(out).max()))
    assert np.isfinite(got[BS].numpy()).all()
