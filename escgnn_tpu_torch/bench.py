"""Train-step throughput of the model zoo on one card (the twin of the
repository's `bench.py`):

    python -m escgnn_tpu_torch.bench [--device cuda]

Runs `bench.py`'s ten lines in its order: the PPGN_eff counting step,
GPS on ZINC, OgbGNN on molhiv, I2GNN, NGNN and NestedPPGN on their
subgraph copies, GINE+, the k123 k-GNN and GPS on peptides, then the
flagship NestedGIN_eff last. Each line is one batch of `bench.py`'s
synthetic graphs under its spec, model config and loss (`bench_lines`,
one `BenchLine` per metric name: the table the tests and `chip_smoke.py`
read too). A line takes one eager train step (the JAX bench's first
step), then runs `n_iter` train steps of that batch per window through
the graphed pool step (`train/loop.py` `make_pool_train_step`: on a CUDA
device one step captured into a CUDA graph, replayed per step): one warm
window, then `windows` timed ones (3; the flagship 5), the window's loss
read back once at its end. It prints one JSON line per line, with
`bench.py`'s fields (`perf_fields`, its rounding too) and `device`.

Environment, as in `bench.py`: `BENCH_SMOKE=1` shrinks the graph counts
and windows (a wiring check), `BENCH_ONLY=flagship` runs the flagship
line alone, `BENCH_PROFILE_DIR=DIR` runs one more flagship window under
`torch.profiler` after the timing and writes its trace into DIR.

The costs are `bench.py`'s, counted by `utils/cost.py` (`count_cost`)
over one eager train step (forward, backward and the optimizer update)
on a copy of the line's model and optimizer:
  * `flops_per_step` charges every aten op by the rule XLA's
    `cost_analysis` applies to it (matmuls, elementwise work, reductions,
    gathers and scatters, Adam), and each hand kernel (K1-K4) the FLOPs of
    its plain version, whichever version runs; XLA gives a Pallas call 0;
  * `bytes_per_step` charges each kernel's operands read once and its
    outputs written once, `hbm.py`'s rule at fusion boundaries. An eager
    step, and the CUDA graph captured from it, has no fusion: every
    non-view op is its own kernel, so `bytes_per_step_opcount` (XLA's
    per-op sum) equals `bytes_per_step`, and bytes that stay in the
    card's L2 are charged as if they went to HBM;
  * `bytes_per_step_scanbody`, which `hbm_bw_frac` reads, adds the copies
    the graphed pool step makes before each replay (`pool_load_bytes`),
    the part of a timed step outside the counted one;
  * integer index converts, fills and the index arithmetic of gathers
    count no FLOP, where XLA counts some (see `utils/cost.py`).

Where the twin differs from `bench.py` otherwise:
  * `mfu` divides by the card's dense bf16 peak (`PEAK_BF16_FLOPS`) and
    `hbm_bw_frac` by its HBM rate (`PEAK_HBM_BYTES_PER_S`), by
    `torch.cuda.get_device_name()`; both are null on the CPU and on cards
    not in the tables;
  * `vs_baseline` (and the flagship's `vs_r01`) are null: `bench.py`'s
    denominators are measurements of another chip;
  * `device` is `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` for the card, or "cpu".

The graph sets are built before the first CUDA call, their featurizers
forked (`featurize_many`, 8 workers, as `bench.py`). The CPU runs only
with `--device cpu`; without a card the default raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import time
from typing import Callable, Optional

import numpy as np
import torch

from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.data.container import GraphBatch, GraphData
from escgnn_tpu_torch.data.prefetch import stack_batches
from escgnn_tpu_torch.data.uniform_copies import (
    bucketize_copy_batch,
    choose_bucket_sizes,
    uniformize_dataset,
)
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.train.loop import (
    adam_with_plateau,
    bce_graph_loss,
    l1_graph_loss,
    l1_node_loss,
    make_pool_train_step,
    train_step,
)
from escgnn_tpu_torch.utils.cost import StepCost, count_cost, pool_load_bytes

# the metric names, in bench.py's order (the keys of its ROUND4_MEASURED)
PPGN = "counting_ppgn_eff_trainstep_edges_per_s_per_chip"
GPS_ZINC = "zinc_gps_trainstep_edges_per_s_per_chip"
OGB = "molhiv_ogbgnn_trainstep_edges_per_s_per_chip"
I2GNN = "zinc_i2gnn_trainstep_copyedges_per_s_per_chip"
NGNN = "zinc_ngnn_trainstep_copyedges_per_s_per_chip"
NESTED_PPGN = "zinc_nestedppgn_trainstep_copyedges_per_s_per_chip"
GINE_PLUS = "molhiv_gineplus_trainstep_edges_per_s_per_chip"
K123 = "qm9_k123gnn_trainstep_copyedges_per_s_per_chip"
GPS_PEP = "pepstruct_gps_trainstep_edges_per_s_per_chip"
FLAGSHIP = "zinc_nestedgin_eff_trainstep_edges_per_s_per_chip"
METRICS = (PPGN, GPS_ZINC, OGB, I2GNN, NGNN, NESTED_PPGN, GINE_PLUS, K123,
           GPS_PEP, FLAGSHIP)

LR = 5e-4

# dense bf16 FLOP/s and HBM bytes/s of one card (NVIDIA's data sheets),
# by a part of `torch.cuda.get_device_name()`: "NVIDIA H100 80GB HBM3" is
# the SXM5 part. MFU is null on a card not listed here, and on the CPU
PEAK_BF16_FLOPS = {"H100 80GB HBM3": 989.4e12, "H100 PCIe": 756e12}
PEAK_HBM_BYTES_PER_S = {"H100 80GB HBM3": 3.35e12, "H100 PCIe": 2.0e12}


def _peak(table: dict, name: Optional[str]) -> Optional[float]:
    if not name:
        return None
    for part, value in table.items():
        if part.lower() in name.lower():
            return value
    return None


def peak_bf16_flops(name: Optional[str]) -> Optional[float]:
    """The dense bf16 peak of the card named `name` (None: the CPU)."""
    return _peak(PEAK_BF16_FLOPS, name)


def peak_hbm_bytes_per_s(name: Optional[str]) -> Optional[float]:
    return _peak(PEAK_HBM_BYTES_PER_S, name)


def device_name(device: torch.device) -> Optional[str]:
    """`torch.cuda.get_device_name` of a CUDA device; None for the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_name(device)


def device_tag(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reads them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the graph generators (bench.py:130-292): the same numpy draws, so the
# same graphs as the JAX package's for the same num and seed
# ---------------------------------------------------------------------------


def _raw_zinc_graphs(num, seed):
    """ZINC-subset-shaped synthetic molecules: ~23 heavy atoms, sparse
    bonds, 28 node types, 4 edge types (dataset stats of ZINC-12k)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(num):
        n = int(rng.integers(18, 30))
        a = np.arange(n - 1)
        extra = max(2, n // 6)
        c1 = rng.integers(0, n, extra)
        c2 = (c1 + rng.integers(2, 5, extra)) % n
        src = np.concatenate([a, c1])
        dst = np.concatenate([a + 1, c2])
        keep = src != dst
        src, dst = src[keep], dst[keep]
        ei = np.stack(
            [np.concatenate([src, dst]), np.concatenate([dst, src])]
        ).astype(np.int32)
        graphs.append(GraphData(
            num_nodes=n,
            edge_index=ei,
            x=rng.integers(0, 28, n).astype(np.int32)[:, None],
            edge_attr=rng.integers(1, 4, ei.shape[1]).astype(np.int32),
            y=rng.normal(size=(1,)).astype(np.float32),
        ))
    return graphs


def make_zinc_like_graphs(num=128, seed=0, h=3, num_workers=8):
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many

    cfg = EscConfig(h=h, use_rd=True, self_loop=True)
    return featurize_many(_raw_zinc_graphs(num, seed), cfg,
                          num_workers=num_workers)


def make_i2gnn_graphs(num=16, seed=0, h=2):
    """Pair-subgraph (I2GNN) copies of small molecule-shaped graphs;
    edges/s is reported on the copy union."""
    from escgnn_tpu_torch.featurize.pair_subgraphs import (
        PairSubgraphConfig,
        create_pair_subgraphs,
    )

    pcfg = PairSubgraphConfig(h=h, use_rd=True)
    return [create_pair_subgraphs(g, pcfg)
            for g in _raw_zinc_graphs(num, seed)]


def make_ngnn_graphs(num=16, seed=0, h=3, orig_adj=False):
    """Node-subgraph (NGNN) copies of ZINC-shaped graphs; with
    `orig_adj`, the original adjacency too (NestedPPGN's dense stack)."""
    from escgnn_tpu_torch.featurize.node_subgraphs import (
        NodeSubgraphConfig,
        create_node_subgraphs,
    )

    scfg = NodeSubgraphConfig(h=h, use_rd=True, keep_orig_adj=orig_adj)
    return [create_node_subgraphs(g, scfg)
            for g in _raw_zinc_graphs(num, seed)]


def make_ginep_graphs(num=32, seed=0, k=3):
    """Multihop-edge graphs of synthetic OGB molecules (GINE+)."""
    from escgnn_tpu_torch.data.molecules import synthetic_ogb_mol
    from escgnn_tpu_torch.featurize.multihop import make_multihop_edges

    return [make_multihop_edges(g, k=k)
            for g in synthetic_ogb_mol(num_graphs=num, seed=seed,
                                       num_tasks=1)]


def make_kgnn_graphs(num=16, seed=0, h=3):
    """QM9-shaped graphs with distance edge attrs, node copies and 2-/3-
    set graphs (the k123 stack)."""
    from escgnn_tpu_torch.data.qm9 import (
        append_distance_edge_attr,
        synthetic_qm9,
    )
    from escgnn_tpu_torch.featurize.kset import attach_kset_graphs
    from escgnn_tpu_torch.featurize.node_subgraphs import (
        NodeSubgraphConfig,
        create_node_subgraphs,
    )

    scfg = NodeSubgraphConfig(h=h, use_rd=True)
    out = []
    for g in synthetic_qm9(num_graphs=num, seed=seed):
        g.y = np.asarray(g.y)[:1]
        g = append_distance_edge_attr(g)
        out.append(attach_kset_graphs(
            create_node_subgraphs(g, scfg), ks=(2, 3), malkin=True))
    return out


def make_pep_graphs(num=16, seed=0, num_workers=8):
    """Peptides-struct-shaped graphs (~150 nodes, chain-like backbone)
    with ESC features and the all-pairs SPD attention bias."""
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many
    from escgnn_tpu_torch.featurize.spd import attach_attn_bias

    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(num):
        n = int(rng.integers(120, 160))
        a = np.arange(n - 1)
        extra = n // 4
        c1 = rng.integers(0, n, extra)
        c2 = (c1 + rng.integers(2, 9, extra)) % n
        src = np.concatenate([a, c1])
        dst = np.concatenate([a + 1, c2])
        keep = src != dst
        src, dst = src[keep], dst[keep]
        ei = np.stack(
            [np.concatenate([src, dst]), np.concatenate([dst, src])]
        ).astype(np.int32)
        graphs.append(GraphData(
            num_nodes=n,
            edge_index=ei,
            x=rng.integers(0, 20, n).astype(np.int32)[:, None],
            edge_attr=rng.integers(1, 4, ei.shape[1]).astype(np.int32),
            y=rng.normal(size=(11,)).astype(np.float32),
        ))
    feats = featurize_many(graphs, EscConfig(h=2, use_rd=True,
                                             self_loop=True),
                           num_workers=num_workers)
    return [attach_attn_bias(g) for g in feats]


def make_counting_graphs(num=128, seed=0, num_workers=8):
    from escgnn_tpu_torch.data.counting import (
        CountingDatasetConfig,
        generate_counting_graphs,
    )
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many

    splits = generate_counting_graphs(
        CountingDatasetConfig(num_graphs=num, seed=seed))
    graphs = [g for s in splits.values() for g in s][:num]
    for g in graphs:
        g.y = g.y[:, :1]
    return featurize_many(graphs, EscConfig(h=2, use_rd=True,
                                            self_loop=True),
                          num_workers=num_workers)


def make_molhiv_like_graphs(num=32, seed=0, num_workers=8):
    from escgnn_tpu_torch.data.molecules import synthetic_ogb_mol
    from escgnn_tpu_torch.featurize import EscConfig, featurize_many

    graphs = synthetic_ogb_mol(num_graphs=num, seed=seed, num_tasks=1)
    return featurize_many(graphs, EscConfig(h=4, use_rd=True,
                                            self_loop=True),
                          num_workers=num_workers)


def make_gps_zinc_graphs(num=32, seed=0, num_workers=8):
    """The GPS ZINC line's graphs: ZINC-shaped molecules (h 3) with the
    SPD attention bias (bench.py:688-695)."""
    from escgnn_tpu_torch.featurize.spd import attach_attn_bias

    return [attach_attn_bias(g) for g in make_zinc_like_graphs(
        num=num, seed=seed, h=3, num_workers=num_workers)]


# each graph set: (generator, graphs at full size, graphs under
# BENCH_SMOKE, its own arguments); the keys are bench.py's `gsets` keys,
# and "zinc" is the flagship's
GRAPH_SETS = {
    "zinc": (make_zinc_like_graphs, 128, 16, {}),
    "counting": (make_counting_graphs, 128, 16, {}),
    "gps": (make_gps_zinc_graphs, 32, 8, {}),
    "ogb": (make_molhiv_like_graphs, 32, 8, {}),
    "i2": (make_i2gnn_graphs, 16, 4, {}),
    "ngnn": (make_ngnn_graphs, 16, 4, {}),
    "nppgn": (make_ngnn_graphs, 16, 4, dict(h=2, orig_adj=True)),
    "ginep": (make_ginep_graphs, 32, 8, {}),
    "kgnn": (make_kgnn_graphs, 16, 4, {}),
    "pep": (make_pep_graphs, 16, 2, {}),
}
# the graph set each line batches
LINE_SETS = {PPGN: "counting", GPS_ZINC: "gps", OGB: "ogb", I2GNN: "i2",
             NGNN: "ngnn", NESTED_PPGN: "nppgn", GINE_PLUS: "ginep",
             K123: "kgnn", GPS_PEP: "pep", FLAGSHIP: "zinc"}
# the generators that featurize, and so take a worker count
_FORKING = (make_zinc_like_graphs, make_counting_graphs,
            make_gps_zinc_graphs, make_molhiv_like_graphs, make_pep_graphs)


def make_graph_sets(metrics=METRICS, smoke: bool = False,
                    num_workers: int = 8) -> dict:
    """The graph sets the lines `metrics` batch, by `GRAPH_SETS` key, at
    full size or under BENCH_SMOKE. Build them before the first CUDA call
    of the process: the featurizers fork (a process holding a CUDA
    context may fork only children that touch no CUDA, as these do)."""
    out = {}
    for key in dict.fromkeys(LINE_SETS[m] for m in metrics):
        fn, full, small, kw = GRAPH_SETS[key]
        if fn in _FORKING:
            kw = dict(kw, num_workers=num_workers)
        out[key] = fn(num=small if smoke else full, **kw)
    return out


# ---------------------------------------------------------------------------
# the lines (bench.py:427-670)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BenchLine:
    """One bench line: the batch (`graphs` under `spec`, then
    `batch_transform`), the model (`model_cls(config, **model_kwargs)`:
    the input widths the port's models take at construction), its loss,
    the train steps per window and the windows, and the real edges one
    step covers (the copy lines': edges of the raw copy graphs)."""

    metric: str
    graphs: list
    spec: BatchSpec
    model_cls: type
    config: object
    loss_fn: Callable
    n_iter: int
    real_edges: int
    model_kwargs: dict = dataclasses.field(default_factory=dict)
    batch_transform: Optional[Callable] = None
    windows: int = 3

    def host_batch(self) -> GraphBatch:
        """The line's batch on the CPU."""
        batch = pad_and_batch(self.graphs, self.spec, device="cpu")
        if self.batch_transform is not None:
            batch = self.batch_transform(batch)
        return batch

    def model(self, device, generator: Optional[torch.Generator] = None):
        """The line's model on `device`, its weights drawn from
        `generator` (seed 0 when None)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return self.model_cls(self.config, device=device,
                              generator=generator, **self.model_kwargs)


def _edges(graphs) -> int:
    return int(np.sum([g.num_edges for g in graphs]))


def _columns(a, rows: int) -> int:
    return np.asarray(a).reshape(rows, -1).shape[1]


def flagship_spec(graphs) -> BatchSpec:
    """The flagship batch spec: uniform per-graph blocks and dedup ESC
    rows, one batch of every graph."""
    return BatchSpec.uniform(graphs, len(graphs), enc_layout="dedup")


def flagship_config():
    """The flagship model config: NestedGIN_eff 256 x 5 with bf16 conv
    stacks (f32 parameters, loss and accumulation)."""
    from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEffConfig

    return NestedGINEffConfig(
        hidden=256, num_layers=5, dropout=0.0, act="elu", graph_pred=True,
        pool="add", use_x_embedding_jk=False, head_order="dropout_act",
        node_embed_vocab=100, node_embed_dim=32, edge_embed_vocab=100,
        edge_embed_dim=32, compute_dtype="bfloat16")


def _flagship(graphs, smoke):
    from escgnn_tpu_torch.models.nested_gin_eff import NestedGINEff

    return BenchLine(FLAGSHIP, graphs, flagship_spec(graphs), NestedGINEff,
                     flagship_config(), l1_graph_loss,
                     20 if smoke else 400, _edges(graphs), windows=5)


def _ppgn(graphs, smoke):
    from escgnn_tpu_torch.models import ppgn

    spec = BatchSpec.from_graphs(graphs, batch_size=len(graphs))
    # the z impl and the node pool keep their defaults ("countmat",
    # pool_impl "xla"), as bench.py's line does: no port kernel runs
    cfg = ppgn.PPGNConfig(emb_dim=128, num_rb_layers=3,
                          max_nodes=spec.max_nodes_per_graph,
                          node_level=True, use_esc=True,
                          compute_dtype="bfloat16")
    return BenchLine(PPGN, graphs, spec, ppgn.PPGN, cfg, l1_node_loss,
                     5 if smoke else 50, _edges(graphs))


def _gps(metric, graphs, smoke):
    from escgnn_tpu_torch.models.gps import GPSConfig, GPSModel

    spec = BatchSpec.uniform(graphs, batch_size=len(graphs),
                             enc_layout="dedup")
    if metric == GPS_ZINC:
        cfg = GPSConfig(dim_h=64, num_layers=4, num_heads=4, use_esc=True,
                        use_attn_bias=True, pool="add", out_dim=1)
        n_iter = 10 if smoke else 100
    else:
        cfg = GPSConfig(dim_h=96, num_layers=10, num_heads=4, use_esc=True,
                        use_attn_bias=True, pool="mean", out_dim=11)
        n_iter = 5 if smoke else 50
    return BenchLine(metric, graphs, spec, GPSModel, cfg, l1_graph_loss,
                     n_iter, _edges(graphs))


def _ogb(graphs, smoke):
    from escgnn_tpu_torch.models.ogb_gnn import OgbGNN, OgbGNNConfig

    spec = BatchSpec.uniform(graphs, batch_size=len(graphs),
                             enc_layout="dedup")
    cfg = OgbGNNConfig(num_tasks=1, num_layers=6, emb_dim=300, dropout=0.0,
                       virtual_node=True, compute_dtype="bfloat16")
    return BenchLine(OGB, graphs, spec, OgbGNN, cfg, bce_graph_loss,
                     10 if smoke else 100, _edges(graphs))


def _copies(metric, raw, smoke):
    """I2GNN and NGNN: uniform per-copy blocks of the whole set
    (`copy_uniform(exact=True)`), re-laid into the two-size bucketed
    blocks of `choose_bucket_sizes`; edges/s on the raw copy graphs."""
    n_s, e_s = choose_bucket_sizes(raw)
    graphs = uniformize_dataset(raw)
    spec = BatchSpec.copy_uniform(graphs, batch_size=len(graphs),
                                  exact=True)
    if metric == I2GNN:
        from escgnn_tpu_torch.models.i2gnn import I2GNN as cls
        from escgnn_tpu_torch.models.i2gnn import I2GNNConfig

        cfg = I2GNNConfig(num_layers=3, hidden=64, use_rd=True,
                          subgraph2_pooling="mean-center-side", gate=True,
                          out_dim=1, compute_dtype="bfloat16")
    else:
        from escgnn_tpu_torch.models.ngnn import NGNN as cls
        from escgnn_tpu_torch.models.ngnn import NGNNConfig

        cfg = NGNNConfig(num_layers=5, hidden=64, use_rd=True, out_dim=1,
                         compute_dtype="bfloat16")
    return BenchLine(
        metric, graphs, spec, cls, cfg, l1_graph_loss, 5 if smoke else 50,
        _edges(raw), batch_transform=functools.partial(
            bucketize_copy_batch, n_s=n_s, e_s=e_s))


def _nested_ppgn(graphs, smoke):
    from escgnn_tpu_torch.models.nested_ppgn import (
        NestedPPGN,
        NestedPPGNConfig,
    )

    spec = BatchSpec.from_graphs(graphs, batch_size=len(graphs))
    max_sub = 1
    for g in graphs:
        seg = np.asarray(g.extras["node_to_subgraph"])
        max_sub = max(max_sub, int(np.bincount(seg).max()))
    cfg = NestedPPGNConfig(
        emb_dim=64, num_rb_layers=2, num_tasks=1, use_rd=True,
        max_nodes_per_subgraph=max_sub, classify=False,
        compute_dtype="bfloat16")
    g0 = graphs[0]
    widths = dict(in_dim=_columns(g0.x, g0.num_nodes),
                  edge_dim=_columns(g0.edge_attr, g0.num_edges))
    return BenchLine(NESTED_PPGN, graphs, spec, NestedPPGN, cfg,
                     l1_graph_loss, 5 if smoke else 50, _edges(graphs),
                     model_kwargs=widths)


def _gine_plus(graphs, smoke):
    from escgnn_tpu_torch.models.gine_plus import (
        GINEPlusConfig,
        GINEPlusNetwork,
    )

    spec = BatchSpec.uniform(graphs, batch_size=len(graphs))
    cfg = GINEPlusConfig(hidden=100, out_dim=1, num_layers=6, dropout=0.0,
                         k=3, virtual_node=True, compute_dtype="bfloat16")
    return BenchLine(GINE_PLUS, graphs, spec, GINEPlusNetwork, cfg,
                     bce_graph_loss, 10 if smoke else 100, _edges(graphs))


def _k123(graphs, smoke):
    from escgnn_tpu_torch.models.kgnn_models import KGNN, KGNNConfig

    spec = BatchSpec.from_graphs(graphs, batch_size=len(graphs))
    cfg = KGNNConfig(levels=(2, 3), use_rd=True, use_pos=True, nested=True,
                     out_dim=1)
    g0 = graphs[0]
    # the flax model reads its input widths (and whether `pos` is there
    # to concatenate) from the batch; the copy transform drops `pos`
    widths = dict(x_dim=_columns(g0.x, g0.num_nodes),
                  edge_dim=_columns(g0.edge_attr, g0.num_edges),
                  has_pos=g0.pos is not None)
    return BenchLine(K123, graphs, spec, KGNN, cfg, l1_graph_loss,
                     5 if smoke else 50, _edges(graphs), model_kwargs=widths)


# each line's builder: (its graphs, smoke) -> BenchLine
_BUILDERS = {
    PPGN: _ppgn,
    GPS_ZINC: functools.partial(_gps, GPS_ZINC),
    OGB: _ogb,
    I2GNN: functools.partial(_copies, I2GNN),
    NGNN: functools.partial(_copies, NGNN),
    NESTED_PPGN: _nested_ppgn,
    GINE_PLUS: _gine_plus,
    K123: _k123,
    GPS_PEP: functools.partial(_gps, GPS_PEP),
    FLAGSHIP: _flagship,
}


def bench_line(metric: str, gsets: dict, smoke: bool = False) -> BenchLine:
    """The line `metric` on its graph set from `gsets` (`make_graph_sets`)."""
    if metric not in _BUILDERS:
        raise ValueError(f"unknown bench metric {metric!r}")
    return _BUILDERS[metric](gsets[LINE_SETS[metric]], smoke)


def bench_lines(gsets: dict, smoke: bool = False,
                metrics=METRICS) -> list:
    """The lines `metrics` (all ten by default, bench.py's order)."""
    return [bench_line(m, gsets, smoke) for m in metrics]


# ---------------------------------------------------------------------------
# costs, timing and the printed fields
# ---------------------------------------------------------------------------


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scan_time(model, opt, pool: GraphBatch, loss_fn, n_iter: int,
              windows: int = 3) -> tuple:
    """The pool step over `pool` (one batch) run as windows of `n_iter`
    steps: one warm window, then `windows` timed ones. Each window is a
    synchronize, the clock, the window's steps and the read of its losses
    (the one wait), the clock. Returns (window seconds, each window's
    losses with the warm one first, the pool step)."""
    device = pool.graph_mask.device
    step = make_pool_train_step(model, opt, loss_fn, pool)
    order = [0] * n_iter
    losses = [step(pool, order).tolist()]
    times = []
    for _ in range(windows):
        _synchronize(device)
        t0 = time.perf_counter()
        losses.append(step(pool, order).tolist())
        times.append(time.perf_counter() - t0)
    return times, losses, step


def perf_fields(times, n_iter, real_edges, fps, peak, bps=None, bw=None,
                bps_opcount=None, bps_scanbody=None):
    """edges/s, step time, MFU and the roofline fields of a line, as
    `bench.py`'s `perf_fields` computes and rounds them. `roofline_frac`
    is the larger of MFU and the bandwidth share (from `bps_scanbody`,
    else `bps`); without bytes it is MFU."""
    mean_t = float(np.mean(times))
    std_t = float(np.std(times))
    ms = mean_t / n_iter * 1e3
    step_s = mean_t / n_iter
    mfu = round(fps / step_s / peak, 4) if fps and peak else None
    bw_bytes = bps_scanbody if bps_scanbody else bps
    bw_frac = round(bw_bytes / step_s / bw, 4) if bw_bytes and bw else None
    bw_frac_source = (
        "scanbody" if bps_scanbody else ("entry" if bps else None)
    )
    fields = {
        "value": round(real_edges * n_iter / mean_t, 1),
        "value_best": round(real_edges * n_iter / min(times), 1),
        "value_std": round(
            real_edges * n_iter / mean_t * (std_t / mean_t), 1
        ),
        "ms_per_step": round(ms, 4),
        "ms_per_step_std": round(std_t / n_iter * 1e3, 4),
        "windows": len(times),
        "flops_per_step": fps,
        "mfu": mfu,
        "bytes_per_step": bps,
        "bytes_per_step_opcount": bps_opcount,
        "bytes_per_step_scanbody": bps_scanbody,
        "hbm_bw_frac": bw_frac,
        "bw_frac_source": bw_frac_source,
    }
    if mfu is not None or bw_frac is not None:
        m, b = mfu or 0.0, bw_frac or 0.0
        fields["roofline_frac"] = max(m, b)
        fields["binding_resource"] = "flops" if m >= b else "hbm_bw"
    else:
        fields["roofline_frac"] = None
        fields["binding_resource"] = None
    return fields


@dataclasses.dataclass
class LineResult:
    """A line's printed fields and the losses behind them: the first
    eager step's, the eager step the cost count ran (from the state the
    pool step starts in) and each window's (the warm one first); and that
    step's count (`utils/cost.py` `StepCost`)."""

    fields: dict
    first_loss: float
    eager_loss: float
    window_losses: list
    cost: StepCost


def run_line(line: BenchLine, device: torch.device, tag: str,
             profile_dir: Optional[str] = None) -> LineResult:
    """Time one line on `device` and return its JSON fields (`tag`: the
    `device` field). `profile_dir`: one more window under
    `torch.profiler` after the timing, its trace written there."""
    batch = line.host_batch().to(device)
    pool = stack_batches([batch])
    model = line.model(device)
    opt = adam_with_plateau(model.parameters(), LR,
                            capturable=device.type == "cuda")
    first = float(train_step(model, opt, batch, line.loss_fn))
    step_cost, eager = count_cost(model, opt, batch, line.loss_fn)
    times, losses, step = scan_time(model, opt, pool, line.loss_fn,
                                    line.n_iter, line.windows)
    if profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            step(pool, [0] * line.n_iter).tolist()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir,
                                              "bench_trace.json"))
    name = device_name(device)
    # no fusion: each op is its own boundary, so the per-op sum is the
    # boundary count; the pool step's copies before each replay come on top
    fields = dict(metric=line.metric, unit="edges/s", **perf_fields(
        times, line.n_iter, line.real_edges, step_cost.flops or None,
        peak_bf16_flops(name), bps=step_cost.bytes,
        bw=peak_hbm_bytes_per_s(name), bps_opcount=step_cost.bytes,
        bps_scanbody=step_cost.bytes + pool_load_bytes(pool)),
        vs_baseline=None)
    if line.metric == FLAGSHIP:
        fields["vs_r01"] = None
    fields["device"] = tag
    return LineResult(fields, first, eager, losses, step_cost)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


def main(argv=None) -> list:
    """Run the lines (BENCH_SMOKE, BENCH_ONLY, BENCH_PROFILE_DIR as in
    `bench.py`), print one JSON line each, flagship last, and return their
    `LineResult`s."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    smoke = os.environ.get("BENCH_SMOKE") == "1"
    metrics = ((FLAGSHIP,) if os.environ.get("BENCH_ONLY") == "flagship"
               else METRICS)
    profile_dir = os.environ.get("BENCH_PROFILE_DIR")
    # every graph set before the first CUDA call: the featurizers fork
    gsets = make_graph_sets(metrics, smoke)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tag = device_tag(device)
    results = []
    for line in bench_lines(gsets, smoke, metrics):
        res = run_line(line, device, tag,
                       profile_dir if line.metric == FLAGSHIP else None)
        print(json.dumps(res.fields), flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    main()
