#!/usr/bin/env python3
"""How far a 1e-7 weight perturbation carries through a few training
steps, in the JAX package and in the port, from the same weights, on
the CPU.

    JAX_PLATFORMS=cpu python tools/jax_perturbation_probe.py \
        [--models ginep,gps] [--draws 3] [--scale 1e-7] [--work DIR]

The protocol of `chip_smoke.py`'s `_perturbed_spread`, on both sides:
one membership pool of the train split (`stacked_batch_pools`, k 1, seed
0; the two packages' data and pools are equal), its batches in the
order `default_rng(0).permutation(steps)`, one eager Adam step per
batch (the driver's lr) from the initial weights and again from the
same weights times (1 + scale N(0, 1)). Both sides start from the JAX
model's initial weights (`model.init` at key 0), carried into the port
(`weights.load_flax_variables`), and take the same noise (numpy, seeded
by the draw), so the two packages run the same mathematics. Printed per
model, per step: |loss - loss'| / |loss| for each package and draw, and
the unperturbed runs' gap between the packages.

The models are the ones `chip_smoke.py` perturbs on the card:
  ginep  `run_ogb_mol --model GINEPlus` at its defaults (300 x 6, k 3,
         virtual node, batch 32, lr 1e-3, uniform blocks) at dropout 0,
         on 640 synthetic molecules with the triangle label: 16 steps
  gps    `run_gps --cfg configs/gps/zinc-GPS.yaml` (64 x 4, 4 heads,
         batch 32, the SPD bias): 512 synthetic graphs, 13 steps
Nothing is written outside `--work` (default results/perturbation_probe,
which holds the feature caches and JAX's compile cache).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPS_CFG = os.path.join(ROOT, "configs", "gps", "zinc-GPS.yaml")
GINEP_ARGV = ["--model", "GINEPlus", "--num_graphs", "640",
              "--synth_label", "tri", "--drop_ratio", "0"]


def perturbed(params, scale: float, draw: int):
    """`params` times (1 + scale N(0, 1)), the noise from numpy."""
    import jax
    import numpy as np

    noise = np.random.default_rng(draw)
    return jax.tree.map(
        lambda p: np.asarray(p) * (1 + scale * noise.standard_normal(
            np.shape(p))).astype(np.float32), params)


def jax_losses(model, variables, loss_fn, pool, order, lr):
    """Per-step losses of eager Adam steps over `pool` in `order`."""
    import jax
    import optax

    from escgnn_tpu.train.loop import adam_with_plateau

    tx = adam_with_plateau(lr)

    @jax.jit
    def step(params, stats, opt_state, batch):
        def compute(p):
            out, mut = model.apply(
                {"params": p, "batch_stats": stats}, batch,
                deterministic=False, use_running_average=False,
                mutable=["batch_stats"],
                rngs={"dropout": jax.random.key(1)})
            return loss_fn(out, batch), mut["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(compute, has_aux=True)(
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, loss

    params = jax.tree.map(jax.numpy.asarray, variables["params"])
    stats = variables.get("batch_stats", {})
    opt_state = tx.init(params)
    losses = []
    for j in order:
        batch = jax.tree.map(lambda x: x[int(j)], pool)
        params, stats, opt_state, loss = step(params, stats, opt_state,
                                              batch)
        losses.append(float(loss))
    return losses


def port_losses(model, variables, loss_fn, pool, order, lr):
    """The same steps on the port's model, its weights `variables`."""
    from escgnn_tpu_torch.data.prefetch import pool_entry
    from escgnn_tpu_torch.train.loop import adam_with_plateau, train_step
    from escgnn_tpu_torch.weights import load_flax_variables

    load_flax_variables(model, variables["params"],
                        variables.get("batch_stats", {}))
    opt = adam_with_plateau(model.parameters(), lr)
    return [float(train_step(model, opt, pool_entry(pool, int(j)), loss_fn))
            for j in order]


def spreads(jax_side, port_side, variables, scale, draws):
    """{'jax': per-step rel gaps per draw, 'port': the same, 'jax_vs_port':
    the unperturbed runs' per-step rel gap}; `*_side(variables)` gives
    one run's losses."""
    def rel(a, b):
        return [abs(x - y) / abs(x) for x, y in zip(a, b)]

    base = {"jax": jax_side(variables), "port": port_side(variables)}
    out = {"jax": [], "port": [],
           "jax_vs_port": rel(base["jax"], base["port"])}
    for draw in range(1, draws + 1):
        v = dict(variables, params=perturbed(variables["params"], scale,
                                             draw))
        out["jax"].append(rel(base["jax"], jax_side(v)))
        out["port"].append(rel(base["port"], port_side(v)))
    return out


def _pools(jax_train, jax_spec, port_train, port_spec):
    """The first membership pool of each package and the batch order."""
    import numpy as np

    from escgnn_tpu.data.prefetch import stacked_batch_pools as jax_pools
    from escgnn_tpu_torch.data.prefetch import stacked_batch_pools

    jpools, steps, _ = jax_pools(jax_train, jax_spec, k=1, seed=0)
    pools, psteps, _ = stacked_batch_pools(port_train, port_spec, k=1,
                                           seed=0, device="cpu")
    assert steps == psteps
    return jpools[0], pools[0], np.random.default_rng(0).permutation(steps)


def _init(model, train, spec):
    """The flax model's variables at key 0, as numpy arrays."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from escgnn_tpu.data.batching import batch_iterator

    b = jax.tree.map(jnp.asarray, next(batch_iterator(train[:2], spec)))
    return jax.tree.map(np.asarray, model.init(jax.random.key(0), b))


def ginep(work, scale, draws):
    """GINE+ at the OGB twin's defaults, dropout 0."""
    from escgnn_tpu.data.batching import BatchSpec as JSpec
    from escgnn_tpu.data.molecules import ogb_mol_splits
    from escgnn_tpu.featurize.multihop import make_multihop_edges
    from escgnn_tpu.models.gine_plus import GINEPlusConfig, GINEPlusNetwork
    from escgnn_tpu.train.metrics import masked_bce_with_logits
    from escgnn_tpu_torch import run_ogb_mol
    from escgnn_tpu_torch.train.loop import bce_graph_loss

    args = run_ogb_mol.build_parser().parse_args(
        GINEP_ARGV + ["--data_dir", os.path.join(work, "ogb_port")])
    raw, _ = ogb_mol_splits(os.path.join(work, "ogb_jax"), args.dataset,
                            num_graphs=args.num_graphs, seed=args.seed,
                            num_tasks=args.num_tasks,
                            label_kind=args.synth_label)
    jsplits = {k: [make_multihop_edges(g, k=args.multihop_k) for g in v]
               for k, v in raw.items()}
    jspec = JSpec.uniform([g for s in jsplits.values() for g in s],
                          batch_size=args.batch_size, enc_layout="width")
    model = GINEPlusNetwork(GINEPlusConfig(
        hidden=args.emb_dim, out_dim=args.num_tasks,
        num_layers=args.num_layer, dropout=0.0, k=args.multihop_k,
        virtual_node=True))
    splits = run_ogb_mol.build_splits(args)[0]
    spec = run_ogb_mol.build_spec(args, splits)
    jpool, pool, order = _pools(jsplits["train"], jspec, splits["train"],
                                spec)
    res = spreads(
        lambda v: jax_losses(model, v, masked_bce_with_logits, jpool, order,
                             args.lr),
        lambda v: port_losses(run_ogb_mol.build_model(args, "cpu"), v,
                              bce_graph_loss, pool, order, args.lr),
        _init(model, jsplits["train"], jspec), scale, draws)
    return res, dict(emb=args.emb_dim, layers=args.num_layer,
                     k=args.multihop_k, batch=args.batch_size,
                     train_graphs=len(splits["train"]))


def gps(work, scale, draws):
    """GPS on zinc-GPS.yaml."""
    import run_gps as jax_run_gps  # the JAX package's driver

    from escgnn_tpu.config import load_cfg as jax_load_cfg
    from escgnn_tpu.data.batching import BatchSpec as JSpec
    from escgnn_tpu.models.gps import GPSModel as JGPSModel
    from escgnn_tpu.train.loop import l1_graph_loss as jax_l1
    from escgnn_tpu_torch import run_gps
    from escgnn_tpu_torch.config import load_cfg
    from escgnn_tpu_torch.data.batching import BatchSpec

    jcfg = jax_load_cfg(GPS_CFG, ["dataset.dir",
                                  os.path.join(work, "gps_jax")])
    jsplits, _, _ = jax_run_gps.build_dataset(jcfg, 0)
    jspec = JSpec.from_graphs([g for s in jsplits.values() for g in s],
                              batch_size=jcfg.train.batch_size)
    model = JGPSModel(jax_run_gps._gps_config(jcfg, jsplits))
    cfg = load_cfg(GPS_CFG, ["dataset.dir", os.path.join(work, "gps_port")])
    splits, _, _ = run_gps.build_dataset(cfg, 0)
    spec = BatchSpec.from_graphs([g for s in splits.values() for g in s],
                                 cfg.train.batch_size)
    jpool, pool, order = _pools(jsplits["train"], jspec, splits["train"],
                                spec)
    lr = cfg.optim.base_lr
    res = spreads(
        lambda v: jax_losses(model, v, jax_l1, jpool, order, lr),
        lambda v: port_losses(run_gps.build_model(cfg, splits, 0, "cpu"), v,
                              run_gps._loss_fn(cfg), pool, order, lr),
        _init(model, jsplits["train"], jspec), scale, draws)
    m = cfg.model
    return res, dict(dim_h=m.dim_h, layers=m.num_layers, heads=m.num_heads,
                     batch=cfg.train.batch_size,
                     train_graphs=len(splits["train"]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models", default="ginep,gps")
    p.add_argument("--draws", type=int, default=3)
    p.add_argument("--scale", type=float, default=1e-7)
    p.add_argument("--work", default=os.path.join(ROOT, "results",
                                                  "perturbation_probe"))
    args = p.parse_args(argv)
    os.makedirs(args.work, exist_ok=True)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("JAX_CACHE_DIR", os.path.join(args.work,
                                                        "jax_cache"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {}
    for name in args.models.split(","):
        t0 = time.perf_counter()
        res, shape = {"ginep": ginep, "gps": gps}[name](
            args.work, args.scale, args.draws)
        out[name] = dict(
            shape=shape, scale=args.scale, draws=args.draws, **res,
            jax_max_rel=max(max(r) for r in res["jax"]),
            port_max_rel=max(max(r) for r in res["port"]),
            jax_vs_port_max_rel=max(res["jax_vs_port"]),
            seconds=round(time.perf_counter() - t0, 1))
        print(json.dumps({name: out[name]}), flush=True)
    return out


if __name__ == "__main__":
    main()
