"""Everything the benchmark takes from the system under test,
`escgnn_tpu_torch`: its featurizer, batcher, pools, model classes, losses,
optimizer and the pool steps that `train/fit.py` drives; each model
class's construction, batch layout and drawing rules through its adapter
under `perfbench/systems/`. Nothing else in the benchmark imports the
system, and the reference imports none of it."""

from __future__ import annotations

import importlib

import numpy as np


def featurize(raw: list, ys: list, esc: dict, workers: int) -> list:
    """The system's ESC featurization of `raw` graphs (its native core,
    `workers` forked processes), with the normalized targets `ys`."""
    from escgnn_tpu_torch.data.container import GraphData
    from escgnn_tpu_torch.featurize.escgnn import EscConfig
    from escgnn_tpu_torch.featurize.transform import featurize_many

    graphs = [GraphData(num_nodes=g.num_nodes, edge_index=g.edge_index,
                        x=g.x, edge_attr=g.edge_attr, y=y)
              for g, y in zip(raw, ys)]
    return featurize_many(graphs, EscConfig(**esc), num_workers=workers)


def train_pools(graphs: list, spec, k: int, seed: int, device):
    """`k` membership-shuffled stacked pools of the train split on the
    device, pool i padded in the order of the i-th
    `np.random.default_rng(seed).permutation`; (pools, batches per pool)."""
    from escgnn_tpu_torch.data.prefetch import stacked_batch_pools

    pools, n, _ = stacked_batch_pools(graphs, spec, k=k, seed=seed,
                                      device=device)
    return pools, n


def stack(graphs: list, spec, device):
    from escgnn_tpu_torch.data.prefetch import stack_split

    return stack_split(graphs, spec, device)


def system(name: str):
    """The adapter `perfbench/systems/<name>.py` of a model class."""
    return importlib.import_module(f"perfbench.systems.{name}")


def loss_fn(name: str):
    from escgnn_tpu_torch.train import loop

    return getattr(loop, name)


def optimizer(model, opt: dict, capturable: bool):
    from escgnn_tpu_torch.train.loop import adam_with_plateau

    return adam_with_plateau(model.parameters(), opt["lr"],
                             grad_clip=opt["grad_clip"], capturable=capturable)


def pool_train_step(model, opt, loss, pool):
    from escgnn_tpu_torch.train.loop import make_pool_train_step

    return make_pool_train_step(model, opt, loss, pool)


def eval_steps(model, node_level: bool, bn_eval: str):
    """(refresh(stack), eval(stack) -> (sum |err|, count)): `fit`'s BN
    refresh and evaluation."""
    from escgnn_tpu_torch.train.loop import (
        make_pool_eval_step,
        make_pool_refresh_step,
    )

    return (make_pool_refresh_step(model),
            make_pool_eval_step(model, node_level=node_level,
                                bn_mode=bn_eval))


def plateau(opt: dict):
    from escgnn_tpu_torch.train.loop import PlateauScheduler

    return PlateauScheduler(factor=opt["lr_decay_factor"],
                            patience=opt["patience"])


def set_lr(opt, lr: float) -> None:
    from escgnn_tpu_torch.train.loop import set_learning_rate

    set_learning_rate(opt, lr)


def get_lr(opt) -> float:
    from escgnn_tpu_torch.train.loop import get_learning_rate

    return get_learning_rate(opt)


def nnz_per_graph(graphs: list) -> np.ndarray:
    """The ESC nonzeros of each featurized graph."""
    return np.asarray([int(g.enc_idx.shape[0]) for g in graphs], np.int64)
