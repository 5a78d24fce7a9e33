"""SR25 expressiveness check on PyTorch (the twin of the repository's
`run_sr.py`):

    python -m escgnn_tpu_torch.run_sr [--layers 8 --hidden 64] [--device cuda]

An *untrained* NestedGIN_eff must give pairwise-distinct graph
embeddings to the 15 strongly regular SR(25,12,5,6) graphs, which 1-WL
and 3-WL cannot tell apart. All 15 go through the model in one width
batch, BatchNorm on its initial running statistics (JAX's default
`apply`); the failure count is the number of embedding pairs closer than
`tol` in L2 after the embeddings are scaled to mean |value| 1. The JAX
package records 0 of 105 at 8 layers x 64 (`run_sr.py:10-13`).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from escgnn_tpu_torch.data.batching import BatchSpec, pad_and_batch
from escgnn_tpu_torch.data.sr import load_sr_graphs
from escgnn_tpu_torch.device import resolve_device
from escgnn_tpu_torch.featurize.escgnn import EscConfig
from escgnn_tpu_torch.featurize.transform import featurize_many
from escgnn_tpu_torch.models.nested_gin_eff import (
    NestedGINEff,
    NestedGINEffConfig,
)
from escgnn_tpu_torch.train.loop import running_statistics

# the JAX driver's featurizer processes (it has no flag for them)
FEATURIZE_WORKERS = 2


def sr_batch(h: int = 3, path: str | None = None, device="cuda"):
    """All SR25 graphs, featurized, in one width-layout batch."""
    graphs = load_sr_graphs(path)
    ecfg = EscConfig(h=h, use_rd=True, self_loop=True)
    feats = featurize_many(graphs, ecfg, num_workers=FEATURIZE_WORKERS)
    spec = BatchSpec.from_graphs(feats, batch_size=len(feats))
    return pad_and_batch(feats, spec, device=device)


def sr_model(hidden: int = 64, layers: int = 8, seed: int = 0,
             device="cuda") -> NestedGINEff:
    """The untrained model, its weights drawn from `seed`."""
    return NestedGINEff(
        NestedGINEffConfig(hidden=hidden, num_layers=layers, graph_pred=True,
                           pool="add", use_x_embedding_jk=False,
                           out_dim=hidden),
        device=device, generator=torch.Generator().manual_seed(seed))


@torch.no_grad()
def sr_embeddings(model: NestedGINEff, batch) -> torch.Tensor:
    """The real graphs' embeddings, BatchNorm on the running statistics."""
    with running_statistics(model):
        emb = model(batch)
    return emb[batch.graph_mask]


def count_collisions(emb: np.ndarray, tol: float = 1e-2) -> tuple[int, int]:
    """(pairs closer than `tol` after scaling to mean |value| 1, pairs)."""
    emb = emb / (np.abs(emb).mean() + 1e-12)
    n = emb.shape[0]
    collisions = 0
    for i in range(n):
        for j in range(i + 1, n):
            if np.linalg.norm(emb[i] - emb[j]) < tol:
                collisions += 1
    return collisions, n * (n - 1) // 2


def sr_collision_count(
    h: int = 3, hidden: int = 64, layers: int = 8, seed: int = 0,
    tol: float = 1e-2, path: str | None = None, device="cuda",
) -> tuple[int, int]:
    """Returns (num_indistinct_pairs, num_pairs)."""
    device = resolve_device(device)
    emb = sr_embeddings(sr_model(hidden, layers, seed, device),
                        sr_batch(h, path, device))
    return count_collisions(emb.cpu().numpy(), tol)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m escgnn_tpu_torch.run_sr")
    p.add_argument("--h", type=int, default=3)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--path", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs only when named")
    return p


def main(argv=None) -> tuple[int, int]:
    """Prints and returns (collisions, pairs)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bad, total = sr_collision_count(args.h, args.hidden, args.layers,
                                    args.seed, path=args.path, device=device)
    print(f"SR25: {bad}/{total} indistinguishable pairs "
          f"({'PASS' if bad == 0 else 'FAIL'})")
    return bad, total


if __name__ == "__main__":
    main()
