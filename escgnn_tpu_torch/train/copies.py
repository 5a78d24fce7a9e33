"""The copy family's driver plumbing, shared by the `run_zinc`,
`run_zinc_cycle` and `run_qm9` twins (the JAX drivers write it out each):
the copy transforms and their cache tags, the batch layouts of
`--copy_layout`, and the NGNN / I2GNN models at the drivers' settings.

  * `uniform` (the default): every copy padded to one dataset-wide block
    (`data/uniform_copies.py`), message passing as per-copy one-hot
    products, copy pooling as a masked reshape;
  * `bucketed`: those batches re-laid into a small and a large block
    region, with region budgets pinned over the dataset, so every pooled
    batch keeps one shape (pool path only);
  * `ragged`: the union of the copies, masked segment reductions.
"""

from __future__ import annotations

from escgnn_tpu_torch.data.batching import BatchSpec
from escgnn_tpu_torch.data.uniform_copies import (
    make_bucket_transform,
    uniformize_dataset,
)
from escgnn_tpu_torch.featurize.node_subgraphs import (
    NodeSubgraphConfig,
    create_node_subgraphs,
)
from escgnn_tpu_torch.featurize.pair_subgraphs import (
    PairSubgraphConfig,
    create_pair_subgraphs,
)
from escgnn_tpu_torch.models.i2gnn import I2GNN, I2GNNConfig
from escgnn_tpu_torch.models.ngnn import NGNN, NGNNConfig

COPY_MODELS = ("NGNN", "I2GNN")


def cache_tag(model: str, h: int) -> str:
    """The JAX drivers' feature-cache tag of a copy model."""
    return f"{'ngnn' if model == 'NGNN' else 'i2gnn'}_h{h}_rd"


def featurize_copies(graphs, model: str, h: int) -> list:
    """NGNN: node-rooted copies; I2GNN: (root, neighbour)-pair copies; both
    h-hop with resistance distances."""
    if model == "NGNN":
        cfg = NodeSubgraphConfig(h=h, use_rd=True)
        return [create_node_subgraphs(g, cfg) for g in graphs]
    cfg = PairSubgraphConfig(h=h, use_rd=True)
    return [create_pair_subgraphs(g, cfg) for g in graphs]


def copy_layout_spec(splits: dict, batch_size: int, layout: str,
                     reshuffle: bool = False):
    """(splits, spec, batch_transform) of `--copy_layout`: the uniform and
    bucketed layouts replace every split's graphs by their uniformized
    copies; the bucketed one also returns the transform that the pools
    and stacks apply to every batch (None otherwise)."""
    all_graphs = [g for s in splits.values() for g in s]
    if layout == "ragged":
        return splits, BatchSpec.from_graphs(all_graphs, batch_size), None
    transform = None
    if layout == "bucketed":
        if reshuffle:
            raise ValueError("--copy_layout bucketed supports the pooled "
                             "path (use uniform with --reshuffle_membership)")
        transform, regions = make_bucket_transform(all_graphs, batch_size)
        print(f"bucketed copy layout: small region {regions[0]}, large "
              f"blocks {regions[1]}")
    uni = uniformize_dataset(all_graphs)
    out = {}
    for name, graphs in splits.items():
        out[name], uni = uni[:len(graphs)], uni[len(graphs):]
    all_graphs = [g for s in out.values() for g in s]
    return out, BatchSpec.copy_uniform(all_graphs, batch_size), transform


def copy_model(model: str, args, device, generator, node_level=False):
    """NGNN or I2GNN at the JAX drivers' settings (`args.layers` x
    `args.hidden`, resistance distances, I2GNN with mean-center-side
    gated pair pooling)."""
    if model == "NGNN":
        return NGNN(NGNNConfig(num_layers=args.layers, hidden=args.hidden,
                               use_rd=True, node_level=node_level,
                               out_dim=1), device=device, generator=generator)
    return I2GNN(I2GNNConfig(num_layers=args.layers, hidden=args.hidden,
                             use_rd=True,
                             subgraph2_pooling="mean-center-side", gate=True,
                             node_level=node_level, out_dim=1),
                 device=device, generator=generator)
