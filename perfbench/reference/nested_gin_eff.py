"""NestedGIN_eff on the ESC encoding (the ESC-GNN paper's flagship,
arXiv:2303.10576), graph-level with node- and bond-type embeddings, as
the ZINC recipe runs it, written out on flat node and edge arrays:

  x      = node_emb[type]
  z_e    = act(BN(Dense(act(BN(rows_e @ z_table)))))  ‖ bond_emb[bond_e]
  h_i'   = MLP((1 + eps) h_i + sum_{e = (j -> i)} relu(h_j + Dense(z_e)))
           per layer, MLP = [Dense, BN, act] x 2
  out_g  = Dense(act(BN(Dense(sum_{i in g} [h^1 ‖ ... ‖ h^L]_i))))

Every BatchNorm runs over the batch's real rows (edges, nodes or graphs).
Parameter names are the system's, so one dict of weights serves both."""

from __future__ import annotations

import torch

from perfbench.reference.nn import ACTS, l1_mean, linear

SUPPORTED = dict(dropout=0.0, graph_pred=True, pool="add",
                 use_x_embedding_jk=False, concat_pos=False,
                 node_add_embed_vocab=0, edge_float_attr=False,
                 compute_dtype="float32")


def check(fields: dict) -> None:
    for k, v in SUPPORTED.items():
        if fields.get(k, v) != v:
            raise NotImplementedError(f"reference NestedGIN_eff: {k}="
                                      f"{fields[k]!r}")
    if not fields.get("node_embed_vocab") or not fields.get(
            "edge_embed_vocab"):
        raise NotImplementedError("reference NestedGIN_eff: node and bond "
                                  "type embeddings")


def forward(p: dict, b, fields: dict, norms) -> torch.Tensor:
    act = ACTS[fields["act"]]
    x = p["node_type_embedding.weight"][b.x[:, 0]]
    z = act(norms(p, "z_embedding.MaskedBatchNorm_0", b.rows @ p["z_initial"]))
    z = act(norms(p, "z_embedding.MaskedBatchNorm_1",
                  linear(p, "z_embedding.TorchDense_0", z)))
    z = torch.cat([z, p["edge_type_embedding.weight"][b.edge_attr]], dim=-1)
    h, xs = x, []
    for i in range(1, fields["num_layers"] + 1):
        c = f"conv{i}"
        msg = torch.relu(h[b.src] + linear(p, c + ".lin_edge", z))
        agg = torch.zeros_like(h).index_add(0, b.dst, msg)
        h = (1.0 + p[c + ".eps"]) * h + agg
        for j in range(2):
            h = act(norms(p, f"{c}.mlp.MaskedBatchNorm_{j}",
                          linear(p, f"{c}.mlp.TorchDense_{j}", h)))
        xs.append(h)
    hc = torch.cat(xs, dim=-1)
    pooled = hc.new_zeros(b.num_graphs, hc.shape[1]).index_add(
        0, b.node_graph, hc)
    g = act(norms(p, "bn_lin1", linear(p, "lin1", pooled)))
    return linear(p, "lin2", g)


def loss(out: torch.Tensor, b) -> torch.Tensor:
    """Mean absolute error over the batch's graphs."""
    return l1_mean(out, b.y)


def errors(out: torch.Tensor, b) -> torch.Tensor:
    """|out - y| per graph and target."""
    return (out - b.y).abs()
