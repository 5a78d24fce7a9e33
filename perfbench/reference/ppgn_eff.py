"""PPGN_eff at node level (the ESC-GNN paper's PPGN with the ESC edge
encoding, arXiv:2303.10576; PPGN: Maron et al., arXiv:1905.11136),
written out on each graph's dense n x n grid:

  z_e    = relu(BN(Dense(relu(BN(Dense(rows_e @ z_table))))))
  X[g, a, b] = [1 ‖ z_e] for every stored edge e = (a -> b), self-loops on
           the diagonal, then one zero channel
  block: M1 = MLP1(X), M2 = MLP2(X) (1x1 convs with ReLU, twice),
           X' = Dense([X ‖ M1 M2]) with M1 M2 the per-channel n x n
           product; every output masked to the graph's real pairs
  out_i  = Dense(relu(Dense([X_ii ‖ sum_j X_ij + sum_j X_ji - 2 X_ii])))

The edge BatchNorms run over the batch's real edges. Parameter names are
the system's."""

from __future__ import annotations

import torch

from perfbench.reference.nn import l1_mean, linear

SUPPORTED = dict(node_level=True, use_esc=True, compute_dtype="float32",
                 depth_of_mlp=2)


def check(fields: dict) -> None:
    for k, v in SUPPORTED.items():
        if fields.get(k, v) != v:
            raise NotImplementedError(f"reference PPGN_eff: {k}="
                                      f"{fields[k]!r}")


def forward(p: dict, b, fields: dict, norms) -> torch.Tensor:
    z = b.rows @ p["z_initial"]
    for i in range(2):
        z = torch.relu(norms(p, f"z_bn_{i}",
                             linear(p, f"z_embedding_{i}", z)))
    feat = torch.cat([z.new_ones(z.shape[0], 1), z], dim=-1)
    G = b.num_graphs
    n = int(b.nodes_per_graph.max())
    first = torch.cumsum(b.nodes_per_graph, 0) - b.nodes_per_graph
    local = torch.arange(b.node_graph.shape[0], device=z.device) - first[
        b.node_graph]
    cell = ((b.node_graph[b.dst] * n + local[b.src]) * n + local[b.dst])
    X = feat.new_zeros(G * n * n, feat.shape[1]).index_add(0, cell, feat)
    X = torch.cat([X.view(G, n, n, -1), X.new_zeros(G, n, n, 1)], dim=-1)
    real = torch.arange(n, device=z.device) < b.nodes_per_graph[:, None]
    pm = (real[:, :, None] & real[:, None, :]).to(X.dtype)[..., None]
    X = X * pm
    for i in range(fields["num_rb_layers"]):
        r = f"rb{i}"
        m = []
        for k in (1, 2):
            t = X
            for j in range(fields.get("depth_of_mlp", 2)):
                t = torch.relu(linear(p, f"{r}.mlp{k}.conv{j}", t))
            m.append(t * pm)
        prod = torch.einsum("gabc,gbdc->gadc", m[0], m[1])
        X = linear(p, f"{r}.skip", torch.cat([X, prod], dim=-1)) * pm
    diag = torch.diagonal(X, dim1=1, dim2=2).permute(0, 2, 1)
    pooled = torch.cat([diag, X.sum(2) + X.sum(1) - 2 * diag], dim=-1)
    out = linear(p, "fc1", torch.relu(linear(p, "fc0", pooled)))
    return out[b.node_graph, local]


def loss(out: torch.Tensor, b) -> torch.Tensor:
    """Mean absolute error over the batch's nodes."""
    return l1_mean(out, b.y)


def errors(out: torch.Tensor, b) -> torch.Tensor:
    """|out - y| per node and target."""
    return (out - b.y).abs()
