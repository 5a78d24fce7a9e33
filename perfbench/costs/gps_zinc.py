"""Training FLOPs of GraphGPS on ZINC with ESC edges and the SPD bias
(`costs/__init__.py`), by the conventions of `zinc_nestedgin_eff.py`.

Attention counts over each graph's own n_g x n_g pairs (sum of n_g^2):
the q, k, v and output projections, the logits and A.V products (each
with both input gradients), and the SPD bias's backward, a one-hot
product that counts its nonzeros, n_g^2 per head. Launched, the
attention runs on the batch's (G, M, M) grid and the one-hot product at
the bias table's full vocabulary."""

import numpy as np

from perfbench.costs.zinc_nestedgin_eff import dense


def flops(s: dict, f: dict, launched: bool = False) -> float:
    D, L, Hh = f["dim_h"], f["num_layers"], f["num_heads"]
    G = s["graphs"]
    N, E, K = (int(np.sum(s[k])) for k in ("nodes", "edges", "nnz"))
    if launched:
        # budgets: unique ESC rows R over active buckets Zc, uniform blocks
        # of n_u nodes and e_u edges per graph slot, the attention's grid
        # of M nodes per graph
        R, Zc, n_u, e_u, M = (s[k] for k in ("rows", "buckets", "n_u", "e_u",
                                             "m"))
        zred = 2 * 2 * R * Zc * D  # count matrix @ gathered table, dTable
        zrows = R  # the z MLP runs on the unique rows
        local = 2 * (2 * 2 * G * e_u * n_u * D)  # one-hot gather, scatter
        grid_rows, pairs = G * M, G * M * M
        spd = 2 * f["spd_vocab"] * pairs * Hh  # onehot^T @ dY
    else:
        zred = 2 * 2 * K * D
        zrows = E
        local = 2 * (2 * 2 * E * D)
        grid_rows = N
        pairs = int(np.sum(np.asarray(s["nodes"], np.int64) ** 2))
        spd = 2 * pairs * Hh
    per_layer = (
        zred + dense(zrows, D, D)  # z table and the z MLP's Dense
        + dense(E, D, D) + local  # GINE: lin_edge, gather and scatter
        + 2 * dense(N, D, D)  # GINE's MLP
        + 4 * dense(grid_rows, D, D)  # q, k, v, out
        + 2 * 3 * 2 * pairs * D  # logits and A.V with both gradients
        + spd
        + dense(N, D, 2 * D) + dense(N, 2 * D, D))  # feed-forward
    tot = L * per_layer
    if not launched:
        tot += 2 * 2 * N * D  # add-pool
    tot += dense(G, D, D // 2) + dense(G, D // 2, f["out_dim"])
    return float(tot)
