"""Training FLOPs of NestedGIN_eff on ZINC (`costs/__init__.py`)."""

import numpy as np


def dense(rows, n_in, n_out, input_grad=True):
    """Forward, weight gradient and (when needed) input gradient of a
    Linear over `rows` rows."""
    return (3 if input_grad else 2) * 2 * rows * n_in * n_out


def flops(s: dict, f: dict, launched: bool = False) -> float:
    H, L = f["hidden"], f["num_layers"]
    Dn, De = f["node_embed_dim"], f["edge_embed_dim"]
    G = s["graphs"]
    N, E, K = (int(np.sum(s[k])) for k in ("nodes", "edges", "nnz"))
    if launched:
        # budgets: unique ESC rows R over active buckets Zc, uniform blocks
        # of n_u nodes and e_u edges per graph slot
        R, Zc, n_u, e_u = s["rows"], s["buckets"], s["n_u"], s["e_u"]
        zred = 2 * 2 * R * Zc * H  # count matrix @ gathered table, dTable
        zrows = R  # the z MLP runs on the unique rows
    else:
        zred = 2 * 2 * K * H
        zrows = E
    tot = zred + dense(zrows, H, H)
    for i in range(L):
        d = Dn if i == 0 else H
        tot += dense(E, H + De, d)  # lin_edge
        if launched:
            # gather and scatter as per-graph one-hot products, forward and
            # the gradient of the rows (the one-hot takes none)
            tot += 2 * (2 * 2 * G * e_u * n_u * d)
        else:
            tot += 2 * (2 * 2 * E * d)
        tot += dense(N, d, H) + dense(N, H, H)
    if not launched:
        tot += 2 * 2 * N * L * H  # add-pool of the JK rows
    tot += dense(G, L * H, H) + dense(G, H, f["out_dim"])
    return float(tot)
