"""Training FLOPs of PPGN_eff on substructure counting
(`costs/__init__.py`); a graph of n nodes has an n x n grid."""

import numpy as np


def dense(rows, n_in, n_out, input_grad=True):
    return (3 if input_grad else 2) * 2 * rows * n_in * n_out


def flops(s: dict, f: dict, launched: bool = False) -> float:
    C, L = f["emb_dim"], f["num_rb_layers"]
    n = np.asarray(s["nodes"], np.float64)
    E, K = (float(np.sum(s[k])) for k in ("edges", "nnz"))
    if launched:
        # every graph slot is an N x N grid; the z MLP runs on the padded
        # edge rows after the unique rows are expanded
        n = np.full(s["graphs"], float(s["grid"]))
        zred = 2 * 2 * s["rows"] * s["buckets"] * C
    else:
        zred = 2 * 2 * K * C
    cells, cubes, nodes = (n ** 2).sum(), (n ** 3).sum(), n.sum()
    tot = zred + 2 * dense(E, C, C)
    d = C + 2  # [edge mask | z | zero diagonal channel]
    for _ in range(L):
        tot += 2 * (dense(cells, d, C) + dense(cells, C, C))  # two MLPs
        tot += 3 * 2 * cubes * C  # per-channel product and its two grads
        tot += dense(cells, d + C, C)  # skip over [x | product]
        d = C
    tot += dense(nodes, 2 * C, C) + dense(nodes, C, f["out_dim"])
    return float(tot)
