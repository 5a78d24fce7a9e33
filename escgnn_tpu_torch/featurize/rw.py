"""Random-walk return-probability node features (counterpart of
`escgnn_tpu/featurize/rw.py`).

k-step return probabilities of the lazy walk on A + I, computed through
the eigendecomposition of the symmetric normalisation,
rp[v, t] = sum_i U[v, i]^2 * lambda_i^(t + 1), attached as the
node-aligned extra 'rp' (the batcher pads it like x).
"""

from __future__ import annotations

import numpy as np

from escgnn_tpu_torch.data.container import GraphData


def attach_return_prob(g: GraphData, steps: int = 50) -> GraphData:
    """Set `g.extras['rp']` to the (n, steps) float32 return
    probabilities; returns `g`."""
    n = g.num_nodes
    A = np.zeros((n, n))
    ei = np.asarray(g.edge_index)
    np.add.at(A, (ei[0], ei[1]), 1.0)
    A = A + np.eye(n)  # self loops, as in the reference
    dinv_sqrt = 1.0 / np.sqrt(A.sum(1))
    B = dinv_sqrt[:, None] * A * dinv_sqrt[None, :]
    lam, U = np.linalg.eigh(B)
    W = U * U  # W[v, i] = U[v, i]^2
    rp = np.empty((n, steps), np.float32)
    li = lam.copy()
    for t in range(steps):
        rp[:, t] = W @ li
        li = li * lam
    g.extras = dict(g.extras or {}, rp=rp)
    return g
