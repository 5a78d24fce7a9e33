"""Positional / structural encodings for the GPS stack (a copy of
`escgnn_tpu/featurize/posenc.py`).

Capability mirror of the reference's GraphGPS encoder zoo
(`GraphGPS/graphgps/transform/posenc_stats.py` + `graphgps/encoder/*`):
  * LapPE — k lowest Laplacian eigenpairs per graph with the
    `eigvec_normalizer` variants (L1 / L2 / abs-max, eps-guarded exactly
    like the reference; validated by the same unit test the reference
    ships, `GraphGPS/unittests/test_eigvecs.py:16-60`).
  * RWSE — k-step random-walk landing probabilities diag((D^-1 A)^t)
    (`posenc_stats.py get_rw_landing_probs`).
  * Degree — in-degree ints for a Graphormer-style degree embedding.

All encodings are host-side numpy producing node-aligned extras
(`lap_pe` (N, k), `lap_eigvals` (N, k), `rwse` (N, k), `degree` (N, 1)),
so they ride the standard batcher; sign flips of eigenvectors are
resolved deterministically (first nonzero entry positive) rather than by
random flipping at load time.
"""

from __future__ import annotations

import numpy as np

from escgnn_tpu_torch.data.container import GraphData


def eigvec_normalizer(
    eigvecs: np.ndarray,
    eigvals: np.ndarray,
    normalization: str = "L2",
    eps: float = 1e-12,
) -> np.ndarray:
    """Reference `posenc_stats.eigvec_normalizer` semantics."""
    if normalization == "L1":
        denom = np.abs(eigvecs).sum(axis=0, keepdims=True)
    elif normalization == "L2":
        denom = np.sqrt((eigvecs ** 2).sum(axis=0, keepdims=True))
    elif normalization == "abs-max":
        denom = np.abs(eigvecs).max(axis=0, keepdims=True)
    else:
        raise ValueError(normalization)
    denom = np.clip(denom, eps, None)
    return eigvecs / denom


def laplacian_eigendecomposition(g: GraphData):
    """Unnormalized graph Laplacian eigh (dense; molecules are small)."""
    n = g.num_nodes
    A = np.zeros((n, n), np.float64)
    ei = np.asarray(g.edge_index)
    if ei.size:
        A[ei[0], ei[1]] = 1.0
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0.0)
    L = np.diag(A.sum(1)) - A
    vals, vecs = np.linalg.eigh(L)
    return np.clip(vals, 0.0, None), vecs


def attach_lap_pe(
    g: GraphData, k: int = 8, normalization: str = "L2"
) -> GraphData:
    """Attach the k lowest non-trivial Laplacian eigenvectors/values."""
    n = g.num_nodes
    vals, vecs = laplacian_eigendecomposition(g)
    vecs = eigvec_normalizer(vecs, vals, normalization)
    # deterministic sign: first entry with |v| > 1e-8 made positive
    for c in range(vecs.shape[1]):
        nz = np.flatnonzero(np.abs(vecs[:, c]) > 1e-8)
        if nz.size and vecs[nz[0], c] < 0:
            vecs[:, c] = -vecs[:, c]
    # skip the trivial (constant) eigenvector; pad to k columns
    pe = np.zeros((n, k), np.float32)
    ev = np.zeros((n, k), np.float32)
    take = min(k, max(n - 1, 0))
    pe[:, :take] = vecs[:, 1:1 + take]
    ev[:, :take] = vals[1:1 + take][None, :]
    extras = dict(g.extras or {})
    extras["lap_pe"] = pe
    extras["lap_eigvals"] = ev
    return _with_extras(g, extras)


def attach_rwse(g: GraphData, k: int = 16) -> GraphData:
    """k-step random-walk landing probabilities diag((D^-1 A)^t), t=1..k."""
    n = g.num_nodes
    A = np.zeros((n, n), np.float64)
    ei = np.asarray(g.edge_index)
    if ei.size:
        A[ei[0], ei[1]] = 1.0
    deg = A.sum(1)
    P = A / np.clip(deg[:, None], 1.0, None)
    out = np.zeros((n, k), np.float32)
    Pt = np.eye(n)
    for t in range(k):
        Pt = Pt @ P
        out[:, t] = np.diag(Pt)
    extras = dict(g.extras or {})
    extras["rwse"] = out
    return _with_extras(g, extras)


def attach_degree(g: GraphData, cap: int = 64) -> GraphData:
    n = g.num_nodes
    d = np.zeros(n, np.int64)
    ei = np.asarray(g.edge_index)
    if ei.size:
        np.add.at(d, ei[1], 1)
    extras = dict(g.extras or {})
    extras["degree"] = np.minimum(d, cap - 1).astype(np.int32)[:, None]
    return _with_extras(g, extras)


def heat_kernel_diag(g: GraphData, kernel_times, space_dim: int = 0):
    """Heat-kernel diagonal per diffusion time
    (reference `posenc_stats.get_heat_kernels_diag:234-280`):
    sum_{i: lambda_i > 0} exp(-t lambda_i) phi_i(j)^2, eigvecs
    L2-normalized per column, optional t^(space_dim/2) correction."""
    vals, vecs = laplacian_eigendecomposition(g)
    vecs = vecs / np.clip(
        np.sqrt((vecs ** 2).sum(0, keepdims=True)), 1e-12, None
    )
    keep = vals >= 1e-8
    vals, vecs = vals[keep], vecs[:, keep]
    out = np.zeros((g.num_nodes, len(kernel_times)), np.float32)
    sq = vecs ** 2
    for c, t in enumerate(kernel_times):
        k = (np.exp(-t * vals)[None, :] * sq).sum(1)
        out[:, c] = k * (t ** (space_dim / 2))
    return out


def attach_heat_kernel_diag(
    g: GraphData, kernel_times=(1.0, 2.0, 4.0), space_dim: int = 0
) -> GraphData:
    extras = dict(g.extras or {})
    extras["hkdiag"] = heat_kernel_diag(g, list(kernel_times), space_dim)
    return _with_extras(g, extras)


def electrostatic_encoding(g: GraphData) -> np.ndarray:
    """Green's-function ("electrostatic") node statistics
    (reference `posenc_stats.get_electrostatic_function_encoding:323-350`):
    10 per-node statistics of the Laplacian pseudoinverse with its
    diagonal subtracted column-wise, plus direct-neighbour interactions.
    """
    n = g.num_nodes
    A = np.zeros((n, n), np.float64)
    ei = np.asarray(g.edge_index)
    if ei.size:
        A[ei[0], ei[1]] = 1.0
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0.0)
    deg = A.sum(1)
    L = np.diag(deg) - A
    dinv = np.where(deg > 0, 1.0 / np.clip(deg, 1e-12, None), 0.0)
    DinvA = np.diag(dinv) @ np.abs(A)
    el = np.linalg.pinv(L)
    el = el - np.diag(el)[None, :]  # torch `x - x.diag()` broadcasts rows
    enc = np.stack(
        [
            el.min(0), el.max(0), el.mean(0), el.std(0),
            el.min(1), el.max(0), el.mean(1), el.std(1),
            (DinvA * el).sum(0), (DinvA * el).sum(1),
        ],
        axis=1,
    ).astype(np.float32)
    return enc


def attach_electrostatic(g: GraphData) -> GraphData:
    extras = dict(g.extras or {})
    extras["elstatic"] = electrostatic_encoding(g)
    return _with_extras(g, extras)


def _with_extras(g: GraphData, extras: dict) -> GraphData:
    return GraphData(
        num_nodes=g.num_nodes, edge_index=g.edge_index, x=g.x,
        edge_attr=g.edge_attr, y=g.y, pos=g.pos, enc_idx=g.enc_idx,
        enc_cnt=g.enc_cnt, enc_offsets=g.enc_offsets, extras=extras,
    )
