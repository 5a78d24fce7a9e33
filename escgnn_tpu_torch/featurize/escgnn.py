"""The ESC per-edge structural encoder — fast vectorized path.

Host numpy code, a copy of `escgnn_tpu/featurize/escgnn.py` (with its
per-hop frontier subsampling option, `max_nodes_per_hop`), so that the
PyTorch package imports nothing of the JAX package.

Semantics contract: reference `utils_edge_efficient.py:20-151` (see
`layout.py` for the bucket map). This implementation produces
bucket-for-bucket identical histograms but is a redesign, not a port:

  * one capped all-pairs BFS per graph (boolean matmuls) instead of one
    Python BFS per edge endpoint;
  * all per-edge member sets / labels / degrees as (E, N) arrays;
  * resistance distances via one *batched* float64 pinv over padded
    subgraph Laplacians instead of E sequential scipy pinv calls;
  * histogram accumulation via np.add.at into a dense (E, dim) count
    matrix, then sparsified to CSR rows (ascending bucket ids — the same
    order `torch.nonzero` yields in the reference).

Reference parity quirks that are deliberately preserved:
  * With self_loop=True, each node v gets a (v, v) edge whose "subgraph"
    contains a phantom duplicate of v (reference builds the node list
    [v, v, ...] and the relabeling collision leaves index 0 orphaned,
    `utils_edge_efficient.py:52-66`). The orphan contributes one count at
    degree 0, one at z0=0, one at z1=0, and one at rd=0; resistance
    distances of the real nodes degrade to the diagonal of the subgraph
    Laplacian pseudo-inverse (root component is disconnected).
  * rd is computed in float64, cast to float32, then truncated toward zero
    (reference: scipy pinv -> torch.FloatTensor -> .long()).
  * The Laplacian ignores self-loops (scipy.csgraph.laplacian semantics).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from escgnn_tpu_torch.featurize.bfs import (
    hop_distance_matrix,
    sampled_hop_distance_matrix,
)
from escgnn_tpu_torch.featurize.layout import EncodingLayout


@dataclasses.dataclass(frozen=True)
class EscConfig:
    h: int = 3
    use_rd: bool = True
    self_loop: bool = True
    max_nodes_per_hop: Optional[int] = None

    @property
    def layout(self) -> EncodingLayout:
        return EncodingLayout(use_rd=self.use_rd)

    def cache_key(self) -> str:
        """The featurization cache's key, the JAX package's string (a
        cache that either package writes is found by the other)."""
        key = f"esc_h{self.h}"
        if self.use_rd:
            key += "_rd"
        if self.self_loop:
            key += "_sl"
        if self.max_nodes_per_hop is not None:
            key += f"_mnph{self.max_nodes_per_hop}"
        return key


@dataclasses.dataclass
class EscEncoding:
    """Result of encoding one graph."""

    edge_index: np.ndarray  # (2, E) canonical (self-looped if cfg.self_loop)
    enc_idx: np.ndarray  # flat int32 bucket ids
    enc_cnt: np.ndarray  # flat float32 counts
    enc_offsets: np.ndarray  # (E+1,) int64 CSR offsets over edges
    self_loop_attr_mask: np.ndarray  # (E,) bool: True for appended self-loops


def canonical_edges(
    num_nodes: int, edge_index: np.ndarray, self_loop: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Reference edge ordering: original non-self-loop edges, then (i, i)
    per node if self_loop. Returns (edges, is_appended_self_loop_mask)."""
    edge_index = np.asarray(edge_index, dtype=np.int64).reshape(2, -1)
    if self_loop:
        keep = edge_index[0] != edge_index[1]
        base = edge_index[:, keep]
        loops = np.arange(num_nodes, dtype=np.int64)
        edges = np.concatenate([base, np.stack([loops, loops])], axis=1)
        mask = np.zeros(edges.shape[1], dtype=bool)
        mask[base.shape[1]:] = True
        return edges, mask
    return edge_index, np.zeros(edge_index.shape[1], dtype=bool)


def _batched_pinv(
    mats: np.ndarray, valid: np.ndarray | None = None
) -> np.ndarray:
    """Batched Moore-Penrose pseudo-inverse of subgraph Laplacians.

    With `valid` (the member mask of each padded Laplacian): uses the
    connected-graph identity pinv(L) = inv(L + J/s) - J/s (J = ones over
    the s member slots; padding gets an identity diagonal) — one LU
    inverse instead of an SVD, ~3x faster and exact because every
    per-edge subgraph is a BFS ball union around adjacent roots, hence
    connected. Any batch element failing the L X L = L residual check
    (or a singular factorization) falls back to SVD pinv, mirroring the
    reference's pinv(+0.01 I) escape hatch (utils_edge_efficient.py:98-101).
    """
    if valid is None:
        return np.linalg.pinv(mats, hermitian=False)
    E, S = mats.shape[0], mats.shape[1]
    m = valid.astype(np.float64)
    s = np.maximum(m.sum(axis=1), 1.0)
    J = m[:, :, None] * m[:, None, :] / s[:, None, None]
    M = mats + J
    d = np.arange(S)
    M[:, d, d] += 1.0 - m
    try:
        X = np.linalg.inv(M) - J
    except np.linalg.LinAlgError:
        return np.linalg.pinv(mats, hermitian=False)
    resid = np.abs(mats @ X @ mats - mats).max(axis=(1, 2))
    bad = ~np.isfinite(resid) | (resid > 1e-6)
    if bad.any():
        X[bad] = np.linalg.pinv(mats[bad], hermitian=False)
    return X


def esc_encode(
    num_nodes: int, edge_index: np.ndarray, cfg: EscConfig,
    sample_seed: int = 0,
) -> EscEncoding:
    """Encode one graph into per-edge structural count rows.

    `sample_seed` only matters with `cfg.max_nodes_per_hop`: the per-hop
    frontier subsample is drawn from a rng derived per (seed, root, hop)
    (see `bfs.sampled_hop_distance_matrix`), so the encoding is a
    deterministic function of (graph, cfg, sample_seed)."""
    lay = cfg.layout
    n = int(num_nodes)
    h = cfg.h
    if 216 * (h + 1) + 36 * (h + 1) + 6 * (h + 1) + (h + 1) >= \
            lay.edge_type_buckets:
        raise ValueError(
            f"h={h} overflows the {lay.edge_type_buckets}-bucket edge-type "
            "block (base-6 packing needs labels <= 5, i.e. h <= 4 — the "
            "same bound as the reference's 1800-dim layout)"
        )
    cap = h + 1

    edges, loop_mask = canonical_edges(n, edge_index, cfg.self_loop)
    E = edges.shape[1]
    u, v = edges[0], edges[1]

    # BFS over the canonical (self-looped) edge list; self-loops do not
    # change distances but keep the traversal identical to the reference.
    if cfg.max_nodes_per_hop is not None:
        D = sampled_hop_distance_matrix(
            n, edges, h, cfg.max_nodes_per_hop, sample_seed
        )
    else:
        D = hop_distance_matrix(n, edges, h)  # (N, N)

    # Adjacency with multiplicities for in-subgraph degree (out-degree of
    # the stored directed edges, self-loops included).
    M = np.zeros((n, n), dtype=np.int32)
    np.add.at(M, (edges[0], edges[1]), 1)

    # Per-edge member sets and labels, as (E, N) arrays.
    Du = D[u]  # (E, N) distance from u
    Dv = D[v]
    in_u = Du <= h
    in_v = Dv <= h
    S = in_u | in_v  # member mask
    z0 = np.where(in_u, Du, cap).astype(np.int32)
    z1 = np.where(in_v, Dv, cap).astype(np.int32)

    H = np.zeros((E, lay.dim), dtype=np.float32)

    eid_flat, node_flat = np.nonzero(S)

    # --- degree histogram (clamped to the last bucket: a degree >= 200
    # would otherwise spill into the z0 block; same rule as escfeat.cpp) ---
    deg_all = S.astype(np.int32) @ M.T  # (E, N): deg[e, w] = sum_x M[w,x]*S[e,x]
    deg_clip = np.minimum(deg_all, lay.deg_buckets - 1)
    np.add.at(H, (eid_flat, deg_clip[eid_flat, node_flat]), 1.0)

    # --- z histograms ---
    np.add.at(H, (eid_flat, lay.z0_offset + z0[eid_flat, node_flat]), 1.0)
    np.add.at(H, (eid_flat, lay.z1_offset + z1[eid_flat, node_flat]), 1.0)

    # --- phantom-duplicate contributions of self-loop edges ---
    if loop_mask.any():
        le = np.nonzero(loop_mask)[0]
        np.add.at(H, (le, np.zeros(len(le), np.intp)), 1.0)  # degree 0
        np.add.at(H, (le, np.full(len(le), lay.z0_offset, np.intp)), 1.0)
        np.add.at(H, (le, np.full(len(le), lay.z1_offset, np.intp)), 1.0)

    # --- resistance distance ---
    if cfg.use_rd:
        sizes = S.sum(axis=1)
        max_s = int(sizes.max()) if E else 0
        # Padded member node lists: local slot j of subgraph e holds global
        # node members[e, j]; slots >= sizes[e] are padding.
        order = np.argsort(~S, axis=1, kind="stable")  # members first
        members = order[:, :max_s]  # (E, max_s) global node ids
        valid = np.arange(max_s)[None, :] < sizes[:, None]

        # Laplacian of each subgraph over its members. Off-diagonal
        # adjacency only: stored directed entries with the diagonal dropped
        # (scipy.csgraph.laplacian ignores self-loops).
        A_nd = M.copy()
        np.fill_diagonal(A_nd, 0)
        sub = A_nd[members[:, :, None], members[:, None, :]].astype(np.float64)
        sub *= valid[:, :, None] & valid[:, None, :]
        deg_d = sub.sum(axis=2)
        L = -sub
        L[:, np.arange(max_s), np.arange(max_s)] += deg_d
        Li = _batched_pinv(L, valid)

        # Local index of the root u in each member list.
        # For self-loop edges the root is the disconnected phantom: rd of the
        # real members is diag(L+), and the phantom itself adds rd = 0.
        root_local = np.argmax(members == u[:, None], axis=1)
        ar = np.arange(E)
        l_rr = Li[ar, root_local, root_local]  # (E,)
        l_ww = np.diagonal(Li, axis1=1, axis2=2)  # (E, max_s)
        l_rw = Li[ar[:, None], root_local[:, None], np.arange(max_s)[None, :]]
        l_wr = Li[ar[:, None], np.arange(max_s)[None, :], root_local[:, None]]

        rd = l_rr[:, None] + l_ww - l_rw - l_wr  # (E, max_s)
        rd_diag = l_ww  # used for self-loop (phantom-root) subgraphs
        rd = np.where(loop_mask[:, None], rd_diag, rd)
        rd_int = rd.astype(np.float32).astype(np.int64)
        rd_int = np.clip(rd_int, 0, lay.rd_buckets - 1)

        ef, sf = np.nonzero(valid)
        np.add.at(H, (ef, lay.rd_offset + rd_int[ef, sf]), 1.0)
        if loop_mask.any():
            le = np.nonzero(loop_mask)[0]
            np.add.at(H, (le, np.full(len(le), lay.rd_offset, np.intp)), 1.0)

    # --- subgraph edge-type histogram ---
    # For every stored non-self-loop edge (a, b) present inside subgraph e:
    # one count at base-6 packed (z0[a], z1[a], z0[b], z1[b]).
    nd = edges[0] != edges[1]
    a, b = edges[0][nd], edges[1][nd]
    if a.size:
        pair_in = S[:, a] & S[:, b]  # (E, E_nd)
        w216, w36, w6, w1 = lay.pack_tuple_base()
        t = w216 * z0[:, a] + w36 * z1[:, a] + w6 * z0[:, b] + w1 * z1[:, b]
        ef, jf = np.nonzero(pair_in)
        np.add.at(H, (ef, lay.edge_type_offset + t[ef, jf]), 1.0)

    # --- sparsify to CSR rows (ascending bucket order per edge) ---
    rows, cols = np.nonzero(H)
    counts = H[rows, cols]
    offsets = np.zeros(E + 1, dtype=np.int64)
    np.add.at(offsets, rows + 1, 1)
    offsets = np.cumsum(offsets)

    return EscEncoding(
        edge_index=edges.astype(np.int32),
        enc_idx=cols.astype(np.int32),
        enc_cnt=counts.astype(np.float32),
        enc_offsets=offsets,
        self_loop_attr_mask=loop_mask,
    )
