"""Peptides (LRGB) long-range graph benchmark stand-ins (a copy of
`escgnn_tpu/data/peptides.py`).

The reference's GraphGPS fork loads `peptides-functional` (10-task
multilabel classification, Average Precision) and
`peptides-structural` (11-target regression, MAE) through
`preformat_Peptides` in `GraphGPS/graphgps/loader/master_loader.py`.
The OGB-hosted artifacts are not in the repository, so this module
provides:

* `load_peptides_pickle` — reader for a pre-extracted artifact:
  a pickle of `{split: [ {x, edge_index, edge_attr, y}, ... ]}`.
* `synthetic_peptides` — deterministic generator with the real data's
  defining property: LONG chain-of-residues molecular graphs (large
  diameter — the "long-range" in LRGB), with learnable targets.
  Functional labels mark which of 10 residue motifs occur in the chain;
  structural targets are deterministic whole-graph geometry/topology
  functionals.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from escgnn_tpu_torch.data.container import GraphData

NUM_FUNC_TASKS = 10
NUM_STRUCT_TASKS = 11
_NUM_RESIDUE_TYPES = 10


def _residue_motif(kind: int, base: int):
    """Small per-residue subgraph: (num_atoms, local undirected edge
    pairs, atom types). Residue kinds vary backbone length, one side
    branch, and an optional closing ring bond."""
    size = 3 + kind % 4            # 3..6 backbone atoms
    branch = kind % 3 == 1         # one pendant atom
    ring = kind % 4 == 3           # close backbone into a ring
    edges = [(i, i + 1) for i in range(size - 1)]
    types = [(kind * 3 + i) % 24 for i in range(size)]
    n = size
    if branch:
        edges.append((1, n))
        types.append((kind * 5 + 1) % 24)
        n += 1
    if ring and size >= 3:
        edges.append((size - 1, 0))
    edges = [(a + base, b + base) for a, b in edges]
    return n, edges, types


def synthetic_peptides(
    task: str = "func",
    num_graphs: int = 600,
    seed: int = 0,
) -> list[GraphData]:
    """Peptide-shaped graphs: a sequence of 6–16 residues (each a small
    motif graph) joined by backbone bonds — diameters of ~20–60, far
    above the molecule datasets (the long-range regime LRGB targets).

    x = (n, 1) int atom types in [0, 24); edge_attr = (E, 1) int bond
    types in [0, 3) (0 backbone link, 1 intra-residue, 2 branch/ring).

    task='func'  -> y = (10,) float {0,1}: residue motif k present.
    task='struct'-> y = (11,) float: [#atoms, #bonds, chain length,
    diameter, mean degree, degree std, #rings, #branches, mean atom
    type, max residue multiplicity, end-to-end type difference].
    """
    if task not in ("func", "struct"):
        raise ValueError(f"unknown peptides task {task!r}")
    rng = np.random.default_rng(seed + (0 if task == "func" else 101))
    out = []
    for _ in range(num_graphs):
        n_res = int(rng.integers(6, 17))
        kinds = rng.integers(0, _NUM_RESIDUE_TYPES, n_res)
        edges: list[tuple[int, int]] = []
        bond: list[int] = []
        types: list[int] = []
        base = 0
        anchors = []  # first atom of each residue (backbone join point)
        n_rings = n_branches = 0
        for k in kinds:
            k = int(k)
            anchors.append(base)
            n_atoms, res_edges, res_types = _residue_motif(k, base)
            for a, b in res_edges:
                edges.append((a, b))
                bond.append(1 if b - a == 1 else 2)
            n_rings += int(k % 4 == 3)
            n_branches += int(k % 3 == 1)
            types.extend(res_types)
            base += n_atoms
        for i in range(n_res - 1):  # peptide bonds between residues
            edges.append((anchors[i], anchors[i + 1]))
            bond.append(0)
        n = base
        a = np.asarray([e[0] for e in edges])
        b = np.asarray([e[1] for e in edges])
        ei = np.stack(
            [np.concatenate([a, b]), np.concatenate([b, a])]
        ).astype(np.int32)
        ea = np.concatenate([bond, bond]).astype(np.int32)[:, None]
        x = np.asarray(types, np.int32)[:, None]
        if task == "func":
            y = np.zeros(NUM_FUNC_TASKS, np.float32)
            y[np.unique(kinds)] = 1.0
        else:
            deg = np.bincount(ei[1], minlength=n)
            # BFS diameter from node 0 (exact on trees; a stable proxy
            # with the few ring bonds here)
            dist = np.full(n, -1, np.int64)
            dist[0] = 0
            frontier = [0]
            adj = [[] for _ in range(n)]
            for u, v in zip(ei[0], ei[1]):
                adj[u].append(v)
            while frontier:
                nxt = []
                for u in frontier:
                    for v in adj[u]:
                        if dist[v] < 0:
                            dist[v] = dist[u] + 1
                            nxt.append(v)
                frontier = nxt
            counts = np.bincount(kinds, minlength=_NUM_RESIDUE_TYPES)
            y = np.asarray(
                [
                    n,
                    ei.shape[1] // 2,
                    n_res,
                    dist.max(),
                    deg.mean(),
                    deg.std(),
                    n_rings,
                    n_branches,
                    x.mean(),
                    counts.max(),
                    abs(int(kinds[0]) - int(kinds[-1])),
                ],
                np.float32,
            )
        out.append(
            GraphData(
                num_nodes=n, edge_index=ei, x=x, edge_attr=ea, y=y
            )
        )
    return out


def load_peptides_pickle(path: str) -> dict:
    """Read a pre-extracted peptides artifact: a pickle of
    `{split: [ {x, edge_index, edge_attr, y}, ... ]}` numpy records."""
    with open(path, "rb") as f:
        raw = pickle.load(f)
    out = {}
    for split, items in raw.items():
        graphs = []
        for d in items:
            x = np.asarray(d["x"])
            if x.ndim == 1:
                x = x[:, None]
            ea = d.get("edge_attr")
            if ea is not None:
                ea = np.asarray(ea)
                if ea.ndim == 1:
                    ea = ea[:, None]
            graphs.append(
                GraphData(
                    num_nodes=int(x.shape[0]),
                    edge_index=np.asarray(d["edge_index"], np.int32),
                    x=x.astype(np.int32),
                    edge_attr=ea,
                    y=np.asarray(d["y"], np.float32).reshape(-1),
                )
            )
        out[split] = graphs
    return out


def peptide_splits(
    data_dir: str,
    task: str = "func",
    num_graphs: int = 600,
    seed: int = 0,
) -> tuple[dict, bool]:
    """Real splits when `<data_dir>/peptides/peptides-<task>.pkl`
    exists; otherwise a deterministic 80/10/10 split of the synthetic
    generator. Returns (splits, is_real)."""
    cand = os.path.join(data_dir, "peptides", f"peptides-{task}.pkl")
    if os.path.exists(cand):
        return load_peptides_pickle(cand), True
    raw = synthetic_peptides(task, num_graphs=num_graphs, seed=seed)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(raw))
    raw = [raw[i] for i in order]
    n_tr, n_val = int(0.8 * len(raw)), int(0.1 * len(raw))
    return {
        "train": raw[:n_tr],
        "val": raw[n_tr:n_tr + n_val],
        "test": raw[n_tr + n_val:],
    }, False
