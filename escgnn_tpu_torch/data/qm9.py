"""QM9 dataset pieces (counterpart of `escgnn_tpu/data/qm9.py`).

Mirrors the shapes of the reference's `qm9.py` (SDF via rdkit, atom/bond
featurization `:200-275`) and `distance.py` (normalized 3D edge
distances): x = float columns led by a 5-way atom-type one-hot, pos = 3D
coordinates, edge_attr = 4-way bond one-hot, y = 19 targets with the
reference's eV/unit conversion vector (`run_qm9.py:26-31`), and the atom
type ids in `extras["node_type"]`. `synthetic_qm9` generates QM9-shaped
molecules deterministically (11 x columns); `load_qm9_sdf` parses the
real gdb9.sdf without rdkit (13 x columns, see the block comment below).
Every record equals the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.data.molecules import _molecule_skeleton

HAR2EV = 27.2113825435
KCALMOL2EV = 0.04336414

# per-target unit conversion applied to reported MAEs (reference
# run_qm9.py:26-31, matching PyG's QM9 `conversion`)
QM9_CONVERSION = np.asarray(
    [
        1.0, 1.0, HAR2EV, HAR2EV, HAR2EV, 1.0, HAR2EV, HAR2EV, HAR2EV,
        HAR2EV, HAR2EV, 1.0, KCALMOL2EV, KCALMOL2EV, KCALMOL2EV,
        KCALMOL2EV, 1.0, 1.0, 1.0,
    ],
    np.float64,
)


def synthetic_qm9(num_graphs: int = 1000, seed: int = 0) -> list[GraphData]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_graphs):
        n = int(rng.integers(8, 20))
        ei = _molecule_skeleton(rng, n)
        ntype = rng.integers(0, 5, n).astype(np.int32)
        onehot = np.eye(5, dtype=np.float32)[ntype]
        hyb = rng.random((n, 6)).astype(np.float32)
        x = np.concatenate([onehot, hyb], axis=1)  # (n, 11)
        pos = rng.normal(scale=1.5, size=(n, 3)).astype(np.float32)
        bond = np.eye(4, dtype=np.float32)[
            rng.integers(0, 4, ei.shape[1])
        ]
        deg = np.bincount(ei[1], minlength=n)
        y = np.empty(19, np.float32)
        for t in range(19):
            y[t] = (
                0.3 * n
                + 0.05 * t * float(deg.mean())
                + float((ntype == (t % 5)).sum())
                + 0.1 * float(np.linalg.norm(pos - pos.mean(0)))
            )
        out.append(
            GraphData(
                num_nodes=n,
                edge_index=ei,
                x=x,
                edge_attr=bond,
                pos=pos,
                y=y,
                extras={"node_type": ntype.astype(np.int64)},
            )
        )
    return out


def append_distance_edge_attr(g: GraphData, norm: bool = True) -> GraphData:
    """Append the per-edge 3D distance (normalized by the graph max when
    `norm`, reference `distance.py` Distance(norm=True)) as one extra
    edge_attr column. Applied AFTER the ESC transform, so self loops get
    distance 0 and the enc_* arrays ride along unchanged."""
    pos = np.asarray(g.pos, np.float32)
    ei = np.asarray(g.edge_index)
    d = np.linalg.norm(pos[ei[1]] - pos[ei[0]], axis=1)
    if norm and d.size and d.max() > 0:
        d = d / d.max()
    ea = np.asarray(g.edge_attr, np.float32)
    if ea.ndim == 1:
        ea = ea[:, None]
    return dataclasses.replace(
        g, edge_attr=np.concatenate([ea, d[:, None].astype(np.float32)], 1)
    )


# ---------------------------------------------------------------------------
# Real gdb9.sdf ingestion (no rdkit needed — a direct V2000
# molblock parser; reference `qm9.py:200-275` builds the same record via
# rdkit). Feature parity notes:
#   * x = [one-hot(H,C,N,O,F) (5) || atomic_number, acceptor, donor,
#     aromatic, sp, sp2, sp3, num_hs] (13) — the reference's
#     one_hot_atom layout. acceptor/donor come from rdkit's
#     ChemicalFeatures factory and are NOT derivable from the molblock;
#     they are 0 here (the reference also zero-initializes them before
#     the factory pass).
#   * aromatic: gdb9.sdf is KEKULIZED (SDF bond type 4 never occurs),
#     while the reference reads rdkit's PERCEIVED aromaticity after
#     sanitization — so aromaticity is re-perceived here from ring
#     topology (`_perceive_aromatic`): 6-rings with alternating
#     single/double bonds (benzene/pyridine pattern) and 5-rings with
#     two doubles + an N/O lone-pair donor (pyrrole/furan pattern).
#     Bonds of perceived-aromatic rings take the AROMATIC one-hot
#     class, as rdkit's GetBondType() does.
#   * sp/sp2/sp3: inferred from bond orders (`_hybridization`):
#     triple or cumulated doubles -> sp; any double or aromatic ->
#     sp2; other heavy atoms -> sp3; H -> none. Matches rdkit for
#     the dominant QM9 motifs; conjugation-driven cases (e.g. amide
#     N perceived SP2 by rdkit) stay sp3 — a documented divergence.
#     num_hs counts explicit neighboring H atoms (gdb9.sdf stores
#     hydrogens explicitly = GetTotalNumHs(includeNeighbors=True)).
#   * edge_attr = one-hot over {single, double, triple, aromatic},
#     both directions per bond, coalesced in (row, col) order.
#   * y: 19 targets from gdb9.sdf.csv in PyG's order (columns after
#     mol_id, rotational constants A/B/C moved to the end).
#   * molecules listed in raw/uncharacterized.txt (3054 on real data)
#     are skipped when the file is present, like PyG's QM9 loader.
# ---------------------------------------------------------------------------

QM9_TYPES = {"H": 0, "C": 1, "N": 2, "O": 3, "F": 4}
ATOMIC_NUM = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}


def parse_sdf_v2000(text: str):
    """Parse an SDF (concatenated V2000 molblocks separated by $$$$).

    Returns a list of records (name, elements, pos (n,3), bonds
    [(i, j, type)]) with 0-based atom indices and SDF bond types
    (1=single, 2=double, 3=triple, 4=aromatic)."""
    records = []
    for block in text.split("$$$$"):
        lines = [l for l in block.split("\n")]
        while lines and not lines[0].strip():
            lines = lines[1:]
        if len(lines) < 4:
            continue
        name = lines[0].strip()
        counts = lines[3]
        na, nb = int(counts[0:3]), int(counts[3:6])
        elements, pos = [], []
        for l in lines[4:4 + na]:
            parts = l.split()
            pos.append([float(parts[0]), float(parts[1]), float(parts[2])])
            elements.append(parts[3])
        bonds = []
        for l in lines[4 + na:4 + na + nb]:
            # fixed-width fields (atom indices may run together >999)
            i, j, t = int(l[0:3]), int(l[3:6]), int(l[6:9])
            bonds.append((i - 1, j - 1, t))
        records.append((name, elements, np.asarray(pos, np.float32), bonds))
    return records


def _ring_paths(n: int, bonds, max_len: int = 6):
    """Simple rings of size <= max_len, one per closing bond: for each
    bond (u, v), the shortest alternative u->v path (BFS avoiding that
    bond) closes a ring. Returns deduplicated (atom_cycle, bond_cycle)
    pairs; QM9 molecules are <= 29 atoms so this is trivial work."""
    adj = [[] for _ in range(n)]
    for bi, (i, j, _t) in enumerate(bonds):
        adj[i].append((j, bi))
        adj[j].append((i, bi))
    seen = set()
    rings = []
    for bi, (u, v, _t) in enumerate(bonds):
        # BFS from u to v without using bond bi
        parent = {u: (None, None)}
        frontier = [u]
        depth = 0
        found = False
        while frontier and depth < max_len - 1 and not found:
            nxt = []
            for a in frontier:
                for b, eb in adj[a]:
                    if eb == bi or b in parent:
                        continue
                    parent[b] = (a, eb)
                    if b == v:
                        found = True
                        break
                    nxt.append(b)
                if found:
                    break
            frontier = nxt
            depth += 1
        if not found:
            continue
        atoms, bnds = [v], []
        cur = v
        while cur != u:
            p, eb = parent[cur]
            bnds.append(eb)
            atoms.append(p)
            cur = p
        bnds.append(bi)  # closing bond
        key = frozenset(atoms)
        if key in seen:
            continue
        seen.add(key)
        rings.append((atoms, bnds))
    return rings


def _perceive_aromatic(n: int, elements, bonds):
    """-> (aromatic atom mask (n,), set of aromatic bond indices).

    Kekulized-ring patterns (see module block comment): 6-rings with
    strictly alternating single/double bonds; 5-rings with exactly two
    doubles whose all-single-bond member is an N/O lone-pair donor."""
    arom_atoms = np.zeros(n, bool)
    arom_bonds: set[int] = set()
    for atoms, bnds in _ring_paths(n, bonds, max_len=6):
        types = [bonds[eb][2] for eb in bnds]
        if any(t not in (1, 2) for t in types):
            continue
        ok = False
        if len(atoms) == 6:
            ok = all(
                types[k] != types[(k + 1) % 6] for k in range(6)
            )
        elif len(atoms) == 5 and types.count(2) == 2:
            # bnds[k] connects atoms[k] and atoms[k+1]; the donor atom
            # is the one whose BOTH ring bonds are single
            for k, a in enumerate(atoms):
                # atoms[k] touches ring bonds bnds[k-1] and bnds[k]
                if (types[k - 1] == 1 and types[k] == 1
                        and elements[a] in ("N", "O")):
                    ok = True
                    break
        if ok:
            arom_atoms[list(atoms)] = True
            arom_bonds.update(bnds)
    return arom_atoms, arom_bonds


def _hybridization(n: int, elements, bonds, arom_atoms):
    """(sp, sp2, sp3) columns from bond orders (module block comment)."""
    n_double = np.zeros(n, np.int32)
    n_triple = np.zeros(n, np.int32)
    for i, j, t in bonds:
        if t == 2:
            n_double[i] += 1
            n_double[j] += 1
        elif t == 3:
            n_triple[i] += 1
            n_triple[j] += 1
    sp = np.zeros(n, np.float32)
    sp2 = np.zeros(n, np.float32)
    sp3 = np.zeros(n, np.float32)
    for a in range(n):
        if elements[a] == "H":
            continue
        if n_triple[a] > 0 or n_double[a] >= 2:
            sp[a] = 1.0
        elif n_double[a] > 0 or arom_atoms[a]:
            sp2[a] = 1.0
        else:
            sp3[a] = 1.0
    return sp, sp2, sp3


def load_uncharacterized(path: str) -> set[int]:
    """0-based SDF record indices to skip, from raw/uncharacterized.txt
    (PyG reads `int(line.split()[0]) - 1` for the index lines)."""
    skip: set[int] = set()
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0].isdigit():
                skip.add(int(parts[0]) - 1)
    return skip


def load_qm9_sdf(
    sdf_path: str, csv_path: str, skip_path: "str | None" = None
) -> list[GraphData]:
    """Real QM9 from gdb9.sdf + gdb9.sdf.csv (see block comment)."""
    with open(sdf_path) as f:
        records = parse_sdf_v2000(f.read())
    skip: set[int] = set()
    if skip_path is not None and os.path.exists(skip_path):
        skip = load_uncharacterized(skip_path)
    targets = {}
    with open(csv_path) as f:
        header = f.readline()
        ncol = len(header.strip().split(","))
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < ncol:
                continue
            vals = np.asarray([float(v) for v in parts[1:20]], np.float32)
            # PyG order: move rotational constants A/B/C to the end
            targets[parts[0]] = np.concatenate([vals[3:], vals[:3]])

    out = []
    for rec_idx, (name, elements, pos, bonds) in enumerate(records):
        if rec_idx in skip:
            continue
        n = len(elements)
        type_idx = np.asarray([QM9_TYPES[e] for e in elements], np.int32)
        onehot = np.eye(5, dtype=np.float32)[type_idx]
        atomic = np.asarray([ATOMIC_NUM[e] for e in elements], np.float32)
        arom_atoms, arom_bonds = _perceive_aromatic(n, elements, bonds)
        sp, sp2, sp3 = _hybridization(n, elements, bonds, arom_atoms)
        aromatic = arom_atoms.astype(np.float32)
        num_hs = np.zeros(n, np.float32)
        row, col, btype = [], [], []
        for bi, (i, j, t) in enumerate(bonds):
            if t == 4:  # explicit aromatic (not in kekulized gdb9)
                aromatic[i] = aromatic[j] = 1.0
            if elements[i] == "H":
                num_hs[j] += 1.0
            if elements[j] == "H":
                num_hs[i] += 1.0
            row += [i, j]
            col += [j, i]
            # perceived-aromatic ring bonds take the AROMATIC class,
            # as rdkit's GetBondType() does after sanitization
            cls = 3 if (bi in arom_bonds or t == 4) else min(t, 4) - 1
            btype += 2 * [cls]
        ei = np.stack([np.asarray(row), np.asarray(col)]).astype(np.int32)
        ea = np.eye(4, dtype=np.float32)[np.asarray(btype, np.int32)]
        # coalesce in (row, col) order, matching the reference
        order = np.lexsort((ei[1], ei[0]))
        ei, ea = ei[:, order], ea[order]
        zeros = np.zeros(n, np.float32)
        x = np.concatenate(
            [
                onehot,
                np.stack(
                    [atomic, zeros, zeros, aromatic, sp, sp2, sp3,
                     num_hs],
                    axis=1,
                ),
            ],
            axis=1,
        )  # (n, 13)
        y = targets.get(name)
        if y is None:
            continue
        out.append(
            GraphData(
                num_nodes=n,
                edge_index=ei,
                x=x,
                edge_attr=ea,
                pos=pos,
                y=y,
                extras={"node_type": type_idx.astype(np.int64)},
            )
        )
    return out


def qm9_splits(
    data_dir: str, num_graphs: int = 1000, seed: int = 0
) -> tuple[list, bool]:
    """Real QM9 when `<data_dir>/qm9/raw/gdb9.sdf` (+ `.sdf.csv`) exists;
    otherwise `synthetic_qm9`. Returns (graphs, is_real); the driver
    applies its own shuffled 10/10/80 split (reference
    run_qm9.py:292-309)."""
    sdf = os.path.join(data_dir, "qm9", "raw", "gdb9.sdf")
    csv = sdf + ".csv"
    skip = os.path.join(data_dir, "qm9", "raw", "uncharacterized.txt")
    if os.path.exists(sdf) and os.path.exists(csv):
        return load_qm9_sdf(sdf, csv, skip_path=skip), True
    return synthetic_qm9(num_graphs=num_graphs, seed=seed), False
