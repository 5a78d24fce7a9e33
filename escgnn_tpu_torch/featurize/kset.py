"""k-set graph attachment — the k-GNN pre-transforms (counterpart of
`escgnn_tpu/featurize/kset.py`, bit-equal to it).

Capability mirror of the reference's `k_gnn` transforms (reference
`software/k-gnn-master/k_gnn/transform.py:4-40`: TwoLocal/TwoMalkin/
ThreeLocal/ThreeMalkin x {all, connected} + Assignment2To3), built on the
native featurizer (`escgnn_tpu_torch/native/kgnn.cpp`, the C++ equivalent of
`cpu/graph.cpp:88-98`).

The reference composes these with the NGNN node-copy transform by running
them on every subgraph copy and letting `Batch.from_data_list` offset the
set ids (`utils.py:70-115`). Here `attach_kset_graphs` runs the native
enumeration once per copy (contiguous node ranges of the copies-graph)
and emits globally-offset arrays with a `to_subgraph` vector — the
`assignment{2,3}_to_subgraph` keys of reference `batch.py:103-105`.

Output extras (per level k in `ks`):
  kset{k}_iso: (Sk,) iso-type ids                    (iso_type_k)
  kset{k}_edge_index: (2, Ek) set-graph edges        (edge_index_k)
  kset{k}_assign: (2, Ak) [member node; set id]      (assignment_index_k)
  kset{k}_to_subgraph: (Sk,) owning subgraph copy    (assignmentk_to_subgraph)
  num_kset{k}: int
plus, when ks == (2, 3):
  assign_2to3: (2, A23) [2-set id; 3-set id]         (assignment_index_2to3)
  num_assign_2to3: int
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from escgnn_tpu_torch.data.container import GraphData
from escgnn_tpu_torch.native.kgnn import kgnn_assignment_2to3, kgnn_set_graph


def _copy_ranges(g: GraphData):
    """Contiguous (start, end, subgraph_id) node ranges of a copies-graph;
    one range covering everything when the graph has no copies."""
    ex = g.extras or {}
    if "node_to_subgraph" not in ex:
        return [(0, g.num_nodes, 0)]
    seg = np.asarray(ex["node_to_subgraph"])
    starts = np.flatnonzero(np.diff(np.concatenate([[-1], seg])))
    ends = np.concatenate([starts[1:], [len(seg)]])
    return [(int(s), int(e), int(seg[s])) for s, e in zip(starts, ends)]


def attach_kset_graphs(
    g: GraphData,
    ks: Sequence[int] = (2,),
    connected=None,
    malkin: bool = True,
    num_labels: int = 5,
    labels: np.ndarray | None = None,
) -> GraphData:
    """Attach k-set graph extras to `g` (see module docstring).

    `connected`: bool applied to every level, or a {level: bool} dict.
    Default None = the reference's canonical QM9 composition: all 2-sets
    (TwoMalkin) + connected 3-sets (ConnectedThreeMalkin)
    (`run_qm9.py:41-44`).
    `labels`: (N,) int node label ids; defaults to argmax over the first
    `num_labels` columns of x (the reference passes `data.x[:, :5]`
    one-hots, `run_qm9.py:41-44`).
    """
    if connected is None:
        connected = {2: False, 3: True}
    if isinstance(connected, bool):
        connected = {k: connected for k in ks}
    if labels is None:
        x = np.asarray(g.x)
        if x.ndim == 2 and x.shape[1] >= num_labels:
            labels = np.argmax(x[:, :num_labels], axis=1)
        else:
            labels = np.clip(x.reshape(-1).astype(np.int64), 0, num_labels - 1)
    labels = np.asarray(labels, np.int64)
    ei = np.asarray(g.edge_index, np.int64)
    ranges = _copy_ranges(g)

    extras = dict(g.extras or {})
    sets23: dict[int, list] = {}
    for k in ks:
        iso_parts, eis, asg_n, asg_s, to_sub = [], [], [], [], []
        set_off = 0
        keys_per_copy = []
        for s, e, sub in ranges:
            em = (ei[0] >= s) & (ei[0] < e) & (ei[1] >= s) & (ei[1] < e)
            sub_ei = ei[:, em] - s
            res = kgnn_set_graph(
                sub_ei, labels[s:e], num_labels, e - s, k=k,
                connected=connected[k], malkin=malkin,
            )
            ns = res.iso_type.shape[0]
            iso_parts.append(res.iso_type)
            eis.append(res.edge_index + set_off)
            asg_n.append(res.assignment[0] + s)
            asg_s.append(res.assignment[1] + set_off)
            to_sub.append(np.full(ns, sub, np.int32))
            keys_per_copy.append((s, set_off, ns))
            set_off += ns
        extras[f"kset{k}_iso"] = np.concatenate(iso_parts).astype(np.int32)
        extras[f"kset{k}_edge_index"] = np.concatenate(eis, axis=1).astype(
            np.int32
        )
        extras[f"kset{k}_assign"] = np.stack(
            [np.concatenate(asg_n), np.concatenate(asg_s)]
        ).astype(np.int32)
        extras[f"kset{k}_to_subgraph"] = np.concatenate(to_sub)
        extras[f"num_kset{k}"] = set_off
        sets23[k] = keys_per_copy

    if 2 in ks and 3 in ks:
        rows, cols = [], []
        for (s, e, sub), (s2_, off2, n2), (s3_, off3, n3) in zip(
            ranges, sets23[2], sets23[3]
        ):
            em = (ei[0] >= s) & (ei[0] < e) & (ei[1] >= s) & (ei[1] < e)
            sub_ei = ei[:, em] - s
            a23 = kgnn_assignment_2to3(sub_ei, e - s)
            rows.append(a23[0] + off2)
            cols.append(a23[1] + off3)
        extras["assign_2to3"] = np.stack(
            [np.concatenate(rows), np.concatenate(cols)]
        ).astype(np.int32)
        extras["num_assign_2to3"] = int(extras["assign_2to3"].shape[1])

    return GraphData(
        num_nodes=g.num_nodes,
        edge_index=g.edge_index,
        x=g.x,
        edge_attr=g.edge_attr,
        y=g.y,
        pos=g.pos,
        enc_idx=g.enc_idx,
        enc_cnt=g.enc_cnt,
        enc_offsets=g.enc_offsets,
        extras=extras,
    )
