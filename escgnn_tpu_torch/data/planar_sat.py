"""EXP / CEXP planar-SAT graph pairs (counterpart of
`escgnn_tpu/data/planar_sat.py`).

Mirror of the reference's `PlanarSATPairsDataset.py:25-36`: each raw
artifact (`data/EXP/raw/GRAPHSAT.pkl`, `data/EXP/raw/CEXP.pkl`) is a
pickled list of PyG `Data` objects, 1200 graphs in 600 (satisfiable,
unsatisfiable) pairs that 1-WL GNNs provably cannot separate. The pickle
references `torch_geometric.data.Data`, which the port does not need: a
shim unpickler reconstructs the payload without PyG, and the torch
tensors inside it load natively.

Unpickling can run code: load only the reference's own artifacts.
"""

from __future__ import annotations

import io
import os
import pickle

import numpy as np

from escgnn_tpu_torch.data.container import GraphData


class _DataShim:
    """Stands in for torch_geometric.data.Data during unpickling; absorbs
    whatever attribute dict the pickle carries."""

    def __init__(self, *args, **kwargs):
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, tuple):  # (dict, slots) protocol
            state = state[0] or {}
        self.__dict__.update(state or {})


class _ShimUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("torch_geometric"):
            return _DataShim
        return super().find_class(module, name)


def _to_numpy(v):
    if v is None:
        return None
    if hasattr(v, "numpy"):  # torch tensor
        return v.detach().cpu().numpy()
    return np.asarray(v)


def load_planar_sat(name: str = "EXP", root: str = "data") -> list[GraphData]:
    """Load `<root>/<name>/raw/<name>.pkl` (the reference's artifact
    layout) into GraphData records: x = (n, 1) small category ids,
    y = (1,) int64 in {0, 1}."""
    # the reference stores BOTH datasets under the raw name GRAPHSAT in
    # their own roots (PlanarSATPairsDataset.py NAME = "GRAPHSAT", root =
    # data/EXP or data/CEXP); this repo ships them as
    # data/EXP/raw/{GRAPHSAT,CEXP}.pkl
    candidates = [
        os.path.join(root, name, "raw", f"{name}.pkl"),
        os.path.join(root, "EXP", "raw", f"{name}.pkl"),
        os.path.join(root, name, "raw", "GRAPHSAT.pkl"),
        os.path.join(root, "EXP", "raw", "GRAPHSAT.pkl") if name == "EXP"
        else os.path.join(root, "CEXP", "raw", "GRAPHSAT.pkl"),
    ]
    path = next((p for p in candidates if os.path.exists(p)), None)
    if path is None:
        raise FileNotFoundError(
            f"no {name}.pkl found under {candidates}"
        )
    with open(path, "rb") as f:
        payload = _ShimUnpickler(io.BytesIO(f.read())).load()
    out = []
    for d in payload:
        attrs = d.__dict__ if hasattr(d, "__dict__") else d
        # PyG >= 2 stores attributes under _store (whose payload dict is
        # _mapping in 2.x)
        for k in ("_store", "store"):
            if k in attrs and hasattr(attrs[k], "__dict__"):
                inner = attrs[k].__dict__
                attrs = {**attrs, **inner, **inner.get("_mapping", {})}
        ei = _to_numpy(attrs["edge_index"]).astype(np.int32)
        x = _to_numpy(attrs.get("x"))
        y = _to_numpy(attrs.get("y"))
        n = int(x.shape[0]) if x is not None else int(ei.max()) + 1
        if x is not None:
            x = x.reshape(n, -1).astype(np.int32)
        out.append(
            GraphData(
                num_nodes=n,
                edge_index=ei,
                x=x,
                y=np.asarray(y, np.int64).reshape(-1)[:1],
            )
        )
    return out
