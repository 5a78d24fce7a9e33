"""Featurized-dataset disk cache (counterpart of
`escgnn_tpu/featurize/cache.py`).

One .npz per (dataset, split, `EscConfig.cache_key()`), holding the
ragged arrays of every graph concatenated with offset tables. The format
and the file name (`<dir>/<name>.v2.npz`) are the JAX package's, so a
cache that either package writes is read by the other.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Sequence

import numpy as np

from escgnn_tpu_torch.data.container import GraphData

_FIELDS = ("x", "edge_attr", "y", "pos", "enc_idx", "enc_cnt")
# bumped when the on-disk layout changes (v2: extras serialization);
# part of the filename so stale caches are rebuilt, not misread
_FORMAT_VERSION = 2
# a writer's tmp file idle this long belongs to a writer that died
_STALE_TMP_SECONDS = 3600


def cache_path(cache_dir: str, name: str) -> str:
    return os.path.join(cache_dir, f"{name}.v{_FORMAT_VERSION}.npz")


def save_graphs(path: str, graphs: Sequence[GraphData]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out: dict[str, np.ndarray] = {}
    out["num_nodes"] = np.asarray([g.num_nodes for g in graphs], np.int64)
    out["num_edges"] = np.asarray([g.num_edges for g in graphs], np.int64)
    out["edge_index"] = np.concatenate(
        [g.edge_index for g in graphs], axis=1
    ).astype(np.int32)
    for f in _FIELDS:
        vals = [getattr(g, f) for g in graphs]
        if vals[0] is not None:
            out[f] = np.concatenate([np.asarray(v) for v in vals], axis=0)
            out[f + "_len"] = np.asarray([len(np.asarray(v)) for v in vals],
                                         np.int64)
    if graphs[0].enc_offsets is not None:
        out["enc_nnz_per_edge"] = np.concatenate(
            [np.diff(g.enc_offsets) for g in graphs]
        ).astype(np.int64)
    # extras: per key, the flattened concatenation plus per-graph shapes
    if graphs[0].extras:
        for k in graphs[0].extras:
            vals = [np.asarray(g.extras[k]) for g in graphs]
            out[f"extra.{k}"] = np.concatenate([v.reshape(-1) for v in vals])
            out[f"extra.{k}.shape"] = np.asarray(
                [v.shape for v in vals], np.int64
            ).reshape(len(vals), -1)
    # atomic publish: a concurrent reader never sees a torn .npz; the
    # .npz suffix keeps savez from appending one
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    try:
        np.savez_compressed(tmp, **out)
        os.replace(tmp, path)
    finally:
        # a failure between savez and replace must not leak the tmp file
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def load_graphs(path: str) -> list[GraphData]:
    with np.load(path) as zf:
        # read every member once: NpzFile decompresses a member again on
        # each __getitem__
        z = {k: zf[k] for k in zf.files}
    nn_, ne = z["num_nodes"], z["num_edges"]
    G = len(nn_)
    e_off = np.concatenate([[0], np.cumsum(ne)])
    f_off = {}
    for f in _FIELDS:
        if f in z:
            f_off[f] = np.concatenate([[0], np.cumsum(z[f + "_len"])])
    nnz = z.get("enc_nnz_per_edge")
    edge_index = z["edge_index"]
    extra_keys = [
        k[len("extra."):] for k in z
        if k.startswith("extra.") and not k.endswith(".shape")
    ]
    ex_off = {}
    for k in extra_keys:
        shapes = z[f"extra.{k}.shape"]
        sizes = (np.prod(shapes, axis=1).astype(np.int64) if shapes.shape[1]
                 else np.ones(G, np.int64))
        ex_off[k] = (np.concatenate([[0], np.cumsum(sizes)]), shapes)
    graphs = []
    for i in range(G):
        kw = {f: z[f][off[i]:off[i + 1]] for f, off in f_off.items()}
        enc_offsets = None
        if nnz is not None:
            row_nnz = nnz[e_off[i]:e_off[i + 1]]
            enc_offsets = np.concatenate([[0], np.cumsum(row_nnz)])
        extras = None
        if extra_keys:
            extras = {}
            for k in extra_keys:
                off, shapes = ex_off[k]
                shape = tuple(shapes[i])
                v = z[f"extra.{k}"][off[i]:off[i + 1]].reshape(shape)
                # int scalars round-trip as python ints
                extras[k] = (v.item() if shape == () and v.dtype.kind in "iu"
                             else v)
        graphs.append(GraphData(
            num_nodes=int(nn_[i]),
            edge_index=edge_index[:, e_off[i]:e_off[i + 1]],
            enc_offsets=enc_offsets,
            extras=extras,
            **kw,
        ))
    return graphs


def cached_featurize(cache_dir: str, name: str, build_fn,
                     force: bool = False) -> list[GraphData]:
    """Load `<cache_dir>/<name>.v2.npz`, or build it with `build_fn()` and
    save it."""
    path = cache_path(cache_dir, name)
    if os.path.exists(path) and not force:
        return load_graphs(path)
    # sweep the tmp files of writers killed mid-save (their finally never
    # ran); only files idle over an hour, so a live writer's tmp is never
    # deleted before its os.replace
    for stale in glob.glob(f"{path}.tmp.*.npz"):
        try:
            if time.time() - os.path.getmtime(stale) > _STALE_TMP_SECONDS:
                os.unlink(stale)
        except OSError:
            pass
    graphs = build_fn()
    save_graphs(path, graphs)
    return graphs
