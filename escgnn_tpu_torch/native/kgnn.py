"""ctypes bindings for the native k-set graph featurizer (kgnn.cpp).

A copy of `escgnn_tpu/native/kgnn.py` (and of its C++ source) kept
inside the PyTorch package, which imports nothing of the JAX package:
the eight {two,three} x {local,malkin} x {all,connected} k-set graph
variants and assignment_2to3. The shared library builds with g++ on
first use into the same build directory as the CUDA kernels, through a
private temp path renamed into place (forked featurizer workers may race
the build). A failed build raises: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import threading

import numpy as np

from escgnn_tpu_torch._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kgnn.cpp")
_LIB = os.path.join(BUILD_DIR, "libkgnn.so")
_LOCK = threading.Lock()
_lib = None


def _load():
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{_LIB}.build.{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
                 _SRC],
                check=True, capture_output=True,
            )
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(_LIB)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kgnn_compute.restype = ctypes.c_void_p
        lib.kgnn_compute.argtypes = [
            i64p, i64p, ctypes.c_int64, i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.kgnn_assignment_2to3.restype = ctypes.c_void_p
        lib.kgnn_assignment_2to3.argtypes = [
            i64p, i64p, ctypes.c_int64, ctypes.c_int64,
        ]
        for f in ("kgnn_num_edges", "kgnn_num_assign", "kgnn_num_sets"):
            getattr(lib, f).restype = ctypes.c_int64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        for f in ("kgnn_copy_edges", "kgnn_copy_assignment"):
            getattr(lib, f).restype = None
            getattr(lib, f).argtypes = [ctypes.c_void_p, i64p, i64p]
        lib.kgnn_copy_iso_type.restype = None
        lib.kgnn_copy_iso_type.argtypes = [ctypes.c_void_p, i64p]
        lib.kgnn_free.restype = None
        lib.kgnn_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _as_i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _edges(edge_index):
    """Contiguous int64 sender and receiver rows, kept alive by the
    caller while the native code reads them."""
    ei = np.asarray(edge_index, np.int64).reshape(2, -1)
    return np.ascontiguousarray(ei[0]), np.ascontiguousarray(ei[1])


@dataclasses.dataclass
class KgnnResult:
    edge_index: np.ndarray  # (2, E_sets) set-graph edges
    assignment: np.ndarray  # (2, K * num_sets): [node; set_id]
    iso_type: np.ndarray  # (num_sets,)


def kgnn_set_graph(
    edge_index: np.ndarray,
    labels: np.ndarray,
    num_labels: int,
    num_nodes: int,
    k: int = 2,
    connected: bool = False,
    malkin: bool = False,
) -> KgnnResult:
    """The k-set graph of one graph; `labels`: (N,) int node label ids."""
    if k not in (2, 3):
        raise ValueError(f"k = {k}: the k-set graph has k 2 or 3")
    lab = np.ascontiguousarray(labels, np.int64).reshape(-1)
    if lab.shape[0] != num_nodes:
        raise ValueError(f"{lab.shape[0]} labels for {num_nodes} nodes")
    src, dst = _edges(edge_index)
    if src.size and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= num_nodes):
        raise ValueError("edge_index out of range")
    lib = _load()
    h = lib.kgnn_compute(
        _as_i64p(src), _as_i64p(dst), src.shape[0], _as_i64p(lab),
        int(num_labels), int(num_nodes), int(k), int(connected), int(malkin),
    )
    try:
        ne = lib.kgnn_num_edges(h)
        na = lib.kgnn_num_assign(h)
        ns = lib.kgnn_num_sets(h)
        rows = np.empty(ne, np.int64)
        cols = np.empty(ne, np.int64)
        an = np.empty(na, np.int64)
        asg = np.empty(na, np.int64)
        iso = np.empty(ns, np.int64)
        lib.kgnn_copy_edges(h, _as_i64p(rows), _as_i64p(cols))
        lib.kgnn_copy_assignment(h, _as_i64p(an), _as_i64p(asg))
        lib.kgnn_copy_iso_type(h, _as_i64p(iso))
    finally:
        lib.kgnn_free(h)
    return KgnnResult(
        edge_index=np.stack([rows, cols]).astype(np.int32),
        assignment=np.stack([an, asg]).astype(np.int32),
        iso_type=iso,
    )


def kgnn_assignment_2to3(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """(2, 3 * num_connected_3sets) incidences between all 2-sets and
    connected 3-sets."""
    src, dst = _edges(edge_index)
    if src.size and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= num_nodes):
        raise ValueError("edge_index out of range")
    lib = _load()
    h = lib.kgnn_assignment_2to3(
        _as_i64p(src), _as_i64p(dst), src.shape[0], int(num_nodes))
    try:
        ne = lib.kgnn_num_edges(h)
        rows = np.empty(ne, np.int64)
        cols = np.empty(ne, np.int64)
        lib.kgnn_copy_edges(h, _as_i64p(rows), _as_i64p(cols))
    finally:
        lib.kgnn_free(h)
    return np.stack([rows, cols]).astype(np.int32)
