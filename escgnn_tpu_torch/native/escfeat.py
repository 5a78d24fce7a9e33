"""ctypes bindings for the native ESC featurizer core (escfeat.cpp).

A copy of `escgnn_tpu/native/escfeat.py` (and of its C++ source) kept
inside the PyTorch package, which imports nothing of the JAX package.

`esc_encode_native(num_nodes, edge_index, cfg)` mirrors
`featurize.escgnn.esc_encode` bit-for-bit (equality-tested); returns
None when the native path declines (failed residual check on a
disconnected subgraph Laplacian) so the caller falls back to the
numpy/SVD encoder. The shared library self-builds with g++ -fopenmp on
first use, into the same build directory as the CUDA kernels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from escgnn_tpu_torch._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "escfeat.cpp")
_LIB = os.path.join(BUILD_DIR, "libescfeat.so")
_LOCK = threading.Lock()
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    with _LOCK:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if (not os.path.exists(_LIB)
                    or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                # build to a private temp path and rename atomically: the
                # forked featurizer workers may race this build, and a
                # concurrent g++ writing the final path could be dlopen'd
                # half-written (the per-process lock doesn't help there)
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{_LIB}.build.{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-std=c++17", "-fopenmp", "-o", tmp, _SRC],
                    check=True, capture_output=True,
                )
                os.replace(tmp, _LIB)
            lib = ctypes.CDLL(_LIB)
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.escfeat_encode.restype = ctypes.c_void_p
        lib.escfeat_encode.argtypes = [
            i32p, i32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.escfeat_status.restype = ctypes.c_int
        lib.escfeat_status.argtypes = [ctypes.c_void_p]
        lib.escfeat_num_edges.restype = ctypes.c_int64
        lib.escfeat_num_edges.argtypes = [ctypes.c_void_p]
        lib.escfeat_nnz.restype = ctypes.c_int64
        lib.escfeat_nnz.argtypes = [ctypes.c_void_p]
        lib.escfeat_copy.argtypes = [
            ctypes.c_void_p, i32p, i32p, u8p, i32p, f32p, i64p,
        ]
        lib.escfeat_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _p(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def esc_encode_native(num_nodes: int, edge_index, cfg):
    """Native ESC encoding; None if unavailable or declined."""
    lib = _load()
    if lib is None:
        return None
    if cfg.h > 4:
        # base-6 edge-type packing only fits 1300 buckets for labels
        # <= 5 (h + 1); larger h must use the numpy encoder's layout
        return None
    lay = cfg.layout
    if (lay.deg_buckets, lay.z_classes, lay.rd_buckets,
            lay.edge_type_buckets) != (200, 100, 100, 1300):
        return None  # non-default layout: use the numpy encoder
    ei = np.ascontiguousarray(np.asarray(edge_index, np.int32).reshape(2, -1))
    src = np.ascontiguousarray(ei[0])
    dst = np.ascontiguousarray(ei[1])
    h = lib.escfeat_encode(
        _p(src, ctypes.c_int32), _p(dst, ctypes.c_int32),
        ctypes.c_int64(src.shape[0]), ctypes.c_int64(int(num_nodes)),
        int(cfg.h), int(bool(cfg.self_loop)), int(bool(cfg.use_rd)),
    )
    try:
        if lib.escfeat_status(h) != 0:
            return None
        E = lib.escfeat_num_edges(h)
        nnz = lib.escfeat_nnz(h)
        e_src = np.empty(E, np.int32)
        e_dst = np.empty(E, np.int32)
        loop_mask = np.empty(E, np.uint8)
        enc_idx = np.empty(nnz, np.int32)
        enc_cnt = np.empty(nnz, np.float32)
        offsets = np.empty(E + 1, np.int64)
        lib.escfeat_copy(
            h, _p(e_src, ctypes.c_int32), _p(e_dst, ctypes.c_int32),
            _p(loop_mask, ctypes.c_uint8), _p(enc_idx, ctypes.c_int32),
            _p(enc_cnt, ctypes.c_float), _p(offsets, ctypes.c_int64),
        )
    finally:
        lib.escfeat_free(h)
    from escgnn_tpu_torch.featurize.escgnn import EscEncoding

    return EscEncoding(
        edge_index=np.stack([e_src, e_dst]),
        enc_idx=enc_idx,
        enc_cnt=enc_cnt,
        enc_offsets=offsets,
        self_loop_attr_mask=loop_mask.astype(bool),
    )
