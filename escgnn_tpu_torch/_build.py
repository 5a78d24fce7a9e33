"""Build and load the package's CUDA kernels.

Each source `csrc/<name>.cu` exports plain C launchers and is compiled by
nvcc for Hopper (`sm_90a`) into `build/escgnn_tpu_torch/lib<name>.so` at
the root of the checkout, then loaded with ctypes. A library is rebuilt
when it is missing or older than its source or a shared header
(`csrc/*.cuh`). `build_all` starts one nvcc per source at once and waits
for all of them.

Nothing here runs at import time, and there is no fallback: a missing
nvcc or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "escgnn_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# ctypes signatures (result type, argument types) of every exported
# function: pointers and the stream are c_void_p (a bare int would be cut
# to 32 bits), sizes are c_int; every launcher returns cudaGetLastError()
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "expand_segsum": {
        "expand_segsum_f32": (_I, [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P]),
        "expand_segsum_bf16": (_I, [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P]),
        "expand_segsum_partial_floats": (_L, [_I, _I]),
    },
    "zemb_countmat": {
        "zemb_countmat_f32": (
            _I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
    },
    "zemb_gather": {
        "zemb_gather_f32": (
            _I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]),
    },
    "ppgn_pool": {
        "ppgn_pool_f32": (_I, [_P, _I, _I, _I, _P, _P]),
        "ppgn_pool_bf16": (_I, [_P, _I, _I, _I, _P, _P]),
    },
}

_LOCK = threading.Lock()
_libs: dict = {}
build_log: dict = {}  # source name -> nvcc's output (ptxas register report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _paths(name: str):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any header in
    `csrc/`."""
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    deps = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                    if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(d) for d in deps)


def build_all(names=None) -> None:
    """Compile every stale kernel library, one nvcc process per source,
    all started together."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in todo:
        src, lib = _paths(n)
        # private temp path + atomic rename: a concurrent build never
        # loads a half-written library
        tmp = f"{lib}.build.{os.getpid()}"
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, lib)
    failed = []
    for n, (p, tmp, lib) in procs.items():
        out, _ = p.communicate()
        build_log[n] = out
        if p.returncode != 0:
            failed.append(f"{n}.cu (exit {p.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _LOCK:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        build_all([name])
        lib = ctypes.CDLL(_paths(name)[1])
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
