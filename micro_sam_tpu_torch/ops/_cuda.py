"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on its own, with ``nvcc -gencode arch=compute_90a,
code=sm_90a -O3 -shared -Xcompiler -fPIC``, into a shared library with a plain
C interface that ``ctypes`` loads. All sources build at the first CUDA use, in
parallel (one ``nvcc`` each), into ``build/kernels-<hash>/`` at the root of the
checkout; the hash covers the sources, so an edited kernel rebuilds and an
unchanged one loads straight away. Nothing here runs at import time: the
module imports on a machine without CUDA, and only a wrapper called with a
CUDA tensor reaches ``library()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = ("layernorm", "gemm", "relpos_attention")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "layernorm": ("msam_layernorm", [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P]),
    "gemm": ("msam_gemm", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "relpos_attention": ("msam_relpos_attention",
                         [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          ctypes.POINTER(_LL), _F, _I, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: float = 0.0


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    root = os.path.dirname(os.path.dirname(CSRC))
    return os.path.join(root, "build", f"kernels-{_source_hash()}")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def build() -> Dict[str, str]:
    """Compile every source that has no library yet; returns name -> .so path."""
    global build_seconds
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    paths = {n: os.path.join(out_dir, f"lib{n}.so") for n in SOURCES}
    todo = [n for n in SOURCES if not os.path.exists(paths[n])]
    if not todo:
        return paths
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
               "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        log = open(os.path.join(out_dir, f"{n}.log"), "w")
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(n)
        else:
            os.replace(tmp, paths[n])
    build_seconds = time.perf_counter() - t0
    if failed:
        msgs = []
        for n in failed:
            with open(os.path.join(out_dir, f"{n}.log")) as f:
                msgs.append(f"--- {n}.cu ---\n{f.read()[-4000:]}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, building all of them at first use."""
    with _lock:
        if name not in _libs:
            paths = build()
            for n in SOURCES:
                lib = ctypes.CDLL(paths[n])
                fn_name, argtypes = _SIGNATURES[n]
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                err = getattr(lib, f"{fn_name}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                _libs[n] = lib
        return _libs[name]


def check(name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error (its cudaGetLastError)."""
    if code != 0:
        fn_name = _SIGNATURES[name][0]
        msg = getattr(library(name), f"{fn_name}_error_string")(code)
        raise RuntimeError(f"{fn_name} failed: CUDA error {code} ({msg.decode()})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]
