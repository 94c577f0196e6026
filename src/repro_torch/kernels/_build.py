"""Build and load the CUDA kernels in ``csrc/``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The
libraries go to ``build/`` beside this module (listed in
``.gitignore``); a content hash of the sources in each library's name
means that an edited source is rebuilt.  The first call builds every
library, one ``nvcc`` process per source, all started together.
Nothing is built at import time: the CPU tests import this module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build_all", "library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "build"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: library name -> (source, {C entry point: argtypes})
SOURCES = {
    "bloom_tick": ("bloom_tick.cu", {
        "bloom_tick_i32": [_P, _P, _P, _I, _I, _I, _P],
        "bloom_tick_i16": [_P, _P, _P, _I, _I, _I, _P],
    }),
    "bloom_compare": ("bloom_compare.cu", {
        "bloom_merge_compare": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    }),
    "one_vs_many": ("one_vs_many.cu", {
        "one_vs_many_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                               _I, _P],
        "one_vs_many_i32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
        "hybrid_classify": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _F, _I, _P],
        "one_vs_many_smem": [_I, _I, _I],
        "one_vs_many_attrs": [_I, _I, _I, _P],
    }),
    "bloom_matrix": ("bloom_matrix.cu", {
        "matrix_tri_flags": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "matrix_rect_u8_flags": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _P],
        "matrix_rect_i32_stats": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _F, _P],
        "matrix_smem": [_I, _I, _I],
        "matrix_attrs": [_I, _I, _I, _P],
    }),
    "bloom_mxu": ("bloom_mxu.cu", {
        "matrix_mxu_viol": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P],
        "mxu_smem": [_I, _I, _I],
        "mxu_attrs": [_I, _I, _I, _P],
    }),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit at first use")
    return path


def _lib_path(name: str) -> Path:
    src, _ = SOURCES[name]
    h = hashlib.sha256((_CSRC / src).read_bytes())
    h.update((_CSRC / "common.cuh").read_bytes())
    h.update(_ARCH.encode())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every library that is not built yet, in parallel; returns
    name -> library path.  Raises with nvcc's output on failure."""
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, _ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(_CSRC / SOURCES[name][0])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        (_BUILD / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building all of them at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build_all()
            for lib_name, path in paths.items():
                cdll = ctypes.CDLL(str(path))
                for fn, argtypes in SOURCES[lib_name][1].items():
                    getattr(cdll, fn).argtypes = argtypes
                    getattr(cdll, fn).restype = ctypes.c_int
                _LIBS[lib_name] = cdll
            lib = _LIBS[name]
        return lib
