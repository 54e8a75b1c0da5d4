"""ctypes bindings for the native C++ BVH builders (port of
tracer/bvh/native/__init__.py, plus the SAH builder).

`bvh_builder.cpp` is compiled with `g++` at first use into
`build/tracer_torch/libtracer_bvh-<hash>.so`, the hash taken over the
source and the flags, so an edited source builds anew. On a host
without `g++` the library is not available and `tracer_torch.bvh.builder`
uses its NumPy builders; a compiler that fails raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().with_name("bvh_builder.cpp")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "tracer_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-ffp-contract=off")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtracer_bvh-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    path = library_path()
    if not path.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: never load half a file
    lib = ctypes.CDLL(str(path))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    inputs = [ctypes.c_int32, f32p, f32p, f32p, i32p, i32p]  # n, lo, hi, centroid, kind, index
    outputs = [f32p, f32p, i32p, i32p, i32p, i32p]
    lib.tracer_build_bvh.restype = ctypes.c_int32
    lib.tracer_build_bvh.argtypes = inputs + outputs
    lib.tracer_build_bvh_sah.restype = ctypes.c_int32
    lib.tracer_build_bvh_sah.argtypes = inputs + [ctypes.c_int32] + outputs  # + max_depth
    return lib


def available() -> bool:
    """True when the library is built or can be (a `g++` is on PATH)."""
    return _load() is not None


def _run(entry: str, lo, hi, centroid, kind, index, *extra):
    lib = _load()
    if lib is None:
        raise RuntimeError("the native BVH builder needs g++")
    num = len(kind)
    if num == 0:
        z3 = np.zeros((0, 3), np.float32)
        zi = np.zeros(0, np.int32)
        return z3, z3, zi, zi, zi, zi
    n_nodes = 2 * num - 1
    out = (np.empty((n_nodes, 3), np.float32), np.empty((n_nodes, 3), np.float32),
           *(np.empty(n_nodes, np.int32) for _ in range(4)))
    written = getattr(lib, entry)(
        num,
        np.ascontiguousarray(lo, np.float32),
        np.ascontiguousarray(hi, np.float32),
        np.ascontiguousarray(centroid, np.float32),
        np.ascontiguousarray(kind, np.int32),
        np.ascontiguousarray(index, np.int32),
        *extra, *out,
    )
    if written != n_nodes:
        raise RuntimeError(f"native BVH builder wrote {written} nodes, expected {n_nodes}")
    return out


def build_bvh(lo, hi, centroid, kind, index):
    """Same contract as builder.build_bvh_numpy (the median split)."""
    return _run("tracer_build_bvh", lo, hi, centroid, kind, index)


def build_bvh_sah(lo, hi, centroid, kind, index):
    """Same contract and arrays as builder.build_bvh_sah_numpy."""
    from tracer_torch.bvh.builder import BVH_STACK

    return _run("tracer_build_bvh_sah", lo, hi, centroid, kind, index, BVH_STACK)
