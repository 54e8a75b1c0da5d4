"""Build and load the CUDA kernels of `tracer_torch/csrc`.

Every `csrc/*.cu` compiles with `nvcc` into a shared library of its own
with a plain C interface, loaded with ctypes. All sources are compiled
together at the first use of any kernel, one `nvcc` process each, started
at once. A library's file name carries a hash of its source, the headers
and the flags, so an edited source builds anew and an unchanged one is
loaded from `build/tracer_torch/`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tracer_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-source flags: the backward kernel is compiled without FMA contraction,
# so that its replay rounds as its plain version does and takes the same
# discrete decisions (roulette, Fresnel choice) on the same tape
SOURCE_FLAGS = {"bwd": ("-fmad=false",)}


class Build(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of the whole parallel build; 0.0 when cached
    log: str  # nvcc's output (ptxas register and spill report), "" if cached


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path(stem: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + SOURCE_FLAGS.get(stem, ())).encode())
    for src in [CSRC_DIR / f"{stem}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtracer_{stem}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return nvcc


@functools.lru_cache(maxsize=None)
def build_all() -> Dict[str, Build]:
    """Compile every source whose library is missing (in parallel) and load
    them all; returns {source stem: Build}."""
    todo = {src.stem: library_path(src.stem) for src in sources()}
    missing = {stem: path for stem, path in todo.items() if not path.exists()}
    logs, seconds = {}, 0.0
    if missing:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for stem, path in missing.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            procs[stem] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(stem, ()), "-o", str(tmp),
                 str(CSRC_DIR / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for stem, (tmp, proc) in procs.items():
            logs[stem] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{stem}.cu ({proc.returncode}):\n{logs[stem]}")
            else:
                os.replace(tmp, missing[stem])  # atomic: never load half a file
        seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {stem: Build(ctypes.CDLL(str(path)), path, seconds if stem in missing else 0.0,
                        logs.get(stem, "")) for stem, path in todo.items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<stem>.cu` (building every kernel first
    if needed)."""
    return build_all()[stem].lib
