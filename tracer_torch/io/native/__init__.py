"""ctypes bindings for the native async frame writer (port of
tracer/io/native/__init__.py).

`frame_writer.cpp` (a copy of tracer's; its quantize divides, as
io/image.py's does) is compiled with `g++` at first use into
`build/tracer_torch/libtracer_io-<hash>.so`, the hash taken over the
source and the flags, so an edited source builds anew. The writer owns a
background thread: `submit` copies the framebuffer and returns; the
quantize, encode and disk write run off the frame loop, behind a bounded
queue of 4 frames. On a host without `g++` the library is not available
(`available()` is False) and the driver uses io/image.py's ThreadedWriter,
as tracer's driver does when its library is not built; a compiler that
fails raises.
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

SOURCE = Path(__file__).resolve().with_name("frame_writer.cpp")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "tracer_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread")
FORMATS = {"bin": 0, "ppm": 1}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtracer_io-{h.hexdigest()[:16]}.so"


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
    lib.tracer_writer_create.restype = ctypes.c_void_p
    lib.tracer_writer_submit.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.tracer_writer_failures.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.tracer_writer_failures.restype = ctypes.c_int
    lib.tracer_writer_wait.argtypes = [ctypes.c_void_p]
    lib.tracer_writer_destroy.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """True when the library is built or can be (a `g++` is on PATH)."""
    return _load() is not None


class AsyncFrameWriter:
    """Async writer for 'bin' and 'ppm' frames, with ThreadedWriter's
    interface (`submit`, `wait`, `close`).

    The queue is bounded (4 frames): submit blocks when the disk falls
    behind. wait() drains the queue and raises OSError if any write
    failed; close() drains, stops the thread and raises the same OSError
    (tracer's close() stops the thread without reporting)."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("the native frame writer needs g++")
        self._lib = lib
        self._handle = lib.tracer_writer_create()

    def submit(self, path: str, framebuffer: np.ndarray, samples_per_pixel: int,
               fmt: str = "bin") -> None:
        fb = np.ascontiguousarray(framebuffer, np.float32)
        h, w, _ = fb.shape
        self._lib.tracer_writer_submit(self._handle, fb.reshape(-1), w, h,
                                       float(samples_per_pixel), os.fsencode(path),
                                       FORMATS[fmt])

    def wait(self) -> None:
        """Drain the queue; raises OSError if any write failed."""
        self._lib.tracer_writer_wait(self._handle)
        buf = ctypes.create_string_buffer(512)
        failures = self._lib.tracer_writer_failures(self._handle, buf, len(buf))
        if failures:
            raise OSError(f"async frame writer: {failures} write(s) failed "
                          f"({buf.value.decode(errors='replace')})")

    def close(self) -> None:
        """Drain and stop the writer thread; raises wait()'s OSError after
        stopping it."""
        if not self._handle:
            return
        try:
            self.wait()
        finally:
            self._lib.tracer_writer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
