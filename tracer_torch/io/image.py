"""Framebuffer quantization and image savers (copy of tracer.io.image).

Functional replacement of the reference `ISaver` strategy hierarchy
(include/camera.cuh:31-84, src/camera.cu:52-153): one vectorized
quantize step (divide by spp, sqrt gamma, clamp to [0, 0.999], scale by
256 — camera.cu:54-73) feeding four writers:

  write_ppm      - FileSaver       (P3 text PPM, camera.cu:56-73)
  write_ppm_text - OutStreamSaver  (P3 PPM to a stream, camera.cu:75-92)
  write_png      - PNGSaver        (camera.cu:94-126, PIL instead of stb)
  write_binary   - BinarySaver     (int32 w, h + raw RGB, camera.cu:128-153)

Both reference frame drivers instantiate BinarySaver (camera.cu:300, 357),
so that is the CLI default.
"""

from __future__ import annotations

import struct
import sys

import numpy as np


def quantize(framebuffer: np.ndarray, samples_per_pixel: int) -> np.ndarray:
    """Raw sample sums [H, W, 3] -> uint8 [H, W, 3].

    reference camera.cu:64-73: mean, gamma = sqrt (linearToGamma,
    camera.cu:54), clamp to [0, 0.999], * 256, truncate.
    """
    c = np.asarray(framebuffer, np.float32) / float(samples_per_pixel)
    g = np.sqrt(np.maximum(c, 0.0))
    return (256.0 * np.clip(g, 0.0, 0.999)).astype(np.uint8)


def write_ppm(path: str, framebuffer: np.ndarray, samples_per_pixel: int) -> None:
    """P3 text PPM (FileSaver, camera.cu:56-73)."""
    with open(path, "w") as f:
        _write_ppm_stream(f, framebuffer, samples_per_pixel)


def write_ppm_text(stream, framebuffer: np.ndarray, samples_per_pixel: int) -> None:
    """P3 PPM to an open text stream (OutStreamSaver, camera.cu:75-92)."""
    _write_ppm_stream(stream or sys.stdout, framebuffer, samples_per_pixel)


def _write_ppm_stream(f, framebuffer, samples_per_pixel):
    h, w, _ = framebuffer.shape
    q = quantize(framebuffer, samples_per_pixel)
    f.write(f"P3\n{w} {h}\n255\n")
    out = "\n".join(" ".join(str(int(v)) for v in px) for px in q.reshape(-1, 3))
    f.write(out + "\n")


def write_png(path: str, framebuffer: np.ndarray, samples_per_pixel: int) -> None:
    """PNG via PIL (PNGSaver, camera.cu:94-126)."""
    from PIL import Image

    q = quantize(framebuffer, samples_per_pixel)
    # Explicit format: PNG bytes regardless of the path's extension, like
    # the reference PNGSaver (stbi_write_png on whatever path it was given).
    Image.fromarray(q, "RGB").save(path, format="PNG")


def write_binary(path: str, framebuffer: np.ndarray, samples_per_pixel: int) -> None:
    """int32 width, int32 height, then raw RGB bytes row-major
    (BinarySaver, camera.cu:128-153)."""
    h, w, _ = framebuffer.shape
    q = quantize(framebuffer, samples_per_pixel)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", w, h))
        f.write(q.tobytes())


def read_binary(path: str) -> np.ndarray:
    """Inverse of write_binary (for tests/tools): uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(w * h * 3), np.uint8)
    return data.reshape(h, w, 3)


SAVERS = {
    "ppm": write_ppm,
    "png": write_png,
    "bin": write_binary,
}


class ThreadedWriter:
    """Background-thread frame writer.

    The encode (zlib for PNG releases the GIL) and disk write happen off
    the render loop so the accelerator starts frame n+1 while frame n is
    written — the reference writes synchronously in-loop
    (camera.cu:211-215). Exceptions from the worker are re-raised at
    wait()/close() so a full disk is not silently ignored.
    """

    def __init__(self, max_queued: int = 4):
        import queue
        import threading

        self._q = queue.Queue(maxsize=max_queued)
        self._err = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                path, fb, divisor, fmt = item
                SAVERS[fmt](path, fb, divisor)
            except Exception as e:  # surfaced at wait()/close()
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, path: str, framebuffer: np.ndarray, divisor: int,
               fmt: str = "png") -> None:
        self._q.put((path, framebuffer, divisor, fmt))

    def wait(self) -> None:
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        # Shut the worker down even when wait() re-raises a write error
        # (otherwise the sentinel is never sent and the daemon thread leaks).
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join()
