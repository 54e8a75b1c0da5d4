"""tracer_torch.utils (resilience, profiling, debug), the native frame
writer (tracer_torch.io.native, built here with g++) and their use in the
frame driver, against tracer.utils and tracer.io.image where tracer has
the same function.

Tolerances: none; the writer's files are byte-equal to tracer.io.image's
savers, and to tracer's own native writer wherever its quantize (a
multiply by the divisor's float reciprocal) rounds as the division does;
retried frames are bit-equal to frames that were not retried.
"""

import ctypes
import io
import os
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

from tracer.io import image as jax_image
from tracer.io import native as jax_native
from tracer.utils import debug as jax_debug
from tracer.utils import resilience as jax_resilience
from tracer_torch.dist import sharding
from tracer_torch.io import image as image_io
from tracer_torch.io import native as io_native
from tracer_torch.render import driver, renderer
from tracer_torch.scene import builders, config
from tracer_torch.utils import debug, profiling, resilience

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_driver import _small_config  # noqa: E402
from torch_scenes import one_torch_thread  # noqa: E402,F401
from torch_scenes import within  # noqa: E402


# ---- resilience (tracer's tests/test_utils.py:82-122 cases) --------------------

def test_retries_transient_then_succeeds():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("UNAVAILABLE: TPU worker process crashed")
        return 42

    assert resilience.retry_transient(flaky, retries=3, backoff_s=0.0) == 42
    assert len(calls) == 3


def test_non_transient_raises_immediately():
    calls = []

    def broken():
        calls.append(1)
        raise ValueError("shape mismatch [3] vs [4]")

    with pytest.raises(ValueError):
        resilience.retry_transient(broken, retries=5, backoff_s=0.0)
    assert len(calls) == 1


def test_exhausted_retries_propagate():
    def always_down():
        raise RuntimeError("DEADLINE_EXCEEDED: backend unreachable")

    with pytest.raises(RuntimeError, match="DEADLINE_EXCEEDED"):
        resilience.retry_transient(always_down, retries=2, backoff_s=0.0)


@pytest.mark.parametrize("marker", jax_resilience.TRANSIENT_MARKERS)
def test_tracer_markers_are_transient_as_in_tracer(marker):
    err = RuntimeError(f"backend said: {marker} (details)")
    assert resilience.is_transient(err) and jax_resilience.is_transient(err)


# torch.distributed's spellings of a dropped connection, a collective
# timeout and the store's timeouts, as its errors read
DIST_MESSAGES = {
    "gloo dropped connection": "[gloo/transport/tcp/pair.cc:598] Connection closed by peer "
                               "[127.0.0.1]:51234",
    "gloo closed socket": "[gloo/transport/tcp/pair.cc:534] Socket unexpectedly closed",
    "gloo recv timeout": "[gloo/transport/tcp/unbound_buffer.cc:81] Timed out waiting 30000ms "
                         "for recv operation to complete",
    "gloo send timeout": "[gloo/transport/tcp/unbound_buffer.cc:133] Timed out waiting 30000ms "
                         "for send operation to complete",
    "store socket timeout": "Socket Timeout",
    "store key wait": "wait timeout after 300000ms, keys: /default_pg/0//cuda//0",
    "store rendezvous": "Timed out after 301 seconds waiting for clients. 1/2 clients joined.",
    "refused": "The client socket has failed to connect to [localhost]:29500 (errno: 111 - "
               "Connection refused).",
}


@pytest.mark.parametrize("name", sorted(DIST_MESSAGES))
def test_torch_distributed_spellings_are_transient(name):
    err = torch.distributed.DistNetworkError(DIST_MESSAGES[name])
    assert resilience.is_transient(err)
    calls = []

    def once():
        calls.append(1)
        if len(calls) == 1:
            raise err
        return "ok"

    assert resilience.retry_transient(once, retries=1, backoff_s=0.0) == "ok"


CUDA_FAULTS = {
    "illegal address": RuntimeError("CUDA error: an illegal memory access was encountered\n"
                                    "Compile with `TORCH_USE_CUDA_DSA` to enable device-side "
                                    "assertions. (UNAVAILABLE)"),
    "kernel launch": RuntimeError("megakernel launch failed: CUDA error 700"),
    "out of memory": torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    "cudaError": RuntimeError("cudaErrorIllegalAddress: Connection reset"),
}


@pytest.mark.parametrize("name", sorted(CUDA_FAULTS))
def test_cuda_errors_are_never_retried(name):
    """A faulted CUDA context is sticky: every later call in the process
    fails too, so a CUDA error is not transient even where its message
    carries a transient marker."""
    err = CUDA_FAULTS[name]
    assert resilience.is_cuda_fault(err) and not resilience.is_transient(err)
    calls = []

    def faulted():
        calls.append(1)
        raise err

    with pytest.raises(type(err)):
        resilience.retry_transient(faulted, retries=3, backoff_s=0.0)
    assert len(calls) == 1


def _scene_and_params(tmp_path, frames=2):
    params = config.read_scene_params(_small_config(tmp_path, frames).read_text())
    return builders.create_scene(params, device="cpu"), params


def test_driver_retries_the_whole_frame(tmp_path, monkeypatch, capsys):
    """A transient failure in a frame's second spp chunk: the retry renders
    every chunk of that frame again (it does not continue the partial
    sum), prints tracer's stderr line, and the frames equal a run that
    did not fail."""
    scene, params = _scene_and_params(tmp_path, frames=2)
    want = driver.render_animation(scene, params, engine="torch", out=io.StringIO(),
                                   spp_chunk=2, rng_mode="reference")
    want_files = [image_io.read_binary(str(tmp_path / f"out_{n}.bin")) for n in range(2)]
    real = renderer.render_frame
    calls = []

    def flaky(*a, **kw):
        calls.append(kw["sample_start"])
        if len(calls) == 2:
            raise RuntimeError("UNAVAILABLE: connection dropped mid-frame")
        return real(*a, **kw)

    monkeypatch.setattr(renderer, "render_frame", flaky)
    monkeypatch.setattr(driver, "RETRY_BACKOFF_S", 0.0)
    out = io.StringIO()
    got = driver.render_animation(scene, params, engine="torch", out=out, spp_chunk=2,
                                  rng_mode="reference", retries=2)
    assert calls == [0, 2, 0, 2, 0, 2]  # frame 0 twice (its 2nd chunk failed), then frame 1
    np.testing.assert_array_equal(got, want)
    for n in range(2):
        np.testing.assert_array_equal(image_io.read_binary(str(tmp_path / f"out_{n}.bin")),
                                      want_files[n])
    assert [line.split("\t")[0] for line in out.getvalue().splitlines()] == ["0", "1"]
    retried = [x for x in capsys.readouterr().err.splitlines() if "transient" in x]
    assert retried == ["tracer: frame 0 transient backend failure (retry 1): UNAVAILABLE: "
                       "connection dropped mid-frame"]


def test_driver_does_not_retry_a_cuda_error(tmp_path, monkeypatch):
    scene, params = _scene_and_params(tmp_path, frames=1)
    calls = []

    def faulted(*a, **kw):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(renderer, "render_frame", faulted)
    monkeypatch.setattr(driver, "RETRY_BACKOFF_S", 0.0)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        driver.render_animation(scene, params, engine="torch", out=io.StringIO(), retries=3)
    assert len(calls) == 1


def test_driver_refuses_retries_with_a_mesh(tmp_path):
    scene, params = _scene_and_params(tmp_path, frames=1)
    mesh = sharding.Mesh(None, 2, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="one rank retrying alone"):
        driver.render_animation(scene, params, engine="torch", out=io.StringIO(), mesh=mesh,
                                retries=1)
    with pytest.raises(ValueError, match="retries must be"):
        driver.render_animation(scene, params, engine="torch", out=io.StringIO(), retries=-1)
    assert not list(tmp_path.glob("out_*"))


# ---- profiling -----------------------------------------------------------------

def test_profile_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "prof"
    with profiling.profile_trace(str(log_dir)) as prof:
        x = torch.ones(64, 64)
        profiling.sync(x @ x)
    trace = (log_dir / "trace.json").read_text()
    assert "aten::mm" in trace
    assert any(e.key == "aten::mm" for e in prof.key_averages())


# ---- debug ---------------------------------------------------------------------

class Pair(NamedTuple):
    good: np.ndarray
    bad: np.ndarray


@pytest.mark.parametrize("tree, path", [
    ({"a": [np.ones(2), np.array([1.0, np.nan])]}, "['a'][1]"),
    (Pair(np.ones(3), np.array([np.inf, 0.0, -np.inf])), ".bad"),
    ([np.ones(2), {"x": Pair(np.ones(1), np.array([np.nan]))}], "[1]['x'].bad"),
], ids=["dict-list", "namedtuple", "nested"])
def test_check_finite_names_the_leaf_as_tracer_does(tree, path):
    with pytest.raises(FloatingPointError) as ours:
        debug.check_finite(tree, "scene")
    with pytest.raises(FloatingPointError) as theirs:
        jax_debug.check_finite(tree, "scene")
    assert str(ours.value) == str(theirs.value)
    assert str(ours.value).startswith(f"scene{path}: ")


def test_check_finite_walks_tensors_and_dataclasses():
    import dataclasses

    @dataclasses.dataclass
    class Grads:
        albedo: torch.Tensor
        count: int

    tree = {"g": Grads(torch.tensor([[1.0, float("nan")], [float("inf"), 2.0]]), 3),
            "ok": [torch.ones(2), torch.arange(3)]}
    with pytest.raises(FloatingPointError, match=r"^grads\['g'\]\.albedo: 2/4 non-finite"):
        debug.check_finite(tree, "grads")
    debug.check_finite({"ok": [torch.ones(2), torch.arange(3)], "s": "text"})  # no raise


@pytest.mark.parametrize("fb, message", [
    (np.array([[[0.0, 1.0, np.nan]]]), "non-finite pixels"),
    (torch.tensor([[[0.5, -1e-3, 0.0]]]), "negative radiance"),
    (np.zeros((2, 2, 3)), None),
], ids=["nan", "negative", "ok"])
def test_check_framebuffer(fb, message):
    if message is None:
        debug.check_framebuffer(fb)
        jax_debug.check_framebuffer(np.asarray(fb))
        return
    with pytest.raises(FloatingPointError, match=message):
        debug.check_framebuffer(fb)
    with pytest.raises(FloatingPointError, match=message):
        jax_debug.check_framebuffer(np.asarray(fb))


def test_debug_nans_is_scoped_and_checks_the_backward():
    x = torch.tensor([0.0], requires_grad=True)
    before = torch.is_anomaly_enabled()
    with debug.debug_nans():
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        y = torch.sqrt(x) * 0.0  # forward 0, backward 0 * inf = NaN
        with pytest.raises(RuntimeError, match="nan"):
            y.backward()
    assert torch.is_anomaly_enabled() == before
    x.grad = None
    (torch.sqrt(x) * 0.0).backward()  # outside the scope: a NaN gradient, silently
    assert torch.isnan(x.grad).all()


# ---- the native frame writer -----------------------------------------------------

def _quantize_by_reciprocal(fb, divisor):
    """tracer's native quantize (frame_writer.cpp): the sum times the
    divisor's float reciprocal, where io/image.py divides."""
    c = np.asarray(fb, np.float32) * np.float32(1.0 / divisor)
    g = np.sqrt(np.maximum(c, np.float32(0.0)))
    return (np.float32(256.0) * np.clip(g, np.float32(0.0), np.float32(0.999))).astype(np.uint8)


def _frames(n=3, shape=(24, 40)):
    """Seeded raw sums; the first frame's leading values are ones where
    dividing by 3 and multiplying by the float 1/3 quantize differently."""
    g = np.random.default_rng(7)
    frames = [(g.uniform(0.0, 1.0, shape + (3,)) ** 2 * 3).astype(np.float32) for _ in range(n)]
    pool = (g.uniform(0.0, 1.0, 1 << 21) ** 2 * 3).astype(np.float32)
    split = pool[_quantize_by_reciprocal(pool, 3) != image_io.quantize(pool, 3)]
    assert split.size >= 2
    frames[0].reshape(-1)[:split.size] = split
    return frames


def test_native_writer_is_built_with_gpp():
    assert io_native.available()
    assert io_native.library_path().name.startswith("libtracer_io-")
    assert io_native.library_path().parent.parts[-2:] == ("build", "tracer_torch")


@pytest.mark.parametrize("fmt", ["bin", "ppm"])
@pytest.mark.parametrize("divisor", [1, 3, 4])
def test_native_writer_bytes_equal_the_python_savers(tmp_path, fmt, divisor):
    frames = _frames()

    def write():
        with io_native.AsyncFrameWriter() as w:
            for k, fb in enumerate(frames):
                w.submit(str(tmp_path / f"native_{k}"), fb, divisor, fmt=fmt)

    within(60, write)
    for k, fb in enumerate(frames):
        jax_image.SAVERS[fmt](str(tmp_path / f"tracer_{k}"), fb, divisor)
        image_io.SAVERS[fmt](str(tmp_path / f"python_{k}"), fb, divisor)
        want = (tmp_path / f"tracer_{k}").read_bytes()
        assert (tmp_path / f"native_{k}").read_bytes() == want
        assert (tmp_path / f"python_{k}").read_bytes() == want


@pytest.fixture(scope="module")
def tracer_writer_lib(tmp_path_factory):
    """tracer's own frame_writer.cpp, built with the port's flags, bound
    as tracer/io/native binds it (its submit takes 1 / divisor)."""
    src = os.path.join(os.path.dirname(jax_native.__file__), "frame_writer.cpp")
    so = tmp_path_factory.mktemp("tracer_writer") / "libtracer_io.so"
    subprocess.run(["g++", *io_native.CXX_FLAGS, "-o", str(so), src], check=True, timeout=240)
    lib = ctypes.CDLL(str(so))
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


@pytest.mark.parametrize("fmt", ["bin", "ppm"])
@pytest.mark.parametrize("divisor", [1, 3, 4])
def test_native_writer_against_tracers_native_writer(tmp_path, tracer_writer_lib, fmt,
                                                     divisor):
    """Byte-equal to tracer's writer where the divisor is a power of two;
    at 3 the frames differ exactly where tracer's reciprocal quantize rounds
    to another byte than the division (the port's one change)."""
    fb = _frames(1)[0]
    h, w, _ = fb.shape
    lib = tracer_writer_lib
    handle = lib.tracer_writer_create()
    lib.tracer_writer_submit(handle, fb.reshape(-1), w, h, 1.0 / divisor,
                             os.fsencode(tmp_path / "tracer"), io_native.FORMATS[fmt])
    within(60, lib.tracer_writer_wait, handle)
    assert lib.tracer_writer_failures(handle, None, 0) == 0
    lib.tracer_writer_destroy(handle)

    def write():
        with io_native.AsyncFrameWriter() as writer:
            writer.submit(str(tmp_path / "port"), fb, divisor, fmt=fmt)

    within(60, write)
    ours, theirs = (tmp_path / "port").read_bytes(), (tmp_path / "tracer").read_bytes()
    split = _quantize_by_reciprocal(fb, divisor) != image_io.quantize(fb, divisor)
    assert split.any() == (divisor == 3)
    if fmt == "bin":
        assert ours[:8] == theirs[:8]
        differ = np.frombuffer(ours[8:], np.uint8) != np.frombuffer(theirs[8:], np.uint8)
        np.testing.assert_array_equal(differ, split.reshape(-1))
    else:
        assert ours.split(b"\n")[:3] == theirs.split(b"\n")[:3]
        ours_px = np.array(ours.split()[4:], np.uint8)
        theirs_px = np.array(theirs.split()[4:], np.uint8)
        np.testing.assert_array_equal(ours_px, image_io.quantize(fb, divisor).reshape(-1))
        np.testing.assert_array_equal(theirs_px, _quantize_by_reciprocal(fb, divisor).reshape(-1))
    if divisor != 3:
        assert ours == theirs


def test_native_writer_reports_a_failed_write(tmp_path):
    w = io_native.AsyncFrameWriter()
    w.submit(str(tmp_path / "missing_dir" / "f.bin"), _frames(1)[0], 2)
    w.submit(str(tmp_path / "ok.bin"), _frames(1)[0], 2)
    with pytest.raises(OSError, match="1 write\\(s\\) failed .*cannot open"):
        within(60, w.wait)
    with pytest.raises(OSError, match="cannot open"):
        within(60, w.close)  # stops the thread and still reports
    within(60, w.close)  # a second close does nothing
    assert (tmp_path / "ok.bin").exists()


def test_driver_writes_bin_and_ppm_with_the_native_writer(tmp_path, monkeypatch):
    scene, params = _scene_and_params(tmp_path, frames=2)
    made = []
    real = driver.frame_writer
    monkeypatch.setattr(driver, "frame_writer", lambda saver: made.append(real(saver)) or made[-1])
    for fmt in ("bin", "ppm"):
        fb = driver.render_animation(scene, params, engine="torch", out=io.StringIO(),
                                     saver=fmt, frames=[1])
        assert isinstance(made[-1], io_native.AsyncFrameWriter)
        image_io.SAVERS[fmt](str(tmp_path / "want"), fb, 2)
        assert (tmp_path / "out_1.bin").read_bytes() == (tmp_path / "want").read_bytes()
    assert isinstance(real("png"), image_io.ThreadedWriter)


def test_driver_reports_a_failed_native_write(tmp_path):
    scene, params = _scene_and_params(tmp_path, frames=1)
    params.output_path = str(tmp_path / "nowhere" / "out_%d.bin")
    with pytest.raises(OSError, match="cannot open"):
        driver.render_animation(scene, params, engine="torch", out=io.StringIO())


def test_without_gpp_the_driver_takes_the_thread_writer(monkeypatch):
    monkeypatch.setattr(io_native, "available", lambda: False)
    assert isinstance(driver.frame_writer("bin"), image_io.ThreadedWriter)
