"""The program's named spans (tracer_torch.utils.profiling.span): off by
default and then invisible, on they nest, order and reach torch.profiler's
trace as user annotations; and where the frame driver, the scene and BVH
builders, the kernels' build and the row bands record them."""

import datetime
import io
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tracer_torch.dist import sharding
from tracer_torch.kernels import nvcc
from tracer_torch.render import driver
from tracer_torch.scene import builders, config
from tracer_torch.utils import profiling

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_driver import _small_config  # noqa: E402
from torch_scenes import one_torch_thread  # noqa: E402,F401


@pytest.fixture
def spans_on():
    profiling.take_spans()
    profiling.set_spans(True)
    try:
        yield
    finally:
        profiling.set_spans(False)
        profiling.take_spans()


def _profiled_events(fn, tmp_path):
    """The Chrome trace events of torch.profiler around fn()."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _frame_run(tmp_path, frames=3):
    params = config.read_scene_params(_small_config(tmp_path, frames).read_text())
    scene = builders.create_scene(params, device="cpu")
    return lambda: driver.render_animation(scene, params, engine="torch", out=io.StringIO())


def test_spans_off_record_nothing_and_share_one_context(monkeypatch):
    assert not profiling._SPANS_ON  # off at import
    fail = lambda *a: pytest.fail("an off span read the clock or entered record_function")
    monkeypatch.setattr(profiling, "time", SimpleNamespace(perf_counter_ns=fail))
    monkeypatch.setattr(profiling, "torch",
                        SimpleNamespace(profiler=SimpleNamespace(record_function=fail)))
    a, b = profiling.span("tracer.a"), profiling.span("tracer.b")
    assert a is b
    with a:
        with b:
            pass
    assert profiling.take_spans() == []


def test_render_animation_with_spans_off_puts_no_span_in_a_trace(tmp_path):
    run = _frame_run(tmp_path, frames=2)
    events = _profiled_events(run, tmp_path)
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert not [e for e in events if e.get("name", "").startswith("tracer.")]
    assert profiling.take_spans() == []


def test_spans_nest_in_order_and_reach_the_trace(spans_on, tmp_path):
    def work():
        with profiling.span("tracer.outer"):
            with profiling.span("tracer.outer.first"):
                torch.ones(8) @ torch.ones(8)
            with profiling.span("tracer.outer.second"):
                pass

    events = _profiled_events(work, tmp_path)
    spans = profiling.take_spans()
    assert [s[0] for s in spans] == ["tracer.outer", "tracer.outer.first", "tracer.outer.second"]
    outer, first, second = spans
    assert _inside(first, outer) and _inside(second, outer) and first[2] <= second[1]
    marks = {e["name"]: e for e in events if e.get("name", "").startswith("tracer.")}
    assert set(marks) == {s[0] for s in spans}
    assert all(e["cat"] == "user_annotation" and e["ph"] == "X" for e in marks.values())
    a, b = marks["tracer.outer"], marks["tracer.outer.first"]
    assert a["ts"] <= b["ts"] and b["ts"] + b["dur"] <= a["ts"] + a["dur"]


def test_take_spans_clears_the_list(spans_on):
    with profiling.span("tracer.one"):
        pass
    assert [s[0] for s in profiling.take_spans()] == ["tracer.one"]
    assert profiling.take_spans() == []
    profiling.set_spans(False)
    with profiling.span("tracer.two"):
        pass
    assert profiling.take_spans() == []


def test_span_ends_when_its_block_raises(spans_on):
    with pytest.raises(ValueError):
        with profiling.span("tracer.failing"):
            raise ValueError("inside")
    (name, start, end), = profiling.take_spans()
    assert name == "tracer.failing" and start <= end


def test_frame_loop_spans(spans_on, tmp_path):
    """One `tracer.frame` a frame, each holding its camera and then the
    previous frame's synchronize, fetch and submit in that order (the loop
    is one frame deep); the last frame's three after the last
    `tracer.frame`; the writer's open before the first frame and its drain
    after the last frame's submit."""
    run = _frame_run(tmp_path, frames=3)
    profiling.take_spans()  # the scene's
    run()
    spans = profiling.take_spans()
    frames = [s for s in spans if s[0] == "tracer.frame"]
    assert len(frames) == 3
    handoff = ["tracer.frame.sync", "tracer.frame.fetch", "tracer.frame.submit"]
    for k, f in enumerate(frames):
        inner = [s for s in spans if s[0].startswith("tracer.frame.") and _inside(s, f)]
        assert [s[0] for s in inner] == ["tracer.frame.camera"] + (handoff if k else [])
    opened = [s for s in spans if s[0] == "tracer.writer.open"]
    drained = [s for s in spans if s[0] == "tracer.writer.drain"]
    assert len(opened) == 1 and len(drained) == 1
    closing = [s for s in spans if frames[-1][2] <= s[1] and s[2] <= drained[0][1]]
    assert [s[0] for s in closing] == handoff
    assert opened[0][2] <= frames[0][1] and closing[-1][2] <= drained[0][1]
    assert len(spans) == 2 + 5 * 3


def test_scene_and_bvh_spans(spans_on, tmp_path):
    params = config.read_scene_params(_small_config(tmp_path).read_text())
    params.floor.texture_path = "floor.jpg"
    tex = np.full((4, 5, 3), 0.5, np.float32)
    scene = builders.create_scene(params, with_bvh=True, texture_loader=lambda _p: tex,
                                  device="cpu")
    assert scene.textures is not None and scene.bvh is not None
    spans = profiling.take_spans()
    assert [s[0] for s in spans] == ["tracer.scene.build", "tracer.scene.build",
                                     "tracer.bvh.build", "tracer.scene.texture"]
    outer = spans[0]
    assert all(_inside(s, outer) for s in spans[1:])


def test_kernel_build_and_load_spans(spans_on, tmp_path, monkeypatch):
    """nvcc runs (stubbed) inside `tracer.kernels.build` when a library is
    missing; the libraries load inside `tracer.kernels.load`; a second
    build, with every library on disk, loads only."""
    started, loaded = [], []

    class Proc:
        returncode = 0

        def __init__(self, argv, **kw):
            started.append(argv)
            out = argv[argv.index("-o") + 1]
            with open(out, "wb") as f:
                f.write(b"so")

        def communicate(self):
            return ("ptxas info", None)

    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nvcc, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", Proc)
    monkeypatch.setattr(nvcc.ctypes, "CDLL", lambda path: loaded.append(path) or path)
    sources = nvcc.sources()
    builds = nvcc.build_all.__wrapped__()
    assert set(builds) == {s.stem for s in sources} and len(started) == len(sources)
    spans = profiling.take_spans()
    assert [s[0] for s in spans] == ["tracer.kernels.build", "tracer.kernels.load"]
    assert spans[0][2] <= spans[1][1] and len(loaded) == len(sources)
    nvcc.build_all.__wrapped__()
    assert [s[0] for s in profiling.take_spans()] == ["tracer.kernels.load"]
    assert len(started) == len(sources)


def test_row_band_spans(spans_on, tmp_path):
    """A band's render and its all_reduce, in that order, each its own span
    (one gloo rank on the CPU)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = sharding.Mesh(None, 1, 0, torch.device("cpu"))
        render = lambda scene, cam, w, rows, row_offset: torch.ones((rows, w, 3))
        fb = sharding._frame_by_bands(render, None, None, 4, 3, mesh)
    finally:
        dist.destroy_process_group()
    assert torch.equal(fb, torch.ones((3, 4, 3)))
    spans = profiling.take_spans()
    assert [s[0] for s in spans] == ["tracer.band.render", "tracer.band.all_reduce"]
    assert spans[0][2] <= spans[1][1]
