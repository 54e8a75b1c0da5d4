"""The reduction of the program's spans (rtbench/harness/spans.py) and the
span metrics' readers, on synthetic traces and readings."""

import pytest

from rtbench.harness import spans, spec, trace

READERS = ("setup_kernels_s", "setup_scene_s", "fetch_idle_pct", "band_allreduce_pct")


def _x(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur)}
    if args:
        e["args"] = args
    return e


# a window 100-200 us: one frame (110-190) holding a fetch (150-170) and a band's
# all_reduce (120-140); a kernel launched in the all_reduce, one in the frame
# alone, one whose launch the trace lacks
EVENTS = [
    _x("user_annotation", trace.WINDOW, 100, 100),
    _x("user_annotation", "tracer.frame", 110, 80),
    _x("user_annotation", "tracer.band.all_reduce", 120, 20),
    _x("user_annotation", "tracer.frame.fetch", 150, 20),
    _x("user_annotation", "rtbench.other", 100, 100),
    _x("cuda_runtime", "cudaLaunchKernel", 125, 2, correlation=7),
    _x("cuda_driver", "cuLaunchKernelEx", 115, 2, correlation=8),
    _x("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
       130, 15, correlation=7),
    _x("kernel", "void trace_kernel<false>(Launch)", 160, 5, correlation=8),
    _x("kernel", "void add(float*)", 180, 30, correlation=99),
    _x("cpu_op", "aten::to", 148, 25),
]


def _reduce(events):
    red = trace.reduce_events(events)
    w0 = next(e["ts"] for e in events if e["name"] == trace.WINDOW)
    busy = sorted((max(w0, e["ts"]), e["ts"] + e["dur"]) for e in events
                  if e["cat"] in trace.DEVICE_CATS)
    return red, spans.reduce(events, w0, w0 + 100.0, trace._union(busy)[1])


def test_idle_time_goes_to_the_innermost_span():
    _red, got = _reduce(EVENTS)
    idle = got["idle_by_span"]
    # device busy 130-145, 160-165, 180-200: idle 100-130, 145-160, 165-180
    assert idle[spans.OUTSIDE] == pytest.approx(10e-6)  # 100-110
    assert idle["tracer.frame"] == pytest.approx(25e-6)  # 110-120, 145-150, 170-180
    assert idle["tracer.band.all_reduce"] == pytest.approx(10e-6)  # 120-130
    assert idle["tracer.frame.fetch"] == pytest.approx(15e-6)  # 150-160, 165-170
    assert sum(idle.values()) == pytest.approx(60e-6)
    assert "rtbench.other" not in idle and "rtbench.other" not in got["spans"]
    assert got["spans"]["tracer.frame"] == [1, pytest.approx(80e-6)]


def test_kernels_go_to_the_span_of_their_launch():
    _red, got = _reduce(EVENTS)
    k = got["span_kernels"]
    assert k["tracer.band.all_reduce"] == pytest.approx(15e-6)
    assert k["tracer.frame"] == pytest.approx(5e-6)
    assert k[spans.OUTSIDE] == pytest.approx(20e-6)  # no launch; 180-200 of it in the window


def test_span_events_leave_the_breakdown_as_it_was():
    """The program's spans leave the device ops and the idle gaps' lengths
    as they were, and name each gap by the span innermost over most of it
    (the first of equals); with no span open, by the host operation."""
    plain = [e for e in EVENTS if not e["name"].startswith("tracer.")]
    spanned = trace.breakdown(trace.reduce_events(EVENTS))
    bare = trace.breakdown(trace.reduce_events(plain))
    assert spanned["device_ops"] == bare["device_ops"]
    assert [s for _n, s in spanned["idle_gaps"]] == [s for _n, s in bare["idle_gaps"]]
    # idle 100-130: 10 us outside, 10 in the frame, 10 in the all_reduce;
    # 145-160: 5 in the frame, 10 in the fetch; 165-180: 5 in the fetch, 10 in the frame
    assert [n for n, _s in spanned["idle_gaps"]] == [
        "tracer.frame", "tracer.frame.fetch", "tracer.frame"]
    assert [n for n, _s in bare["idle_gaps"]] == [
        "no host operation recorded", "aten::to", "aten::to"]
    _red, got = _reduce(plain)
    assert got["spans"] == {} and set(got["idle_by_span"]) == {spans.OUTSIDE}


def test_the_reduced_trace_carries_the_spans():
    red, got = _reduce(EVENTS)
    assert (red.spans, red.idle_by_span, red.span_kernels) == (
        got["spans"], got["idle_by_span"], got["span_kernels"])
    assert sum(red.idle_by_span.values()) == pytest.approx(red.window_s - red.busy_s)
    assert red.spans["tracer.frame.fetch"] == [1, pytest.approx(20e-6)]


def test_setup_spans_and_their_union():
    taken = [("tracer.scene.build", 1_000_000_000, 1_500_000_000),
             ("tracer.kernels.load", 2_000_000_000, 2_250_000_000),
             ("tracer.frame", 3_000_000_000, 4_000_000_000)]
    got = spans.setup(taken, 0.5, 3.5)
    assert [g[0] for g in got] == ["tracer.scene.build", "tracer.kernels.load"]
    assert got[0][1:] == [pytest.approx(0.5), pytest.approx(1.0)]
    assert spans.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert spans.union_s([]) == 0.0


def _readings():
    setup = [["tracer.scene.build", 1.0, 1.4], ["tracer.scene.build", 1.1, 1.3],
             ["tracer.bvh.build", 1.2, 1.35], ["tracer.scene.texture", 1.35, 1.45],
             ["tracer.kernels.build", 2.0, 3.0], ["tracer.launch", 1.9, 4.0],
             ["tracer.kernels.load", 3.0, 3.2], ["tracer.writer.open", 4.0, 4.1]]
    rank = lambda fetch, allreduce: {
        "setup_spans": setup, "setup_total_s": 5.0, "window_s": 10.0,
        "spans": {"tracer.frame": [3, 9.0], "tracer.band.all_reduce": [45, 1.0]},
        "idle_by_span": {"tracer.frame.fetch": fetch, spans.OUTSIDE: 0.01},
        "span_kernels": {"tracer.band.all_reduce": allreduce, "tracer.launch": 9.0}}
    return {"ranks": [rank(0.02, 0.3), rank(0.04, 0.5)]}


def test_span_readers_on_synthetic_readings():
    read = lambda name, r: spec.metric_reader(name).read(r)
    r = _readings()
    assert read("setup_kernels_s", r) == pytest.approx(2.1)  # 1.9-4.0
    assert read("setup_scene_s", r) == pytest.approx(0.45)  # 1.0-1.45
    assert read("fetch_idle_pct", r) == pytest.approx(0.3)  # (0.2% + 0.4%) / 2
    assert read("band_allreduce_pct", r) == pytest.approx(4.0)  # (3% + 5%) / 2


@pytest.mark.parametrize("name", READERS)
def test_span_readers_read_nothing_without_spans(name):
    reader = spec.metric_reader(name)
    assert reader.read({}) is None
    bare = {"ranks": [{"busy_s": 9.0, "window_s": 10.0, "device_events": 5}]}
    assert reader.read(bare) is None
    r = _readings()
    for rank in r["ranks"]:
        rank["setup_spans"] = [["tracer.writer.open", 4.0, 4.1]]
        rank["spans"] = {"tracer.writer.open": [1, 0.1]}
    assert reader.read(r) is None
