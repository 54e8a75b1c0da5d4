"""The harness on the CPU: BENCHMARK.json against the contract's rules, the
files each cell is made of, a cell and a scene kind with its own estimator
and cut added as files alone, no JAX anywhere,
no result without a card, the roofline counts, the trace reduction, the
faults and the control the check has to reject. Cells run cut to a CPU
size (tiny.py) with the plain renderer."""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from rtbench.harness import check, spec, trace
from rtbench.tests import tiny

ROOT = spec.ROOT
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
ONE_CARD = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
TIMEOUT = 600


def run_tiny(cell, seed, seconds, *patches, trace_on=False, cwd=ROOT):
    """A tiny run in a process of its own, with a temporary directory of its
    own (the frames go there; tests run side by side)."""
    tmp = tempfile.mkdtemp(prefix="rtbench_test_")
    try:
        proc = subprocess.run([sys.executable, str(Path(cwd) / "rtbench/tests/tiny.py"), cell,
                               str(seed), str(seconds), str(int(trace_on)), *patches],
                              capture_output=True, text=True, timeout=TIMEOUT, cwd=cwd,
                              env=dict(os.environ, TMPDIR=tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---- BENCHMARK.json ----------------------------------------------------------

def test_benchmark_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "rtbench/run.py"] and BENCH["paths"] == ["rtbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"rtbench/configs/{c['name']}.json" and (ROOT / c["file"]).is_file()
        assert all(spec.NAME_RE.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert spec.NAME_RE.match(w["config"]) and spec.NAME_RE.match(w["traffic"])
        names.append(w["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(spec.NAME_RE.match(n) for n in names) and len(names) == len(set(names))
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + [
            c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_what_it_must():
    for name in CELLS:
        wl = spec.workload(name)
        assert "setup_s" in {m["name"] for m in wl.end_to_end} and len(wl.end_to_end) >= 2
        assert wl.per_layer
        for m in wl.per_layer:
            assert m["moves"] in {e["name"] for e in wl.end_to_end}


def test_roofline_names_and_units():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
        if "roofline" in m["name"]:
            assert re.fullmatch(r"[a-z0-9_]+_roofline", m["name"])


# ---- files by name -------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    wl = spec.workload(cell)
    assert spec.entry(wl.traffic["entry"]).run
    kind = spec.scene_kind(wl.config["scene"])
    assert kind.inputs and kind.program and kind.reference
    assert set(wl.check["numbers"]) == {"frames_missing", "byte_gap", "fb_rel_err", "fb_rel_p10"}
    for m in wl.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A configuration, a traffic mix, a check and a per-layer metric, each a
    new file, and the cell and metric appended to BENCHMARK.json: the copy
    runs the new cell with no file of the harness edited."""
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = spec.load_json(ROOT / "rtbench/configs/config_txt.json")
    cfg["text"][-1] = "8 2"
    (tmp_path / "rtbench/configs/config_d8.json").write_text(json.dumps(cfg))
    traffic = dict(spec.load_json(ROOT / "rtbench/traffic/frames.json"), spp_chunk=2)
    (tmp_path / "rtbench/traffic/frames_c2.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / "rtbench/checks/config_txt.frames.json",
                tmp_path / "rtbench/checks/config_d8.frames_c2.json")
    (tmp_path / "rtbench/metrics/frames_in_window.py").write_text(
        "def read(readings):\n    return float(readings['ranks'][0]['facts']['frames'])\n")
    bench["configs"].append({"name": "config_d8", "source": "https://example.org/d8",
                             "file": "rtbench/configs/config_d8.json", "reduced": [],
                             "why": "depth 8"})
    bench["workloads"].append({"name": "config_d8.frames_c2", "config": "config_d8",
                               "traffic": "frames_c2", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({"name": "frames_in_window", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "driver", "moves": "mrays_per_s",
                               "workloads": ["config_d8.frames_c2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    os.symlink(ROOT / "tracer_torch", tmp_path / "tracer_torch")
    line = run_tiny("config_d8.frames_c2", 3, 0.5, trace_on=True, cwd=tmp_path)
    assert line["correct"], line
    assert line["metrics"]["frames_in_window"]["value"] == line["attempted"], line
    line = run_tiny("config_d8.frames_c2", 3, 0.5, cwd=tmp_path)
    assert line["correct"] and set(line["metrics"]) == {"mrays_per_s", "setup_s"}


WRAP_REFERENCE = """\"\"\"The plain estimator times GAIN: a scene kind's own estimator.\"\"\"

import torch

from rtbench.reference import plain

GAIN = {gain!r}


def render_samples(scene, cam, width, i, j, spp, max_depth, quirk, dtype=torch.float32):
    return plain.render_samples(scene, cam, width, i, j, spp, max_depth, quirk, dtype) * GAIN
"""

WRAP_KIND = """\"\"\"The sphere field with an estimator and a CPU cut of its own.\"\"\"

from rtbench.harness import spec
from rtbench.reference.field_wrap import render_samples  # noqa: F401

_field = spec.scene_kind("sphere_field")
inputs, program, reference = _field.inputs, _field.program, _field.reference


def tiny(cfg):
    return dict(_field.tiny(cfg), n=40)
"""


def _kind_copy(root, gain=1.0):
    """A copy of the benchmark with a new scene kind as files alone:
    `field_wrap` (rtbench/scenes/field_wrap.py) wraps `sphere_field` and
    brings its own estimator (rtbench/reference/field_wrap.py, the plain
    one times `gain`) and its own cut (40 spheres); its cell
    `field_wrap.frames_bvh` and a metric that reads the spheres built."""
    shutil.copytree(ROOT / "rtbench", root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "rtbench/reference/field_wrap.py").write_text(WRAP_REFERENCE.format(gain=gain))
    (root / "rtbench/scenes/field_wrap.py").write_text(WRAP_KIND)
    cfg = dict(spec.load_json(ROOT / "rtbench/configs/field_2k.json"), scene="field_wrap")
    (root / "rtbench/configs/field_wrap.json").write_text(json.dumps(cfg))
    shutil.copy(ROOT / "rtbench/checks/field_2k.frames_bvh.json",
                root / "rtbench/checks/field_wrap.frames_bvh.json")
    (root / "rtbench/metrics/spheres_in_scene.py").write_text(
        "def read(readings):\n    return float(readings['ranks'][0]['facts']['num_spheres'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "field_wrap", "source": "https://example.org/field",
                             "file": "rtbench/configs/field_wrap.json", "reduced": [],
                             "why": "the field under an estimator of its own"})
    bench["workloads"].append({"name": "field_wrap.frames_bvh", "config": "field_wrap",
                               "traffic": "frames_bvh", "chips": 1, "why": "a new kind"})
    bench["per_layer"].append({"name": "spheres_in_scene", "unit": "spheres", "better": "lower",
                               "source": "program_counter", "layer": "BVH",
                               "moves": "mrays_per_s", "workloads": ["field_wrap.frames_bvh"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    os.symlink(ROOT / "tracer_torch", root / "tracer_torch")
    return root


def test_a_scene_kind_added_as_files_alone_brings_its_estimator_and_cut(tmp_path):
    """A new scene kind, its estimator and its cut, each a new file: the
    copy runs its cell at the kind's own cut, correct."""
    line = run_tiny("field_wrap.frames_bvh", 2**31 + 21, 0.5, trace_on=True,
                    cwd=_kind_copy(tmp_path))
    assert line["correct"], line
    assert line["metrics"]["spheres_in_scene"]["value"] == 40, line


def test_the_check_reads_a_kinds_own_estimator(tmp_path):
    """The same kind with a 2% gain planted in its estimator alone: the
    sound program's run is not correct."""
    line = run_tiny("field_wrap.frames_bvh", 2**31 + 21, 0.5,
                    cwd=_kind_copy(tmp_path, gain=1.02))
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["fb_rel_p10"]["value"] > line["checks"]["fb_rel_p10"]["limit"]


def _cut_as_it_was(cfg):
    """tiny.py's cut of the two first kinds before the kinds owned it."""
    cfg = dict(cfg)
    if cfg["scene"] == "config_text":
        text = list(cfg["text"])
        text[2], text[-1] = "24 16 50", "5 4"
        cfg.update(text=text, texture=dict(cfg["texture"], height=13, width=20))
    else:
        cfg.update(n=60, width=24, height=16, sqrt_spp=4, max_depth=5)
    return cfg


@pytest.mark.parametrize("cell", ONE_CARD)
def test_a_kinds_cut_and_sums_are_the_plain_ones(cell):
    """The kinds' own `tiny` gives the configs tiny.py gave, and without an
    estimator of their own the check's sums are plain.render_samples' bit
    for bit, in the program's precision and the control's."""
    from rtbench.reference import plain

    wl = tiny.workload(cell)
    cut = tiny.tiny(wl)
    assert cut.config == _cut_as_it_was(wl.config)
    assert cut.check == dict(wl.check, pixels_per_frame=24 * 16)
    kind = spec.scene_kind(cut.config["scene"])
    assert not hasattr(kind, "render_samples")
    cpu, seed = torch.device("cpu"), 2**31 + 8
    inp = kind.inputs(cut.config, seed, cpu)
    for dtype in (torch.float32, torch.bfloat16):
        picks, got, st = check.reference_sums(cut, inp, seed, [0, 1], cpu, dtype)
        scene, camera, _ = kind.reference(inp, cut.config, cpu, dtype)
        w = st["width"]
        for (n, px), sums in zip(picks, got):
            t = torch.as_tensor(px)
            want = plain.render_samples(scene, camera(n), w, t % w, t // w, st["sqrt_spp"] ** 2,
                                        st["max_depth"], quirk=True, dtype=dtype).numpy()
            assert sums.dtype == np.float32 and np.array_equal(sums, want)


# ---- what a run may load, and where it may run ---------------------------------

def _top_level(code, cwd=ROOT):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=TIMEOUT, cwd=cwd)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(proc.stdout.split())


def test_a_run_loads_no_jax_and_the_reference_no_program(tmp_path):
    loaded = _top_level(
        f"import sys, tempfile; sys.path.insert(0, '.'); tempfile.tempdir = '{tmp_path}'\n"
        "from rtbench.tests import tiny\n"
        "from rtbench.harness import runner, spec\n"
        "import io\n"
        "runner.execute(tiny.ctx('config_txt.frames', 1, 0.3, True), out=io.StringIO())\n"
        "[spec.metric_reader(m['name']) for m in spec.benchmark()['per_layer']]\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "tracer_torch" in loaded and "rtbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "tracer"}
    ref = _top_level(
        "import sys, pkgutil, importlib; sys.path.insert(0, '.')\n"
        "import rtbench.reference as r\n"
        "[importlib.import_module('rtbench.reference.' + m.name) "
        "for m in pkgutil.iter_modules(r.__path__)]\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not ref & {"jax", "jaxlib", "flax", "tracer", "tracer_torch"}
    # a scene kind's own estimator: the run of its cell loads no JAX, the
    # estimator under rtbench/reference/ no program
    copy = _kind_copy(tmp_path / "copy")
    loaded = _top_level(
        f"import sys, tempfile; sys.path.insert(0, '.'); tempfile.tempdir = '{tmp_path}'\n"
        "from rtbench.tests import tiny\n"
        "from rtbench.harness import runner, spec\n"
        "import io\n"
        "runner.execute(tiny.ctx('field_wrap.frames_bvh', 1, 0.3, True), out=io.StringIO())\n"
        "assert spec.scene_kind('field_wrap').render_samples.__module__ == "
        "'rtbench.reference.field_wrap'\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))", cwd=copy)
    assert "tracer_torch" in loaded and not loaded & {"jax", "jaxlib", "flax", "tracer"}
    ref = _top_level(
        "import sys; sys.path.insert(0, '.')\n"
        "import rtbench.reference.field_wrap\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))", cwd=copy)
    assert "rtbench" in ref and not ref & {"jax", "jaxlib", "flax", "tracer", "tracer_torch"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from rtbench.harness import ranks

    monkeypatch.setitem(sys.modules, "tracer_torch_like", sys)
    assert "tracer_torch_like" not in ranks.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tracer.render", sys)
    assert ranks.forbidden_modules() == ["tracer.render"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "rtbench/run.py", "--workload", "config_txt.frames",
                           "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=TIMEOUT, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    """In a directory of BENCHMARK.json and rtbench/ alone there is no
    program: no result, a non-zero exit."""
    shutil.copytree(ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "rtbench/tests/tiny.py", "config_txt.frames", "1",
                           "0.3", "0"], capture_output=True, text=True, timeout=TIMEOUT,
                          cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


# ---- the per-layer readings -------------------------------------------------------

def test_roofline_counts_are_exact_on_a_tiny_scene():
    from tracer_torch.kernels import pack
    from tracer_torch.render import camera as camera_mod

    roof = spec.metric_reader("fwd_roofline")
    kind = spec.scene_kind("sphere_field")
    cfg = dict(spec.load_json(spec.BENCH_DIR / "configs/field_2k.json"), n=30)
    scene, _ = kind.program(kind.inputs(cfg, 1, "cpu"), cfg, "cpu", with_bvh=True)
    packed = pack.pack_scene(scene)
    cam = camera_mod.build_camera_data([1, 2, 3], [0, 0, 0], 8, 6, device="cpu")
    records = pack.pack_bvh(scene, 32)
    facts = dict(num_spheres=30, num_planes=1, texels=7, bvh_records=int(records.shape[0]),
                 width=8, rows=6, frames=3)
    assert facts["bvh_records"] == int((scene.bvh.left >= 0).sum()) + 1
    table_bytes = 4 * (packed.sph.numel() + packed.pla.numel() + packed.join.numel()
                       + pack.pack_camera(cam).numel())
    per_frame = table_bytes + 7 * 3 * 4 + records.numel() * 4 + 8 * 6 * 3 * 4
    assert roof.nbytes(facts) == 3 * per_frame
    assert roof.ops({"queries": 1000, "hits": 700}) == 1000 * 12 + 700 * 60
    rank = {"work": {"queries": 10**9, "hits": 5 * 10**8}, "facts": facts, "fwd_kernel_s": 7.0,
            "counted_kernel_s": 2.0, "counted_span_s": 2.5, "busy_s": 1.5, "window_s": 4.0,
            "device_events": 9}
    ops = 10**9 * 12 + 5 * 10**8 * 60
    assert roof.read({"ranks": [rank]}) == pytest.approx(100 * ops / 67e12 / 2.0, rel=1e-12)
    mfu = spec.metric_reader("frame_mfu")
    assert mfu.read({"ranks": [rank]}) == pytest.approx(100 * ops / (67e12 * 2.5), rel=1e-12)
    idle = spec.metric_reader("device_idle_pct.fwd")
    assert idle.read({"ranks": [rank, dict(rank, busy_s=3.5)]}) == pytest.approx(37.5)
    lanes = spec.metric_reader("fwd_lane_util_pct")
    work = {"passes": 40, "active_lanes": 40 * 24, "queries": 50, "node_tests": 2500}
    assert lanes.read({"ranks": [dict(rank, work=work)]}) == pytest.approx(75.0)
    nodes = spec.metric_reader("bvh_node_tests_per_query")
    assert nodes.read({"ranks": [dict(rank, work=work)]}) == 50.0
    assert nodes.read({"ranks": [dict(rank, work=dict(work, node_tests=0))]}) is None
    skew = spec.metric_reader("band_skew")
    ranks4 = [dict(rank, fwd_kernel_s=t) for t in (1.0, 2.0, 3.0, 2.0)]
    assert skew.read({"ranks": ranks4}) == 1.5 and skew.read({"ranks": [rank]}) is None
    for m in (roof, mfu, idle, lanes, nodes, skew):
        assert m.read({}) is None


def test_trace_reduction():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 100.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "void trace_kernel<false>(Launch)", "ts": 90.0,
           "dur": 30.0},
          {"ph": "X", "cat": "kernel", "name": "void trace_kernel<false>(Launch)", "ts": 115.0,
           "dur": 20.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 150.0, "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "add", "ts": 190.0, "dur": 30.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::stack", "ts": 160.0, "dur": 25.0}]
    red = trace.reduce_events(ev)
    assert red.window_s == pytest.approx(100e-6)
    assert red.busy_s == pytest.approx(55e-6)  # 100-135, 150-160, 190-200
    assert red.kernels["trace_kernel<false>"] == [pytest.approx(40e-6), 2]
    assert red.gaps[0] == ("aten::stack", pytest.approx(30e-6))
    assert red.gaps[1] == ("no host operation recorded", pytest.approx(15e-6))
    bd = trace.breakdown(red)
    assert bd["device_ops"][0][0] == "trace_kernel<false>" and len(bd["idle_gaps"]) == 2
    assert trace.short_name("void (anonymous namespace)::trace_kernel<false, 0, (int)3>"
                            "(Launch, float const*)") == "trace_kernel<false, 0, (int)3>"
    with pytest.raises(RuntimeError):
        trace.reduce_events(ev[1:])


# ---- correct, its control and its faults ------------------------------------------

@pytest.mark.parametrize("cell", ONE_CARD)
def test_sound_tiny_run_is_correct(cell):
    line = run_tiny(cell, 2**31 + 5, 0.5)
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks" and set(line["metrics"]) == {"mrays_per_s", "setup_s"}


FAULTS = [(cell, f) for cell in ONE_CARD
          for f in ("state_unchanged", "half_batch", "answer_altered")]
# the four-card mix's files are kept for a later cell (PERF.md §7); its
# bands and all_reduce run here on gloo
FAULTS += [("config_txt.frames_rows4", f) for f in ("no_exchange", "half_batch")]


def test_four_rank_mix_is_correct_when_sound():
    line = run_tiny("config_txt.frames_rows4", 2**31 + 6, 0.5)
    assert line["correct"] and line["device"]["count"] == 4


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    line = run_tiny(cell, 2**31 + 77, 0.3, f"rtbench.tests.faults:{fault}")
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_fails_the_limits(cell, tmp_path, monkeypatch):
    """The reference in bfloat16 in the program's place fails a number, on
    three seeds, at a size a test run holds."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for seed in (11, 2**31 + 12, 13):
        ctx = tiny.ctx(cell, seed, 0.2)
        res = spec.entry(ctx.workload.traffic["entry"]).run(ctx)
        try:
            nums = check.control(ctx.workload, seed, res, torch.device("cpu"))
        finally:
            check.clean(res)
        assert not all(n.ok for n in nums), nums


def test_check_numbers_of_a_missing_frame():
    picks = [(0, np.array([0, 5])), (1, np.array([1, 2]))]
    want = [np.ones((2, 3), np.float32), np.ones((2, 3), np.float32)]
    good = np.full((2, 3, 3), 255, np.uint8)
    last = np.ones((2, 3, 3), np.float32)
    lim = {"frames_missing": 0, "byte_gap": 1, "fb_rel_err": 1e-3, "fb_rel_p10": 1e-3}
    nums = {n.name: n for n in check.numbers(picks, [good, None], last, want, 1, lim, 6)}
    assert nums["frames_missing"].value == 1 and not nums["frames_missing"].ok
    assert nums["byte_gap"].value == 0 and nums["fb_rel_err"].value == 0
    nums = {n.name: n for n in check.numbers(picks, [good, good], last[:1], want, 1, lim, 6)}
    assert math.isinf(nums["fb_rel_err"].value) and not nums["fb_rel_p10"].ok


# ---- on the card --------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_on_the_card(card, cell):
    proc = subprocess.run([sys.executable, "rtbench/run.py", "--workload", cell, "--seed",
                           str(2**31 + 3), "--seconds", "3", "--trace", "0"],
                          capture_output=True, text=True, timeout=TIMEOUT, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
