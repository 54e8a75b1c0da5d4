"""The benchmark's data: BENCHMARK.json and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell's
check or one per-layer metric sits in a file of its own, found by the name
BENCHMARK.json gives it, so a cell is added with files alone:

  rtbench/configs/<config>.json      a deployment: its scene kind and sizes
  rtbench/traffic/<traffic>.json     a mix: the entry adapter and its parameters
  rtbench/entries/<entry>.py         the adapter that drives the program
  rtbench/scenes/<scene>.py          a scene kind's inputs, program side and reference side
  rtbench/checks/<workload>.json     what decides `correct` in the cell, with its limits
  rtbench/metrics/<metric>.py        a per-layer metric's reader

A scene kind (rtbench/scenes/<scene>.py) defines

  inputs(cfg, seed, device)                 what both sides get, from the seed
  program(inputs, cfg, device, with_bvh)    (scene, SceneParams) of the program
  reference(inputs, cfg, device, dtype)     (reference scene, camera of frame n,
                                            settings), worked out again from the
                                            inputs, nothing of the program's

and may define

  render_samples(scene, cam, width, i, j, spp, max_depth, quirk, dtype)
      its own reference estimator, with the arguments of
      `plain.render_samples` and its [N, 3] float32 raw sums; it lives
      under rtbench/reference/ and imports nothing of the program or of
      JAX. Without it the check renders with `plain.render_samples`.
  tiny(cfg)
      the configuration cut to a CPU-sized run for the tests
      (rtbench/tests/tiny.py); without it the tests run `cfg` as it is.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Workload(NamedTuple):
    name: str
    chips: int
    config: dict  # rtbench/configs/<config>.json, with its "name"
    traffic: dict  # rtbench/traffic/<traffic>.json, with its "name"
    check: dict  # rtbench/checks/<workload>.json
    end_to_end: list  # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list  # its per-layer metrics


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str) -> ModuleType:
    return _module(BENCH_DIR / "entries" / f"{name}.py", f"rtbench_entry_{name}")


def scene_kind(name: str) -> ModuleType:
    return _module(BENCH_DIR / "scenes" / f"{name}.py", f"rtbench_scene_{name}")


def metric_reader(name: str) -> ModuleType:
    return _module(BENCH_DIR / "metrics" / f"{name}.py", f"rtbench_metric_{name.replace('.', '_')}")


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def workload(name: str, bench: dict = None) -> Workload:
    """The cell `name` with its files loaded; raises KeyError for an
    unknown cell and FileNotFoundError for a missing file."""
    bench = benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    config = dict(load_json(BENCH_DIR / "configs" / f"{w['config']}.json"), name=w["config"])
    traffic = dict(load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"), name=w["traffic"])
    check = load_json(BENCH_DIR / "checks" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    layer = [m for m in bench["per_layer"] if reports(m, name)]
    return Workload(name, int(w["chips"]), config, traffic, check, e2e, layer)
