"""The benchmark's frozen reference (rtbench/reference) against the port's
own plain versions, at tiny sizes on the CPU: the config parse, the scene
build, the plane precompute, the camera path, the RNG and the renderer."""

import math

import numpy as np
import pytest
import torch

from rtbench.harness import spec
from rtbench.reference import config_text as ref_config
from rtbench.reference import plain
from tracer_torch.core import rng
from tracer_torch.render import camera as camera_mod
from tracer_torch.render import renderer
from tracer_torch.scene import builders, config

CPU = torch.device("cpu")


def tiny_text(width=24, height=16, depth=5, sqrt_spp=2):
    lines = list(spec.load_json(spec.BENCH_DIR / "configs" / "config_txt.json")["text"])
    lines[2] = f"{width} {height} 50"
    lines[-1] = f"{depth} {sqrt_spp}"
    return "\n".join(lines) + "\n"


def texture(seed=0, h=13, w=20):
    return np.random.default_rng(seed).uniform(0.1, 1.0, size=(h, w, 3)).astype(np.float32)


def test_parse_matches_the_port():
    text = tiny_text()
    ours, theirs = ref_config.parse(text), config.read_scene_params(text)
    assert (ours["num_frames"], ours["width"], ours["height"], ours["fov"]) == (
        theirs.num_frames, theirs.width, theirs.height, theirs.fov_degrees)
    assert (ours["max_depth"], ours["sqrt_spp"]) == (theirs.render.max_depth,
                                                     theirs.render.sqrt_rays_per_pixel)
    for k in ref_config.PATH_KEYS:
        assert ours["path"][k] == getattr(theirs.camera_path, k)
    assert len(ours["lights"]) == len(theirs.lights) == 4


@pytest.mark.parametrize("textured", [True, False])
def test_scene_matches_create_scene(textured):
    text, tex = tiny_text(), texture() if textured else None
    ref = plain.scene_from_arrays(ref_config.arrays(ref_config.parse(text), tex), CPU)
    prog = builders.create_scene(config.read_scene_params(text),
                                 texture_loader=lambda _p: tex, device=CPU)
    pairs = [(ref.sph_center, prog.spheres.center), (ref.sph_radius, prog.spheres.radius),
             (ref.sph_mat, prog.spheres.material_idx), (ref.pl_type, prog.planes.ptype),
             (ref.pl_base, prog.planes.base), (ref.pl_u, prog.planes.u),
             (ref.pl_v, prog.planes.v), (ref.pl_normal, prog.planes.normal),
             (ref.pl_d, prog.planes.d), (ref.pl_w, prog.planes.w),
             (ref.pl_mat, prog.planes.material_idx), (ref.mat_type, prog.materials.mtype),
             (ref.mat_fuzz, prog.materials.fuzz), (ref.mat_ir, prog.materials.ir),
             (ref.mat_abs, prog.materials.absorption), (ref.mat_albedo, prog.materials.albedo),
             (ref.mat_emit, prog.materials.emit), (ref.mat_tex, prog.materials.tex_id)]
    for a, b in pairs:
        assert torch.equal(a, b.to(a.dtype))
    assert (ref.texture is None) == (prog.textures is None)
    assert prog.num_spheres == 94 and prog.num_planes == 105


@pytest.mark.parametrize("frame", [0, 1, 37, 99])
def test_camera_path_matches_camera_at(frame):
    p = ref_config.parse(tiny_text())
    params = config.read_scene_params(tiny_text())
    ours = ref_config.camera(p, frame, CPU)
    theirs = camera_mod.camera_at(params.camera_path, frame, params.num_frames, params.width,
                                  params.height, params.fov_degrees, device=CPU)
    for a, b in zip(ours, (theirs.origin, theirs.pixel00_loc, theirs.pixel_delta_u,
                           theirs.pixel_delta_v)):
        assert torch.equal(a, b)


def test_rng_matches_the_port():
    g = np.random.default_rng(1)
    seeds = torch.tensor(g.integers(0, 2**32, size=4096), dtype=torch.int64)
    assert torch.equal(plain.wang_hash(seeds), rng.wang_hash(seeds))
    s1, u1 = plain.rand(seeds, torch.float32)
    s2, u2 = rng.random_float(seeds)
    assert torch.equal(s1, s2) and torch.equal(u1, u2)
    i, j = seeds % 997, seeds % 601
    for quirk in (True, False):
        assert torch.equal(plain.pixel_seed(i, j, 997, quirk), rng.pixel_seed(i, j, 997, quirk))


def _frame(ref_scene, cam, w, h, spp, depth, **kw):
    jj, ii = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    return plain.render_samples(ref_scene, cam, w, ii.reshape(-1), jj.reshape(-1), spp, depth,
                                quirk=True, **kw).reshape(h, w, 3)


@pytest.mark.parametrize("textured", [True, False])
def test_render_matches_the_plain_renderer(textured):
    w, h, spp, depth = 24, 16, 4, 6
    text, tex = tiny_text(w, h, depth), texture(3) if textured else None
    p = ref_config.parse(text)
    ref_scene = plain.scene_from_arrays(ref_config.arrays(p, tex), CPU)
    params = config.read_scene_params(text)
    prog = builders.create_scene(params, texture_loader=lambda _p: tex, device=CPU)
    cam = camera_mod.camera_at(params.camera_path, 3, params.num_frames, w, h,
                               params.fov_degrees, device=CPU)
    want = renderer.render_frame(prog, cam, w, h, spp, depth)
    got = _frame(ref_scene, ref_config.camera(p, 3, CPU), w, h, spp, depth,
                 rays_per_batch=500)
    assert float(want.sum()) > 0
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_field_scene_and_render_match_the_port():
    kind = spec.scene_kind("sphere_field")
    cfg = dict(spec.load_json(spec.BENCH_DIR / "configs" / "field_2k.json"), n=60, width=20,
               height=12, sqrt_spp=2, max_depth=4)
    inp = kind.inputs(cfg, 5, CPU)
    prog, params = kind.program(inp, cfg, CPU, with_bvh=True)
    ref_scene, cam_of, st = kind.reference(inp, cfg, CPU, torch.float32)
    assert torch.equal(ref_scene.pl_normal, prog.planes.normal)
    assert torch.equal(ref_scene.pl_w, prog.planes.w)
    assert torch.equal(ref_scene.sph_center, prog.spheres.center)
    cam = camera_mod.camera_at(params.camera_path, 7, params.num_frames, 20, 12,
                               params.fov_degrees, device=CPU)
    for a, b in zip(cam_of(7), cam):
        assert torch.equal(a, b)
    want = renderer.render_frame(prog, cam, 20, 12, 4, 4, intersector="bvh")
    got = _frame(ref_scene, cam_of(7), 20, 12, 4, 4)
    assert float(want.sum()) > 0
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_quantize_matches_the_writer():
    from tracer_torch.io import image

    sums = np.random.default_rng(2).uniform(0, 30, size=(50, 3)).astype(np.float32)
    for div in (1, 4, 50, 2500):
        assert np.array_equal(plain.quantize(sums, div), image.quantize(sums, div))


def test_bfloat16_control_renders_differently():
    w, h, spp, depth = 16, 12, 4, 5
    text = tiny_text(w, h, depth)
    p = ref_config.parse(text)
    arrays = ref_config.arrays(p, texture(1))
    full = _frame(plain.scene_from_arrays(arrays, CPU), ref_config.camera(p, 0, CPU),
                  w, h, spp, depth)
    low = _frame(plain.scene_from_arrays(arrays, CPU, torch.bfloat16),
                 ref_config.camera(p, 0, CPU), w, h, spp, depth, dtype=torch.bfloat16)
    rel = float((low - full).abs().sum() / full.abs().sum())
    assert math.isfinite(rel) and rel > 0.05
