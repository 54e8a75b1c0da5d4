"""The RTIOW book's estimator in tracer_torch (Shirley, "Ray Tracing in One
Weekend", book 1, v3.2.3): the thin lens, the sky and the two materials
RTIOW_LAMBERTIAN and RTIOW_METAL, against the benchmark's plain reference
(rtbench/reference/rtiow_final.py) at the scene kind's CPU cut; the
defaults keep the pinhole, the background and the reference's materials
bit for bit; the kernels that do not render the estimator refuse it.

The tests marked `cuda` hold K1-bvh's RTIOW instantiation and its counters
against the plain twin on a card; like tests/test_torch_cuda.py this file
imports neither jax nor tracer:

    python -m pytest --noconftest -m cuda tests/test_torch_rtiow.py -q
"""

import math
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), os.path.dirname(os.path.abspath(__file__))]

from rtbench.harness import spec  # noqa: E402
from torch_scenes import SKY, full_scene  # noqa: E402
from tracer_torch.bvh import builder as bvh_builder  # noqa: E402
from tracer_torch.core import rng, vec  # noqa: E402
from tracer_torch.kernels import bwd, megakernel, pack  # noqa: E402
from tracer_torch.materials import scatter as scatter_mod  # noqa: E402
from tracer_torch.render import camera, integrator, renderer  # noqa: E402
from tracer_torch.scene import types as T  # noqa: E402
from tracer_torch.scene.params import CameraPathParams  # noqa: E402

CPU = torch.device("cpu")
KIND = spec.scene_kind("rtiow_final")
CONFIG = spec.load_json(spec.BENCH_DIR / "configs" / "rtiow_final.json")


def tiny_scene(device, with_bvh=True):
    """(scene, camera of frame 0, cut config, inputs) at the kind's own CPU cut."""
    cfg = KIND.tiny(dict(CONFIG))
    inp = KIND.inputs(cfg, 1, device)
    scene, params = KIND.program(inp, cfg, device, with_bvh=with_bvh)
    cam = camera.camera_at(params.camera_path, 0, params.num_frames, cfg["width"],
                           cfg["height"], params.fov_degrees, device=device)
    return scene, cam, cfg, inp


def _frame_of_reference(cfg, inp, device):
    ref_scene, cam_of, st = KIND.reference(inp, cfg, device, torch.float32)
    w, h = st["width"], st["height"]
    jj, ii = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    return KIND.render_samples(ref_scene, cam_of(0), w, ii.reshape(-1), jj.reshape(-1),
                               st["sqrt_spp"] ** 2, st["max_depth"],
                               quirk=True).reshape(h, w, 3)


# ---- the plain twin against the benchmark's reference -----------------------------

@pytest.mark.parametrize("intersector", ["bvh", "brute"])
def test_twin_matches_the_reference_at_the_tiny_cut(intersector):
    """Per-pixel sample sums of the twin and the plain reference. Both take
    the same float forms on the CPU (camera, lens, sphere test, the 8-draw
    budget, the sky), so the sums agree to rounding; 1e-5 leaves room for
    the order in which a BVH and brute force meet a tie."""
    scene, cam, cfg, inp = tiny_scene(CPU)
    w, h, spp, d = cfg["width"], cfg["height"], cfg["sqrt_spp"] ** 2, cfg["max_depth"]
    got = renderer.render_frame(scene, cam, w, h, spp, d, intersector=intersector)
    want = _frame_of_reference(cfg, inp, CPU)
    assert float(want.mean()) > 0.5  # the sky lights the frame
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_scene_and_camera_are_the_references():
    scene, cam, cfg, inp = tiny_scene(CPU)
    ref_scene, cam_of, _ = KIND.reference(inp, cfg, CPU, torch.float32)
    assert torch.equal(ref_scene.base.sph_center, scene.spheres.center)
    assert torch.equal(ref_scene.base.sph_radius, scene.spheres.radius)
    assert torch.equal(ref_scene.base.mat_type, scene.materials.mtype.long())
    assert torch.equal(ref_scene.sky_top, scene.sky.top)
    assert scene.num_planes == 0 and isinstance(cam, camera.ThinLensCamera)
    for a, b in zip(cam_of(0), (*cam[:4], cam.lens)):
        assert torch.equal(a, b)
    # the book's eye (13, 2, 3) in the port's frame, within float32 rounding
    np.testing.assert_allclose(cam.origin.numpy(), [13.0, -3.0, 2.0], rtol=0, atol=4e-6)


def test_layout_is_the_books():
    lay = KIND.inputs(CONFIG, 5, CPU)["layout"]
    kinds = lay["kind"][1:-3]
    assert len(lay["radius"]) == 1 + len(kinds) + 3 and 400 < len(kinds) <= 484
    assert lay["radius"][0] == 1000.0 and (lay["radius"][1:-3] == 0.2).all()
    small = lay["center"][1:-3]
    assert (np.linalg.norm(small - [4.0, 0.2, 0.0], axis=1) > 0.9).all()
    share = {k: float((kinds == k).mean()) for k in (T.RTIOW_LAMBERTIAN, T.RTIOW_METAL,
                                                     T.DIELECTRIC)}
    assert 0.74 < share[T.RTIOW_LAMBERTIAN] < 0.86 and 0.1 < share[T.RTIOW_METAL] < 0.2
    assert (lay["fuzz"][1:-3][kinds == T.RTIOW_METAL] < 0.5).all()


# ---- the defaults keep the parent's path ------------------------------------------

def _parents_get_rays(cam, i, j, seed):
    """get_rays as it was before the lens: two draws, the camera's origin."""
    fi, fj = i.to(torch.float32)[..., None], j.to(torch.float32)[..., None]
    center = cam.pixel00_loc + fi * cam.pixel_delta_u + fj * cam.pixel_delta_v
    seed, ox = rng.random_float(seed)
    seed, oy = rng.random_float(seed)
    ps = center + (ox - 0.5)[..., None] * cam.pixel_delta_u + (oy - 0.5)[..., None] * \
        cam.pixel_delta_v
    origin = cam.origin.expand_as(ps)
    return seed, origin, ps - origin


def _parents_scatter(ray_origin, ray_dir, point, normal, front_face, mtype, fuzz, ir,
                     absorption, albedo, seed):
    """scatter as it was before the RTIOW codes."""
    seed, u_choice = rng.random_float(seed)
    seed, hemi = rng.random_in_hemisphere(normal, seed)
    seed, ball = rng.random_in_unit_sphere(seed)
    seed, u_refl = rng.random_float(seed)
    seed, u_rr = rng.random_float(seed)
    unit_dir = vec.unit_vector(ray_dir, eps=1e-30)
    lam_dir = torch.where(vec.near_zero(hemi)[..., None], normal, hemi)
    spec_ = u_choice < scatter_mod.METAL_SPECULAR_P
    refl_dir = vec.reflect(unit_dir, normal) + fuzz[..., None] * ball
    metal_dir = torch.where(spec_[..., None], refl_dir, lam_dir)
    metal_ok = torch.where(spec_, vec.dot(refl_dir, normal) > 0.0, True)
    die_dir, die_origin, die_att, p_rr, _ = scatter_mod._dielectric(
        ray_origin, unit_dir, point, normal, front_face, ir, absorption, u_refl)
    return (seed, *scatter_mod._select(mtype, point, albedo, lam_dir, metal_dir, metal_ok,
                                       die_dir, die_origin, die_att, u_rr <= p_rr))


def test_defaults_keep_the_pinhole_rays_bit_for_bit():
    p = CameraPathParams(rc0=9.0, zc0=3.0, phic0=0.4, zn0=1.0)
    explicit = CameraPathParams(rc0=9.0, zc0=3.0, phic0=0.4, zn0=1.0, aperture=0.0,
                                focus_dist=1.0)
    cam = camera.camera_at(p, 3, 10, 24, 16, 55.0, device=CPU)
    assert type(cam) is camera.CameraData and cam.lens is None
    for a, b in zip(cam, camera.camera_at(explicit, 3, 10, 24, 16, 55.0, device=CPU)):
        assert torch.equal(a, b)
    i, j, base = renderer.pixel_grid(24, 16, device=CPU)
    seed = rng.sample_seed(base, 5)
    for got, want in zip(camera.get_rays(cam, i, j, seed), _parents_get_rays(cam, i, j, seed)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("intersector", ["brute", "bvh"])
def test_defaults_keep_the_frames_bit_for_bit(intersector, monkeypatch):
    """Every material of the reference, a textured floor, no sky, a pinhole:
    the frame equals the one rendered with the parent's ray generation and
    scatter in place of today's."""
    scene = full_scene(CPU)
    scene = scene._replace(bvh=bvh_builder.build_scene_bvh_from_scene(scene))
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 24, 16, 55.0,
                                   background=SKY, device=CPU)
    now = renderer.render_frame(scene, cam, 24, 16, 4, 6, intersector=intersector, rr_start=2)
    monkeypatch.setattr(camera, "get_rays", lambda c, i, j, s, **kw: _parents_get_rays(c, i, j,
                                                                                        s))
    monkeypatch.setattr(scatter_mod, "scatter", _parents_scatter)
    before = renderer.render_frame(scene, cam, 24, 16, 4, 6, intersector=intersector,
                                   rr_start=2)
    assert float(now.mean()) > 0 and torch.equal(now, before)


# ---- the lens -----------------------------------------------------------------------

def _lens_camera(w=8, h=6):
    return camera.build_camera_data([13.0, -3.0, 2.0], [0.0, 0.0, 0.0], w, h, 20.0,
                                    device=CPU, focus_dist=10.0, aperture=0.1)


def test_lens_rays_meet_in_the_plane_in_focus(monkeypatch):
    """With the jitter at 0, every sample of a pixel passes through its
    centre, which lies at the focus distance in front of the lens."""
    cam = _lens_camera()
    monkeypatch.setattr(camera, "jitter_offsets", lambda ux, uy, *a: (ux * 0.0, uy * 0.0))
    n = 512
    i, j = torch.full((n,), 5), torch.full((n,), 2)
    seed = rng.sample_seed(torch.full((n,), 77, dtype=torch.int64), torch.arange(n))
    _, origin, d = camera.get_rays(cam, i, j, seed)
    centre = cam.pixel00_loc + 5 * cam.pixel_delta_u + 2 * cam.pixel_delta_v
    torch.testing.assert_close(origin + d, centre.expand_as(d), rtol=0, atol=2e-6)
    assert origin.std(0).max() > 1e-3  # the origins do move on the lens
    w = vec.unit_vector(cam.origin - torch.zeros(3))
    # the pixel's centre lies in the plane at distance 10 along -w
    assert abs(float(vec.dot(cam.origin - centre, w)) - 10.0) < 1e-4


def test_lens_origins_fill_the_disk():
    """The origins lie on the lens disk of radius R = 0.05 in the plane
    through the eye across w, to the rounding of coordinates near 13 (an
    ulp is 1e-6), and their mean r^2 is R^2 / 2 within four standard
    errors (r^2 = R^2 u1 is uniform on [0, R^2])."""
    cam = _lens_camera()
    n = 1 << 14
    seed = rng.sample_seed(torch.full((n,), 12345, dtype=torch.int64), torch.arange(n))
    _, origin, _ = camera.get_rays(cam, torch.zeros(n, dtype=torch.int64),
                                   torch.zeros(n, dtype=torch.int64), seed)
    off = (origin - cam.origin).double()
    r = off.norm(dim=-1)
    big_r = 0.05
    assert float(r.max()) <= big_r + 4e-6
    w = vec.unit_vector(cam.origin).double()
    assert float(vec.dot(off, w).abs().max()) < 4e-6
    sem = big_r ** 2 / math.sqrt(12 * n)
    assert abs(float((r ** 2).mean()) - big_r ** 2 / 2) < 4 * sem


def test_the_lens_takes_two_draws_after_the_jitter():
    cam = _lens_camera()
    i, j, base = renderer.pixel_grid(8, 6, device=CPU)
    seed = rng.sample_seed(base, 3)
    after, _, _ = camera.get_rays(cam, i, j, seed)
    want = seed
    for _ in range(4):
        want = rng.wang_hash(want)
    assert torch.equal(after, want)


# ---- the sky ------------------------------------------------------------------------

def test_sky_straight_up_down_and_at_the_horizon():
    sky = T.make_sky([1.0, 1.0, 1.0], [0.5, 0.7, 1.0], CPU)
    d = torch.tensor([[0.0, 0.0, 3.0], [0.0, 0.0, -2.0], [4.0, 1.0, 0.0]])
    got = integrator.sky_radiance(sky, d)
    assert torch.equal(got[0], sky.top) and torch.equal(got[1], sky.bottom)
    assert torch.equal(got[2], torch.tensor([0.75, 0.85, 1.0]))


def test_a_miss_takes_the_sky_in_place_of_the_background():
    """One sphere behind the camera: every camera ray misses and adds the sky
    along its own direction, whatever the camera's background."""
    scene, cam, _, _ = tiny_scene(CPU, with_bvh=False)
    behind = T.make_spheres([[40.0, -9.0, 6.0]], [1.0], [0], CPU)
    scene = scene._replace(spheres=behind)
    cam = cam._replace(background=torch.full((3,), 9.0))
    fb = renderer.render_frame(scene, cam, 4, 3, 2, 3)
    i, j, base = renderer.pixel_grid(4, 3, device=CPU)
    want = 0
    for s in range(2):
        _, _, d = camera.get_rays(cam, i, j, rng.sample_seed(base, s))
        want = want + integrator.sky_radiance(scene.sky, d)
    assert torch.equal(fb.reshape(-1, 3), want)


# ---- the materials -------------------------------------------------------------------

@pytest.mark.parametrize("code", [T.RTIOW_LAMBERTIAN, T.RTIOW_METAL])
def test_furnace_a_lone_sphere_under_a_white_sky_returns_its_albedo(code):
    """A convex sphere of albedo a under a uniform white sky: a path that
    hits it scatters away from it (the Lambertian's n + unit vector never
    points inward, a mirror reflects outward) into the sky, so every camera
    ray returns exactly a."""
    a = (0.3, 0.55, 0.8)
    scene = T.Scene(T.make_spheres([[0.0, 0.0, 0.0]], [1.0], [0], CPU),
                    T.make_planes([], np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), [],
                                  CPU),
                    T.make_materials([code], [0.0], [1.0], [[0, 0, 0]], [a], [[0, 0, 0]], [-1],
                                     CPU),
                    None, sky=T.make_sky([1.0] * 3, [1.0] * 3, CPU))
    cam = camera.build_camera_data([4.0, 0.0, 0.0], [0.0, 0.0, 0.0], 8, 8, 10.0, device=CPU)
    fb = renderer.render_frame(scene, cam, 8, 8, 3, 4)
    per = torch.tensor(a, dtype=torch.float32)
    want = (per + per) + per  # three samples, summed as the renderer sums them
    assert torch.equal(fb, want.expand_as(fb))


def test_the_new_codes_take_the_budgets_draws():
    """Both codes advance the seed by the budget's 8 draws, as every code."""
    n = 64
    g = torch.Generator().manual_seed(3)
    normal = vec.unit_vector(torch.randn(n, 3, generator=g))
    d = -normal + 0.3 * torch.randn(n, 3, generator=g)
    seed = torch.randint(0, 2**32, (n,), generator=g, dtype=torch.int64)
    want = seed
    for _ in range(8):
        want = rng.wang_hash(want)
    for code in (T.RTIOW_LAMBERTIAN, T.RTIOW_METAL):
        out = scatter_mod.scatter(torch.zeros(n, 3), d, torch.zeros(n, 3), normal,
                                  torch.ones(n, dtype=torch.bool), torch.full((n,), code),
                                  torch.full((n,), 0.2), torch.ones(n), torch.zeros(n, 3),
                                  torch.full((n, 3), 0.5), seed)
        assert torch.equal(out[0], want)
        if code == T.RTIOW_LAMBERTIAN:
            assert out[4].all() and (vec.dot(out[2], normal) >= 0).all()


# ---- packing and a scene with no plane -------------------------------------------------

def test_rtiow_rows_match_the_kernel_source():
    body = re.search(r"enum RtiowRow \{([^}]*)\}",
                     (ROOT / "tracer_torch/csrc/common.cuh").read_text()).group(1)
    items = [x.strip() for x in body.split(",") if x.strip()]
    assert items[-1] == "R_ROWS"
    assert tuple(x.split("_", 1)[1].lower() for x in items[:-1]) == pack.RTIOW_ROWS
    scene, cam, _, _ = tiny_scene(CPU)
    t = pack.pack_camera_rtiow(cam, scene)
    c = len(pack.CAMERA_ROWS)
    row = {name: c + k for k, name in enumerate(pack.RTIOW_ROWS)}
    assert t.shape == (c + len(pack.RTIOW_ROWS),) and torch.equal(t[:c], pack.pack_camera(cam))
    assert torch.equal(t[row["lux"]:row["lux"] + 3], cam.lens[0])
    assert torch.equal(t[row["str"]:row["str"] + 3], scene.sky.top)
    assert t[row["lens_on"]] == 1 and t[row["sky_on"]] == 1
    pin = pack.pack_camera_rtiow(camera.build_camera_data([1, 2, 3], [0, 0, 0], 4, 4,
                                                          device=CPU), scene._replace(sky=None))
    assert pin[row["lens_on"]] == 0 and pin[row["sky_on"]] == 0


def test_a_scene_with_no_plane_packs_builds_its_bvh_and_renders():
    scene, cam, cfg, _ = tiny_scene(CPU, with_bvh=True)
    assert scene.num_planes == 0
    p = pack.pack_scene(scene)
    assert p.pla.shape == (0, len(pack.PLANE_ROWS)) and p.num_p == 0
    assert p.join.shape == (len(pack.JOIN_ROWS), scene.num_spheres)
    records = pack.pack_bvh(scene, megakernel.BVH_STACK)
    assert records.shape == (int((scene.bvh.left >= 0).sum()) + 1, 4, 4)
    assert bool((scene.bvh.kind[scene.bvh.left < 0] == 0).all())
    for ix in ("bvh", "brute"):
        fb = renderer.render_frame(scene, cam, 6, 4, 2, 3, intersector=ix)
        assert fb.shape == (4, 6, 3) and bool(torch.isfinite(fb).all()) and float(fb.min()) > 0


def test_features_are_named():
    scene, cam, _, _ = tiny_scene(CPU)
    assert pack.rtiow_features(scene, cam) == ["a thin-lens camera", "a sky",
                                               "the RTIOW material codes (4, 5)"]
    plain_mats = scene.materials._replace(mtype=torch.full_like(scene.materials.mtype,
                                                                T.LAMBERTIAN))
    assert pack.rtiow_features(scene._replace(sky=None, materials=plain_mats)) == []
    assert pack.rtiow_features(full_scene(CPU)) == []


# ---- refusals -----------------------------------------------------------------------

def _one_feature_each():
    scene, cam, _, _ = tiny_scene(CPU)
    plain_mats = scene.materials._replace(mtype=torch.full_like(scene.materials.mtype,
                                                                T.LAMBERTIAN))
    pin = camera.CameraData(*cam)
    base = scene._replace(sky=None, materials=plain_mats)
    return [("lens", base, cam), ("sky", scene._replace(materials=plain_mats), pin),
            ("RTIOW material", scene._replace(sky=None), pin)]


@pytest.mark.parametrize("case", range(3))
def test_the_other_kernels_refuse_the_estimator(case):
    """K1, K1-rec, K1-cl, K1-ref (brute and BVH) and K2 raise before any
    launch, naming what they lack; the plain reference stream and recording
    renderer too."""
    word, scene, cam = _one_feature_each()[case]
    args = (scene, cam, 8, 4, 1, 2, True, None, 0)
    calls = {"K1": lambda: megakernel._render(*args, None),
             "K1-rec": lambda: megakernel._record(*args, 9, None),
             "K1-cl": lambda: megakernel._render_clustered(*args, 4, None),
             "K1-ref": lambda: megakernel._render_ref(*args, None, "brute"),
             "K1-bvh-ref": lambda: megakernel._render_ref(*args, None, "bvh"),
             "K2": lambda: bwd.pack_tables(scene, cam),
             "plain reference stream": lambda: renderer.render_frame(
                 scene, cam, 4, 2, 1, 2, rng_mode="reference"),
             "plain record": lambda: renderer.render_frame_record(scene, cam, 4, 2, 1, 2)}
    for name, call in calls.items():
        with pytest.raises(ValueError, match=word) as e:
            call()
        assert "does not support" in str(e.value), name


# ---- on the card --------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_the_twin_at_the_tiny_cut(dev):
    """K1-bvh's RTIOW instantiation against the plain twin, camera sample by
    camera sample (one-sample launches at eight sample starts): nvcc's FMA
    contraction rounds otherwise than the twin's separate operations, and
    on this scene (silhouettes of hundreds of small spheres, glass that
    decides by a uniform) that sends about 0.4% of the samples down another
    valid path, which moves a 16-sample pixel by up to 1 in 6% of the
    pixels on an H100. So: 99% of the samples agree to 1e-3, and
    the frame's L1 difference is within 1% of its sum."""
    scene, cam, cfg, _ = tiny_scene(dev)
    w, h, d = cfg["width"], cfg["height"], cfg["max_depth"]
    before = megakernel.LAUNCHES_BVH
    got = torch.stack([megakernel.render_frame_kernel(scene, cam, w, h, 1, d, sample_start=s,
                                                      intersector="bvh") for s in range(8)])
    assert megakernel.LAUNCHES_BVH == before + 8
    want = torch.stack([renderer.render_frame(scene, cam, w, h, 1, d, sample_start=s,
                                              intersector="bvh") for s in range(8)])
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.isfinite(got).all() and float(want.mean()) > 0.2
    diff = (got - want).abs()
    assert (diff.amax(dim=-1) < 1e-3).double().mean() >= 0.99, f"max {diff.max()}"
    assert float(diff.sum() / want.abs().sum()) < 0.01
    with pytest.raises(ValueError, match="does not support"):
        megakernel.render_frame_kernel(scene, cam, w, h, 1, d)


@pytest.mark.cuda
def test_counters_against_the_twin(dev):
    """samples = W H spp, and the queries of the twin within the few samples
    FMA contraction diverts; the scattering passes are passes, the mixed
    ones among them."""
    scene, cam, cfg, _ = tiny_scene(dev)
    w, h, spp, d = cfg["width"], cfg["height"], cfg["sqrt_spp"] ** 2, cfg["max_depth"]
    work = megakernel.loop_work(scene, cam, w, h, spp, d, intersector="bvh")
    assert work.samples == w * h * spp
    assert 0 < work.mixed_passes <= work.scatter_passes <= work.passes
    queries = []
    i, j, base = renderer.pixel_grid(w, h, device=dev)
    renderer.render_pixels(scene, cam, i, j, base, spp, d, intersector="bvh", queries=queries)
    q = int(torch.stack(queries).sum())
    assert abs(work.queries - q) <= 0.002 * q
    # a pinhole scene without the estimator counts its samples too
    old = megakernel.loop_work(full_scene(dev)._replace(
        bvh=bvh_builder.build_scene_bvh_from_scene(full_scene(dev))),
        camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 32, 24, 55.0,
                                 background=SKY, device=dev), 32, 24, 4, 8, intersector="bvh")
    assert old.samples == 32 * 24 * 4
