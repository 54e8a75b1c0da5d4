"""Book 2 of Shirley's series ("Ray Tracing: The Next Week", v3.2.3) in
tracer_torch: the ray time and the moving sphere, constant media with the
ISOTROPIC phase function, the Perlin marble (NOISE) and the box helper,
against the benchmark's plain reference (rtbench/reference/
nextweek_final.py) at the scene kind's CPU cut; scenes without book 2's
fields render bit for bit as before; the kernels that do not render them
refuse them.

The tests marked `cuda` hold K1-bvh's NEXTWEEK instantiation and its
counters against the plain twin on a card; like tests/test_torch_cuda.py
this file imports neither jax nor tracer:

    python -m pytest --noconftest -m cuda tests/test_torch_nextweek.py -q
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
from torch_scenes import one_torch_thread  # noqa: E402,F401
from torch_scenes import SKY, sphere_field  # noqa: E402
from tracer_torch.bvh import builder as bvh_builder  # noqa: E402
from tracer_torch.bvh import native  # noqa: E402
from tracer_torch.core import rng, vec  # noqa: E402
from tracer_torch.kernels import bwd, megakernel, pack  # noqa: E402
from tracer_torch.materials import noise as noise_mod  # noqa: E402
from tracer_torch.materials import scatter as scatter_mod  # noqa: E402
from tracer_torch.materials import texture as texture_mod  # noqa: E402
from tracer_torch.render import camera, hit, integrator, renderer  # noqa: E402
from tracer_torch.scene import builders  # noqa: E402
from tracer_torch.scene import types as T  # noqa: E402

CPU = torch.device("cpu")
KIND = spec.scene_kind("nextweek_final")
CONFIG = spec.load_json(spec.BENCH_DIR / "configs" / "nextweek_final.json")
REF = sys.modules[KIND.ref.__name__]


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


def _slab_scene(density, length, albedo=(0.5, 0.5, 0.5)):
    """A medium of `density` whose boundary sphere (centre on the z axis at
    `length` / 2, radius `length` / 2) meets the axis at z = 0 and z =
    `length`, and nothing else but a far light no ray reaches: a ray up the
    axis from z = 0 crosses a slab of the medium `length` long."""
    scene = T.Scene(T.make_spheres([[0.0, 0.0, -1e7]], [1.0], [0], CPU),
                    T.make_planes([], np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), [],
                                  CPU),
                    T.make_materials([T.DIFFUSE_LIGHT], [0.0], [1.0], [[0, 0, 0]], [[0, 0, 0]],
                                     [[1, 1, 1]], [-1], CPU), None)
    media = T.make_media([[0.0, 0.0, length / 2]], [length / 2], [density], [albedo], CPU)
    return scene._replace(media=media)


# ---- the plain twin against the benchmark's reference -----------------------------

@pytest.mark.parametrize("intersector", ["bvh", "brute"])
def test_twin_matches_the_reference_at_the_tiny_cut(intersector):
    """Per-pixel sample sums of the twin and the plain reference. Both take
    the same float forms on the CPU (camera, the time, the sphere and quad
    tests, the media's free flights, the marble, the 8-draw budget), so the
    sums agree to rounding; 1e-5 leaves room for the order in which a BVH
    and brute force meet a tie (the boxes share edges)."""
    scene, cam, cfg, inp = tiny_scene(CPU)
    w, h, spp, d = cfg["width"], cfg["height"], cfg["sqrt_spp"] ** 2, cfg["max_depth"]
    got = renderer.render_frame(scene, cam, w, h, spp, d, intersector=intersector)
    want = _frame_of_reference(cfg, inp, CPU)
    assert float(want.mean()) > 1.0  # the area light lights the frame
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_tiny_cut_exercises_every_mechanism():
    """At the cut the media win a share of the queries, the marble is
    evaluated, the moving sphere and the earth are hit."""
    scene, cam, cfg, _ = tiny_scene(CPU)
    w, h = cfg["width"], cfg["height"]
    events, queries = [], []
    i, j, base = renderer.pixel_grid(w, h, device=CPU)
    renderer.render_pixels(scene, cam, i, j, base, 4, cfg["max_depth"], intersector="bvh",
                           events=events, queries=queries)
    tests, scatters, marble = (int(sum(int(e[k]) for e in events)) for k in range(3))
    q = int(torch.stack(queries).sum())
    assert tests == 2 * q and 0.05 * q < scatters < 0.8 * q and marble > 0
    seed = rng.sample_seed(base, 0)
    seed, o, dd = camera.get_rays(cam, i, j, seed)
    rec = hit.hit_scene_brute(scene, o, dd, time=torch.zeros(o.shape[0]))
    winners = set(rec.winner[rec.hit].tolist())
    assert {0, 4, 5} <= winners  # the moving sphere, the earth, the marble


def test_the_scene_and_camera_are_the_references():
    scene, cam, cfg, inp = tiny_scene(CPU)
    ref_scene, cam_of, _ = KIND.reference(inp, cfg, CPU, torch.float32)
    b = ref_scene.base
    assert torch.equal(b.sph_center, scene.spheres.center)
    assert torch.equal(b.sph_radius, scene.spheres.radius)
    for a, c in ((b.pl_base, scene.planes.base), (b.pl_u, scene.planes.u),
                 (b.pl_v, scene.planes.v), (b.pl_normal, scene.planes.normal),
                 (b.pl_d, scene.planes.d), (b.pl_w, scene.planes.w)):
        assert torch.equal(a, c)
    assert torch.equal(b.mat_type, scene.materials.mtype.long())
    assert torch.equal(ref_scene.motion, scene.motion)
    assert torch.equal(ref_scene.med_nid, scene.media.neg_inv_density)
    assert torch.equal(ref_scene.noise_perm, scene.noise.perm.long())
    assert type(cam) is camera.CameraData
    for a, c in zip(cam_of(0), cam[:4]):
        assert torch.equal(a, c)
    # the book's eye (478, 278, -600) in the port's frame, within float32 rounding
    np.testing.assert_allclose(cam.origin.numpy(), [478.0, 600.0, 278.0], rtol=0, atol=1e-4)


def test_layout_is_the_books():
    """400 boxes of side 100, heights in [1, 101), six quads a box and the
    light; the cluster's 1,000 centres are points of [0, 165)^3 turned by
    15 degrees about y and moved by (-100, 270, 395)."""
    cfg = dict(CONFIG)
    lay = REF.layout(cfg)
    assert lay["heights"].shape == (20, 20)
    assert lay["heights"].min() >= 1.0 and lay["heights"].max() < 101.0
    scene, _ = KIND.program(KIND.inputs(cfg, 7, CPU), cfg, CPU, with_bvh=False)
    assert scene.num_planes == 2401 and scene.num_spheres == 1006
    assert bool((scene.planes.ptype == T.QUAD).all())
    local = lay["cluster"] - np.array(cfg["cluster"]["translate"])
    th = math.radians(15.0)
    back = np.stack([math.cos(th) * local[:, 0] - math.sin(th) * local[:, 2], local[:, 1],
                     math.sin(th) * local[:, 0] + math.cos(th) * local[:, 2]], axis=1)
    assert back.shape == (1000, 3) and back.min() >= -1e-9 and back.max() < 165.0
    assert back.min() < 5.0 and back.max() > 160.0  # the points fill the cube
    np.testing.assert_array_equal(np.sort(lay["noise_perm"], axis=1),
                                  np.tile(np.arange(256), (3, 1)))
    np.testing.assert_allclose(np.linalg.norm(lay["noise_vectors"], axis=1), 1.0, atol=1e-12)
    # the boxes' tops at their heights, in the port's frame (z up)
    tops = scene.planes.base[1:2400:6, 2].numpy()
    np.testing.assert_allclose(np.sort(tops), np.sort(lay["heights"].reshape(-1)), rtol=1e-6)


def test_box_helper_gives_six_quads_that_close_the_box():
    buf = builders.SceneBuffers()
    m = buf.add_material(T.LAMBERTIAN, albedo=(0.5, 0.5, 0.5))
    builders.add_box(buf, (1.0, 2.0, 3.0), (4.0, 6.0, 8.0), m)
    scene = builders.buffers_to_scene(buf, CPU)
    assert scene.num_planes == 6 and scene.motion is None and not scene.nextweek
    o = torch.tensor([[2.5, 4.0, 5.5]]).repeat(6, 1)  # the centre
    d = torch.tensor([[0, 0, -1.0], [0, 0, 1.0], [0, -1.0, 0], [0, 1.0, 0], [-1.0, 0, 0],
                      [1.0, 0, 0]])
    rec = hit.hit_scene_brute(scene, o, d)
    assert rec.winner.tolist() == [0, 1, 2, 3, 4, 5]
    torch.testing.assert_close(rec.t, torch.tensor([2.5, 2.5, 2.0, 2.0, 1.5, 1.5]))


# ---- the Perlin marble -------------------------------------------------------------------

def _book_perlin_turb(vec64, perm, p, depth=7):
    """A float64 transcription of the book's perlin::noise and turb."""
    def noise(p):
        u, v, w = (p[k] - math.floor(p[k]) for k in range(3))
        i, j, k = (int(math.floor(p[a])) for a in range(3))
        uu, vv, ww = (x * x * (3 - 2 * x) for x in (u, v, w))
        acc = 0.0
        for di in range(2):
            for dj in range(2):
                for dk in range(2):
                    c = vec64[perm[0][(i + di) & 255] ^ perm[1][(j + dj) & 255]
                              ^ perm[2][(k + dk) & 255]]
                    acc += ((di * uu + (1 - di) * (1 - uu)) * (dj * vv + (1 - dj) * (1 - vv))
                            * (dk * ww + (1 - dk) * (1 - ww))
                            * (c[0] * (u - di) + c[1] * (v - dj) + c[2] * (w - dk)))
        return acc

    acc, weight, q = 0.0, 1.0, list(p)
    for _ in range(depth):
        acc += weight * noise(q)
        weight *= 0.5
        q = [2 * x for x in q]
    return abs(acc)


def test_turb_matches_the_books_perlin_in_float64():
    """At fixed points (negative coordinates, lattice points, the marble's
    own range) the float32 turb of the twin and of the reference lie within
    float32 rounding of the book's double: 1e-5 of a turb that is at most
    about 1.5 (seven octaves of sums of eight float32 products)."""
    lay = REF.layout(dict(CONFIG))
    vec64, perm = lay["noise_vectors"], lay["noise_perm"]
    pts = [(0.3, 1.7, -2.2), (-5.5, 0.0, 3.25), (3.0, -4.0, 7.0), (220.4, 301.9, -279.3),
           (-0.01, -0.99, 0.5), (141.421, 17.32, -8.0)]
    want = np.array([_book_perlin_turb(vec64, perm, p) for p in pts])
    n = T.make_noise(vec64, perm, 0.1, CPU)
    p32 = torch.tensor(pts, dtype=torch.float32)
    got = noise_mod.turb(n.vectors, n.perm, p32).double().numpy()
    # the float32 point itself is off by an ulp of the coordinate: compare at it
    want32 = np.array([_book_perlin_turb(vec64, perm, p) for p in p32.double().tolist()])
    np.testing.assert_allclose(got, want32, rtol=0, atol=1e-5)
    assert np.abs(want32 - want).max() < 1e-3 and got.max() > 0.1
    ref_scene = REF.scene({"layout": lay, "texture": np.zeros((2, 2, 3), np.float32)},
                          dict(CONFIG), CPU)
    assert torch.equal(REF.turb(ref_scene, p32), noise_mod.turb(n.vectors, n.perm, p32))


def test_marble_is_taken_in_the_books_frame():
    """The marble at a port point is the book's at (x, z, -y): its sine's
    argument scale * z_book + 10 turb."""
    lay = REF.layout(dict(CONFIG))
    n = T.make_noise(lay["noise_vectors"], lay["noise_perm"], 0.1, CPU)
    p = torch.tensor([[220.0, -300.0, 280.0], [1.5, -2.5, 3.5]])
    book = torch.stack([p[:, 0], p[:, 2], -p[:, 1]], dim=1)
    want = 0.5 * (1.0 + torch.sin(0.1 * book[:, 2] + 10.0 * noise_mod.turb(n.vectors, n.perm,
                                                                          book)))
    assert torch.equal(noise_mod.marble(n, p), want)
    assert bool(((want >= 0) & (want <= 1)).all())


# ---- media --------------------------------------------------------------------------------

@pytest.mark.parametrize("density,length", [(0.2, 3.0), (0.05, 8.0)])
def test_free_flight_scatters_one_minus_exp_minus_density_length(density, length):
    """Rays up the z axis from just inside a slab of length L: the share that
    scatters inside is 1 - exp(-density L), within four standard errors."""
    scene = _slab_scene(density, length)
    n = 1 << 15
    o = torch.zeros(n, 3)
    o[:, 2] = 2e-3  # just past T_MIN of the entry
    d = torch.tensor([[0.0, 0.0, 2.0]]).repeat(n, 1)  # |d| = 2: the flight is in world units
    seed = rng.sample_seed(torch.full((n,), 99, dtype=torch.int64), torch.arange(n))
    t_surface = torch.full((n,), T.K_INFINITY)
    _, m, t = integrator.medium_scatter(scene.media, o, d, t_surface, seed)
    share = float((m >= 0).double().mean())
    # the interval starts at t = T_MIN, 2e-3 further up at |d| = 2
    p = 1.0 - math.exp(-density * (length - 4e-3))
    assert abs(share - p) < 4 * math.sqrt(p * (1 - p) / n)
    won = m >= 0
    z = (o + t[:, None] * d)[won, 2]
    assert float(z.min()) >= 2e-3 and float(z.max()) <= length * (1 + 1e-6)
    # a surface before the slab's end cuts the interval there
    _, m2, t2 = integrator.medium_scatter(scene.media, o, d, torch.full((n,), 0.25), seed)
    assert float((o + t2[:, None] * d)[m2 >= 0, 2].max()) <= (2e-3 + 0.5) * (1 + 1e-6)


def test_media_take_one_draw_each_in_table_order_crossed_or_not():
    """Two media, one that the rays cross and one far away: each query takes
    one draw a medium, in table order, whether or not the ray crosses it;
    the crossed medium's flight is the first draw's."""
    far = T.make_media([[0.0, 0.0, 2.0], [1e4, 1e4, 1e4]], [2.0, 1.0], [0.5, 3.0],
                       [[0.5, 0.5, 0.5], [1, 1, 1]], CPU)
    n = 4096
    o = torch.zeros(n, 3)
    o[:, 2] = 2e-3
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    seed = rng.sample_seed(torch.full((n,), 5, dtype=torch.int64), torch.arange(n))
    after, m, t = integrator.medium_scatter(far, o, d, torch.full((n,), T.K_INFINITY), seed)
    assert torch.equal(after, rng.wang_hash(rng.wang_hash(seed)))
    _, u = rng.random_float(seed)
    flight = -torch.log(u) / 0.5
    # the crossed interval runs from t = T_MIN to the boundary at z = 4, |d| = 1
    inside = 4.0 - 2e-3 - 1e-3
    clear = (flight - inside).abs() > 1e-4  # away from float32's rounding of the ends
    assert torch.equal((m >= 0)[clear], (flight <= inside)[clear])
    assert bool((m[m >= 0] == 0).all()) and 0.2 < float((m >= 0).double().mean()) < 0.99


def test_a_medium_scatter_takes_the_budgets_ball_and_the_mediums_albedo():
    """The ISOTROPIC code: along the 8-draw budget's ball draw, the medium's
    albedo as the attenuation, the eight draws of every code."""
    n = 64
    g = torch.Generator().manual_seed(4)
    seed = torch.randint(0, 2**32, (n,), generator=g, dtype=torch.int64)
    point = torch.randn(n, 3, generator=g)
    alb = torch.rand(n, 3, generator=g)
    out = scatter_mod.scatter(torch.zeros(n, 3), torch.randn(n, 3, generator=g), point,
                              vec.unit_vector(torch.randn(n, 3, generator=g)),
                              torch.ones(n, dtype=torch.bool), torch.full((n,), T.ISOTROPIC),
                              torch.zeros(n), torch.ones(n), torch.zeros(n, 3), alb, seed)
    s = seed
    for _ in range(3):
        s = rng.wang_hash(s)
    _, ball, _ = rng.random_ball(s)
    want = seed
    for _ in range(8):
        want = rng.wang_hash(want)
    assert torch.equal(out[0], want) and torch.equal(out[2], ball)
    assert torch.equal(out[1], point) and torch.equal(out[3], alb) and bool(out[4].all())


# ---- the moving sphere ------------------------------------------------------------------

def _moving_scene():
    buf = builders.SceneBuffers()
    m = buf.add_material(T.RTIOW_LAMBERTIAN, albedo=(0.5, 0.5, 0.5))
    buf.add_sphere((0.0, 0.0, 0.0), 1.0, m, motion=(10.0, 0.0, 0.0))
    buf.add_sphere((5.0, 20.0, 0.0), 1.0, m)
    return builders.buffers_to_scene(buf, CPU, with_bvh=True)


@pytest.mark.parametrize("intersector", ["brute", "bvh"])
def test_moving_sphere_is_hit_where_its_time_puts_it(intersector):
    """Rays down the z axis over c0 and over c1 = c0 + (10, 0, 0): at time
    0 the first hits and the second misses, near 1 the other way round; at
    time 0.5 the sphere lies at c0 + (5, 0, 0)."""
    scene = _moving_scene()
    o = torch.tensor([[0.0, 0.0, 5.0], [10.0, 0.0, 5.0], [5.0, 0.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(3, 1)
    fn = (lambda t: bvh_traverse_hit(scene, o, d, t)) if intersector == "bvh" else (
        lambda t: hit.hit_scene_brute(scene, o, d, time=t))
    at0 = fn(torch.zeros(3))
    at1 = fn(torch.full((3,), 1.0 - 2**-24))
    half = fn(torch.full((3,), 0.5))
    assert at0.hit.tolist() == [True, False, False]
    assert at1.hit.tolist() == [False, True, False]
    assert half.hit.tolist() == [False, False, True]
    torch.testing.assert_close(at1.normal[1], torch.tensor([0.0, 0.0, 1.0]))
    torch.testing.assert_close(at0.t[0], torch.tensor(4.0))


def bvh_traverse_hit(scene, o, d, t):
    from tracer_torch.bvh import traverse

    return traverse.hit_scene_bvh(scene, o, d, time=t)


def test_the_moving_spheres_box_covers_its_sweep_in_both_builders():
    buf = builders.SceneBuffers()
    m = buf.add_material(T.LAMBERTIAN)
    g = np.random.default_rng(3)
    for k in range(40):
        buf.add_sphere(g.uniform(-20, 20, 3), 0.5 + g.random(), m,
                       motion=(30.0, -4.0, 2.0) if k in (0, 17) else None)
    builders.add_box(buf, (-3, -3, -1), (3, 3, 0), m)
    motion = buf.motion_array()
    lo, hi, cent, kind, index = bvh_builder.primitive_boxes(
        np.stack(buf.sphere_center), np.asarray(buf.sphere_radius, np.float32),
        np.stack(buf.plane_base), np.stack(buf.plane_u), np.stack(buf.plane_v),
        np.asarray(buf.plane_type, np.int32), sphere_motion=motion)
    c = np.stack(buf.sphere_center)
    r = np.asarray(buf.sphere_radius, np.float32)[:, None]
    for k in (0, 17):
        assert (lo[k] <= np.minimum(c[k], c[k] + motion[k]) - r[k]).all()
        assert (hi[k] >= np.maximum(c[k], c[k] + motion[k]) + r[k]).all()
        np.testing.assert_array_equal(cent[k], (lo[k] + hi[k]) * np.float32(0.5))
    still = bvh_builder.primitive_boxes(
        np.stack(buf.sphere_center), np.asarray(buf.sphere_radius, np.float32),
        np.stack(buf.plane_base), np.stack(buf.plane_u), np.stack(buf.plane_v),
        np.asarray(buf.plane_type, np.int32))
    keep = np.ones(len(kind), bool)
    keep[[0, 17]] = False
    for a, b in zip((lo, hi, cent), still[:3]):
        np.testing.assert_array_equal(a[keep], b[keep])  # every other primitive as before
    trees = [bvh_builder.build_bvh_sah_numpy(lo, hi, cent, kind, index)]
    if native.available():
        trees.append(native.build_bvh_sah(lo, hi, cent, kind, index))
    for t in trees[1:]:
        for a, b in zip(trees[0], t):
            np.testing.assert_array_equal(a, b)
    box_min, box_max, left, right, nkind = trees[0][:5]
    for k in (0, 17):
        leaf = np.nonzero((left == -1) & (right == k) & (nkind == 0))[0][0]
        np.testing.assert_array_equal(box_min[leaf], lo[k])
        np.testing.assert_array_equal(box_max[leaf], hi[k])
    scene = builders.buffers_to_scene(buf, CPU, with_bvh=True)
    assert torch.equal(scene.motion, torch.from_numpy(motion))


# ---- scenes without book 2's fields keep the parent's frames ---------------------------

def _parents_scatter(ray_origin, ray_dir, point, normal, front_face, mtype, fuzz, ir,
                     absorption, albedo, seed):
    """scatter as it was before the ISOTROPIC code."""
    seed, u_choice = rng.random_float(seed)
    seed, hemi = rng.random_in_hemisphere(normal, seed)
    seed, ball, ball_dir = rng.random_ball(seed)
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
    new_origin, new_dir, attenuation, ok = scatter_mod._select(
        mtype, point, albedo, lam_dir, metal_dir, metal_ok, die_dir, die_origin, die_att,
        u_rr <= p_rr)
    rl_dir = normal + ball_dir
    rl_dir = torch.where(vec.near_zero(rl_dir)[..., None], normal, rl_dir)
    is_rl, is_rm = mtype == T.RTIOW_LAMBERTIAN, mtype == T.RTIOW_METAL
    new_dir = torch.where(is_rl[..., None], rl_dir,
                          torch.where(is_rm[..., None], refl_dir, new_dir))
    ok = ok | is_rl | (is_rm & (vec.dot(refl_dir, normal) > 0.0))
    return seed, new_origin, new_dir, attenuation, ok


def _parents_bounce(scene, background, carry, rr_start=None, depth=0, tape_fields=None,
                    clusters=None, intersector="brute", work=None, rng_mode="fixed", **_kw):
    """integrator._bounce as it was before book 2's fields."""
    from tracer_torch.bvh import traverse

    origin, direction, beta, final, seed, alive = carry
    if clusters is not None:
        rec = hit.hit_scene_clustered(scene, clusters, origin, direction)
    elif intersector == "bvh":
        rec = traverse.hit_scene_bvh(scene, origin, direction, work=work, live=alive)
    else:
        rec = hit.hit_scene_brute(scene, origin, direction)
    miss = alive & ~rec.hit
    if scene.sky is not None:
        background = integrator.sky_radiance(scene.sky, direction)
    final = final + torch.where(miss[..., None], beta * background, 0.0)
    active = alive & rec.hit
    albedo = rec.albedo
    if scene.textures is not None:
        tex_rgb = texture_mod.sample_bilinear(scene.textures, rec.tex_id, rec.u, rec.v)
        albedo = torch.where((rec.tex_id >= 0)[..., None], albedo * tex_rgb, albedo)
    final = final + torch.where(active[..., None], beta * rec.emit, 0.0)
    seed, new_origin, new_dir, attenuation, ok = scatter_mod.scatter(
        origin, direction, rec.point, rec.normal, rec.front_face,
        rec.mtype, rec.fuzz, rec.ir, rec.absorption, albedo, seed)
    live = active & ok
    beta = torch.where(live[..., None], beta * attenuation, beta)
    origin = torch.where(live[..., None], new_origin, origin)
    direction = torch.where(live[..., None], new_dir, direction)
    if rr_start is not None:
        seed, u_t = rng.random_float(seed)
        p = integrator.roulette_p(beta)
        do = live & (depth >= rr_start)
        kill = do & (u_t >= p)
        beta = beta * torch.where(do & ~kill, 1.0 / p, 1.0)[..., None]
        live = live & ~kill
    return origin, direction, beta, final, seed, live


def _old_scenes():
    """config.txt's scene (textured floor, point lights, the polyhedra), the
    field and the RTIOW final scene, each cut small, with their cameras."""
    from tracer_torch.scene import config

    text = list(spec.load_json(spec.BENCH_DIR / "configs" / "config_txt.json")["text"])
    text[2] = "24 16 50"
    p = config.read_scene_params("\n".join(text) + "\n")
    tex = np.random.default_rng(2).uniform(0.1, 1.0, (13, 20, 3)).astype(np.float32)
    cfg_scene = builders.create_scene(p, with_bvh=True, texture_loader=lambda _p: tex,
                                      device=CPU)
    cfg_cam = camera.camera_at(p.camera_path, 0, p.num_frames, 24, 16, p.fov_degrees,
                               device=CPU)
    field, _ = sphere_field(60, CPU)
    field = field._replace(bvh=bvh_builder.build_scene_bvh_from_scene(field))
    field_cam = camera.build_camera_data([30.0, 0.0, 14.0], [0.0, 0.0, 3.0], 24, 16, 55.0,
                                         background=SKY, device=CPU)
    rt = spec.scene_kind("rtiow_final")
    rt_cfg = rt.tiny(spec.load_json(spec.BENCH_DIR / "configs" / "rtiow_final.json"))
    rt_scene, rt_p = rt.program(rt.inputs(rt_cfg, 1, CPU), rt_cfg, CPU, with_bvh=True)
    rt_cam = camera.camera_at(rt_p.camera_path, 0, rt_p.num_frames, 24, 16, rt_p.fov_degrees,
                              device=CPU)
    return {"config_txt": (cfg_scene, cfg_cam), "field": (field, field_cam),
            "rtiow": (rt_scene, rt_cam)}


@pytest.mark.parametrize("name", ["config_txt", "field", "rtiow"])
def test_scenes_without_book_2s_fields_render_bit_for_bit_as_before(name, monkeypatch):
    """Each frame, brute force and BVH (with roulette), equals the one the
    parent's bounce and scatter render in place of today's."""
    scene, cam = _old_scenes()[name]
    assert not scene.nextweek and pack.nextweek_features(scene) == []
    now = [renderer.render_frame(scene, cam, 24, 16, 2, 6, intersector=ix, rr_start=2)
           for ix in ("brute", "bvh")]
    monkeypatch.setattr(integrator, "_bounce", _parents_bounce)
    monkeypatch.setattr(scatter_mod, "scatter", _parents_scatter)
    before = [renderer.render_frame(scene, cam, 24, 16, 2, 6, intersector=ix, rr_start=2)
              for ix in ("brute", "bvh")]
    for a, b in zip(now, before):
        assert float(a.mean()) > 0 and torch.equal(a, b)


def test_old_scenes_pack_as_before():
    """No book 2 field: the kernels' tables and mode are the parent's."""
    for scene, cam in _old_scenes().values():
        mode = megakernel._kernel_mode(megakernel.MODE_BVH, scene, cam)
        assert mode in (megakernel.MODE_BVH, megakernel.MODE_BVH_RTIOW)
        assert pack.book_features(scene, cam) == pack.rtiow_features(scene, cam)


# ---- packing ----------------------------------------------------------------------------

def _enum(name):
    body = re.search(rf"enum {name} \{{([^}}]*)\}}",
                     (ROOT / "tracer_torch/csrc/common.cuh").read_text()).group(1)
    return [x.strip() for x in body.split(",") if x.strip()]


def test_nextweek_rows_match_the_kernel_source():
    items = _enum("NextweekRow")
    assert items[-1] == "N_ROWS"
    assert tuple(x.split("_", 1)[1].lower() for x in items[:-1]) == pack.NEXTWEEK_ROWS
    items = _enum("MediumRow")
    assert items[-1] == "M_ROWS" and len(items) - 1 == len(pack.MEDIUM_ROWS)
    src = (ROOT / "tracer_torch/csrc/common.cuh").read_text()
    assert f"NOISE_POINTS = {pack.NOISE_POINTS};" in src and f"NOISE_TEX = {T.NOISE};" in src
    names = (ROOT / "tracer_torch/csrc/megakernel.cu").read_text()
    assert "COUNTS_OF = NEXTWEEK ? COUNTS + 3 : COUNTS" in names
    assert megakernel.COUNT_NAMES[-3:] == ("medium_tests", "medium_scatters", "noise_evals")
    assert megakernel.MODE_BVH_NEXTWEEK == 7 and "case 7:" in names


def test_camera_table_holds_book_2s_rows_in_the_kernels_order():
    scene, cam, _, _ = tiny_scene(CPU)
    t = pack.pack_camera_nextweek(cam, scene)
    c = len(pack.CAMERA_ROWS) + len(pack.RTIOW_ROWS)
    assert torch.equal(t[:c], pack.pack_camera_rtiow(cam, scene))
    assert t[c:c + 4].tolist() == [1.0, 2.0, 1.0, pytest.approx(0.1)]
    k = c + 4
    assert torch.equal(t[k:k + 768], scene.noise.vectors.reshape(-1))
    assert torch.equal(t[k + 768:k + 1536].long(), scene.noise.perm.reshape(-1).long())
    k += 1536
    med = t[k:k + 16].reshape(2, 8)
    assert torch.equal(med[:, :3], scene.media.center) and torch.equal(med[:, 4],
                                                                       scene.media.neg_inv_density)
    assert torch.equal(t[k + 16:], scene.motion.reshape(-1)) and t.dtype == torch.float32


# ---- refusals ---------------------------------------------------------------------------

def _one_feature_each():
    scene, cam, _, _ = tiny_scene(CPU, with_bvh=True)
    plain_mats = scene.materials._replace(
        mtype=torch.full_like(scene.materials.mtype, T.LAMBERTIAN),
        tex_id=torch.clamp_min(scene.materials.tex_id, -1))
    base = scene._replace(motion=None, media=None, noise=None, materials=plain_mats)
    return [("moving spheres", base._replace(motion=scene.motion), cam),
            ("participating media", base._replace(media=scene.media), cam),
            ("a noise texture", base._replace(noise=scene.noise), cam)]


@pytest.mark.parametrize("case", range(3))
def test_the_other_kernels_refuse_book_2s_fields(case):
    """K1, K1-rec, K1-cl, K1-ref (brute and BVH) and K2 raise before any
    launch, naming the feature; the plain reference stream, recording
    renderer and cluster-culled hit too. K1-bvh takes its NEXTWEEK mode."""
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
             "plain record": lambda: renderer.render_frame_record(scene, cam, 4, 2, 1, 2),
             "plain cluster-culled": lambda: renderer.render_frame(scene, cam, 4, 2, 1, 2,
                                                                   cluster_k=4)}
    for name, call in calls.items():
        with pytest.raises(ValueError, match=word) as e:
            call()
        assert "does not support" in str(e.value), name
    assert megakernel._kernel_mode(megakernel.MODE_BVH, scene, cam) == \
        megakernel.MODE_BVH_NEXTWEEK
    assert pack.nextweek_features(scene) == [word]


# ---- on the card ------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_the_twin_at_the_tiny_cut(dev):
    """K1-bvh's NEXTWEEK instantiation against the plain twin on the card,
    camera sample by camera sample (one-sample launches at eight sample
    starts): nvcc's FMA contraction rounds otherwise than the twin's
    separate operations and sends a few samples down another valid path
    (glass, the fog's flights, box edges), so 99% of the samples agree to
    1e-3 and the frame's L1 difference is within 1% of its sum."""
    scene, cam, cfg, _ = tiny_scene(dev)
    w, h, d = cfg["width"], cfg["height"], cfg["max_depth"]
    before = megakernel.LAUNCHES_BVH
    got = torch.stack([megakernel.render_frame_kernel(scene, cam, w, h, 1, d, sample_start=s,
                                                      intersector="bvh") for s in range(8)])
    assert megakernel.LAUNCHES_BVH == before + 8
    want = torch.stack([renderer.render_frame(scene, cam, w, h, 1, d, sample_start=s,
                                              intersector="bvh") for s in range(8)])
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.isfinite(got).all() and float(want.mean()) > 0.05
    diff = (got - want).abs()
    assert (diff.amax(dim=-1) < 1e-3).double().mean() >= 0.99, f"max {diff.max()}"
    assert float(diff.sum() / want.abs().sum()) < 0.01
    with pytest.raises(ValueError, match="does not support"):
        megakernel.render_frame_kernel(scene, cam, w, h, 1, d)


@pytest.mark.cuda
def test_counters_against_the_twin_without_fma_contraction(dev, monkeypatch):
    """Built with -fmad=false, the counted NEXTWEEK instantiation counts its
    samples exactly and the media's tests as the media times its queries;
    its queries and book 2's three counters are the plain twin's (`events`,
    on the CPU) within what the few samples add that the card's sinf,
    cosf, logf and cbrtf, rounding otherwise than the CPU's by an ulp,
    send down another path: 0.1% of the queries for the queries (3 of
    34,196 on an H100), 0.5% of them for the others (noise_evals read 845
    against 835 there). The host build of the kernel's source, with the
    CPU's, gives the twin's counts unit for unit."""
    from tracer_torch.kernels import nvcc

    monkeypatch.setattr(nvcc, "SOURCE_FLAGS", {**nvcc.SOURCE_FLAGS,
                                               "megakernel": ("-fmad=false",)})
    nvcc.build_all.cache_clear()
    try:
        scene, cam, cfg, _ = tiny_scene(dev)
        w, h, spp, d = cfg["width"], cfg["height"], cfg["sqrt_spp"] ** 2, cfg["max_depth"]
        work = megakernel.loop_work(scene, cam, w, h, spp, d, intersector="bvh")
    finally:
        nvcc.build_all.cache_clear()
    events, queries = [], []
    scene, cam, _, _ = tiny_scene(CPU)
    i, j, base = renderer.pixel_grid(w, h, device=CPU)
    renderer.render_pixels(scene, cam, i, j, base, spp, d, intersector="bvh", queries=queries,
                           events=events)
    twin = [int(sum(int(e[k]) for e in events)) for k in range(3)]
    q = int(torch.stack(queries).sum())
    assert work.samples == w * h * spp and work.medium_tests == 2 * work.queries
    assert abs(work.queries - q) <= 1e-3 * q
    for got, want in zip((work.medium_tests, work.medium_scatters, work.noise_evals), twin):
        assert want > 0 and abs(got - want) <= 5e-3 * q, (got, want)
