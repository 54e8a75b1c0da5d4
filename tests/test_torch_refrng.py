"""The reference-stream RNG (`rng_mode="reference"`) of tracer_torch against
tracer's, on the CPU: the rejection samplers, `scatter_reference` for
every material, frames against tracer's XLA renderer and against
tests/oracle.py's unbounded loops, the exhausted-lane tail, and the
refusals.

Tolerances: the samplers' seeds and the rejection sampler's points
bit-equal (2^21 seeds; the accept test sums (x*x + y*y) + z*z in that
order on both sides); unit and hemisphere directions within 1e-6 (the
normalisation's rsqrt may round otherwise); scatter_reference's seeds and
flags equal, origins, directions and attenuations by test_torch_geometry.
py:test_scatter's rule (rtol 1e-5, atol 1e-6: XLA:CPU contracts the
refraction's multiply-adds, which moves one refracted direction of 4096
by 1.7e-6). Frames: a pixel
agrees when its max channel |diff| < 1e-3 and >= 99% of pixels must agree,
frame means within a relative 1e-3 (tests/test_parity.py:147's rule);
chunked frames against one shot within 1e-5 (float32 addition order).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from tracer.bvh import builder as jax_bb
from tracer.core import rng as jax_rng
from tracer.materials import scatter as jax_scatter
from tracer.render import camera as jax_camera
from tracer.render import renderer as jax_renderer
from tracer.scene import types as jax_T
from tracer_torch.core import rng
from tracer_torch.kernels import megakernel
from tracer_torch.materials import scatter
from tracer_torch.render import camera, integrator, renderer
from tracer_torch.scene import types as T

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_render import _both, _jcam, _smoke, assert_frames_agree  # noqa: E402
from test_torch_scene import torch_scene_fields  # noqa: E402
from torch_scenes import one_torch_thread  # noqa: E402,F401
from torch_scenes import (EXHAUSTED_SEEDS, SKY, closed_sphere, exhausted_lane_view,  # noqa: E402
                          full_scene, sample_start_reaching, tie_free_scene)

N_SEEDS = 2**21


def _t(seeds_u32):
    return torch.from_numpy(np.asarray(seeds_u32, np.uint32).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


# ---- samplers ---------------------------------------------------------------

def test_rejection_sampler_bit_equal_on_2_21_seeds():
    s = np.arange(N_SEEDS, dtype=np.uint32)
    want_seed, want = (np.asarray(x) for x in jax_rng.random_in_unit_sphere_rejection(
        jnp.asarray(s)))
    got_seed, got = rng.random_in_unit_sphere_rejection(_t(s))
    np.testing.assert_array_equal(_u32(got_seed), want_seed)
    np.testing.assert_array_equal(got.numpy(), want)  # bit-equal floats
    zero = np.nonzero((got.numpy() == 0).all(axis=-1))[0]
    assert tuple(zero[:len(EXHAUSTED_SEEDS)]) == EXHAUSTED_SEEDS
    assert (got.numpy() ** 2).sum(-1).max() < 1.0


@pytest.mark.parametrize("seed", [44716, 101402])
def test_exhausted_lane_returns_zero_after_48_draws(seed):
    """tracer's code (not its docstring) keeps the zero vector on a lane
    that accepts none of its 16 tries, and that lane's seed has taken all
    48 draws; the port does the same."""
    got_seed, got = rng.random_in_unit_sphere_rejection(_t([seed]))
    want = _t([seed])
    for _ in range(3 * rng.MAX_REJECTION_TRIES):
        want = rng.wang_hash(want)
    assert torch.equal(got_seed, want)
    assert torch.equal(got, torch.zeros(1, 3))
    j_seed, j_val = jax_rng.random_in_unit_sphere_rejection(jnp.asarray([seed], jnp.uint32))
    assert int(j_seed[0]) == int(want[0]) and not np.asarray(j_val).any()
    # the unit vector of the zero point is zero, its hemisphere flip -0, and
    # the Lambertian scatter then takes the normal (near_zero)
    _, d = rng.random_unit_vector_ref(_t([seed]))
    assert torch.equal(d, torch.zeros(1, 3))


def test_random_float_range_bit_equal():
    s = np.random.default_rng(0).integers(0, 2**32, size=100_000, dtype=np.uint64)
    s = s.astype(np.uint32)
    want_seed, want = (np.asarray(x) for x in jax_rng.random_float_range(jnp.asarray(s), -1.0,
                                                                          1.0))
    got_seed, got = rng.random_float_range(_t(s), -1.0, 1.0)
    np.testing.assert_array_equal(_u32(got_seed), want_seed)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["unit_vector_ref", "in_hemisphere_ref"])
def test_ref_direction_samplers_match(name):
    n = 2**18
    s = np.arange(n, dtype=np.uint32)
    s[:len(EXHAUSTED_SEEDS)] = EXHAUSTED_SEEDS
    normal = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    if name == "unit_vector_ref":
        want_seed, want = jax_rng.random_unit_vector_ref(jnp.asarray(s))
        got_seed, got = rng.random_unit_vector_ref(_t(s))
    else:
        want_seed, want = jax_rng.random_in_hemisphere_ref(jnp.asarray(normal), jnp.asarray(s))
        got_seed, got = rng.random_in_hemisphere_ref(torch.from_numpy(normal), _t(s))
    np.testing.assert_array_equal(_u32(got_seed), np.asarray(want_seed))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    norms = np.linalg.norm(got.numpy(), axis=-1)
    exhausted = np.isin(s, EXHAUSTED_SEEDS)  # 10 listed, and 5 more at their own index
    assert exhausted.sum() == 15 and (norms[exhausted] == 0).all()
    np.testing.assert_allclose(norms[~exhausted], 1.0, atol=1e-6)


# ---- scatter_reference ---------------------------------------------------------

MATERIALS = {"lambertian": T.LAMBERTIAN, "metal": T.METAL, "dielectric": T.DIELECTRIC,
             "light": T.DIFFUSE_LIGHT}


def _hits(kind, n=4096, seed=0):
    """Per-ray scatter inputs: random rays at random hit points, the
    face-oriented normal against the incoming direction. "tir" rays leave
    glass (back face, ir 1.5) at grazing angles, so most cannot refract."""
    g = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    normal = g.normal(size=(n, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    d = g.normal(size=(n, 3))
    if kind == "tir":
        t = np.cross(normal, g.normal(size=(n, 3)))
        t /= np.linalg.norm(t, axis=-1, keepdims=True)
        d = t * 3.0 - normal * g.uniform(0.05, 0.6, size=(n, 1))
        front = np.zeros(n, bool)
    else:
        front = g.uniform(size=n) < 0.5
    d = np.where((np.sum(d * normal, -1) > 0)[:, None], -d, d)  # incoming: against the normal
    mtype = MATERIALS.get(kind, T.DIELECTRIC)
    origin = g.normal(size=(n, 3)) * 3
    point = origin + d * g.uniform(0.5, 4.0, size=(n, 1))
    return dict(ray_origin=f32(origin), ray_dir=f32(d), point=f32(point), normal=f32(normal),
                front_face=front, mtype=np.full(n, mtype, np.int32),
                fuzz=f32(g.uniform(0, 0.5, n)), ir=f32(np.full(n, 1.5)),
                absorption=f32(g.uniform(0, 0.5, (n, 3))), albedo=f32(g.uniform(0, 1, (n, 3))),
                seed=g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32))


@pytest.mark.parametrize("kind", ["lambertian", "metal", "dielectric", "tir", "light"])
def test_scatter_reference_matches_tracer(kind):
    args = _hits(kind)
    want = [np.asarray(x) for x in jax_scatter.scatter_reference(
        **{k: jnp.asarray(v) for k, v in args.items()})]
    got = scatter.scatter_reference(**{k: torch.from_numpy(v.astype(np.int64)) if k == "seed"
                                       else torch.from_numpy(v) for k, v in args.items()})
    np.testing.assert_array_equal(_u32(got[0]), want[0])
    for name, g, w in zip(("origin", "direction", "attenuation"), got[1:4], want[1:4]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), want[4])
    draws = _draws(args["seed"], _u32(got[0]))
    if kind == "light":
        assert (draws == 0).all() and not got[4].any()  # no draws, the path ends
    elif kind == "tir":
        # a ray that cannot refract skips the reflectance draw: 1 draw (roulette)
        cannot = _cannot_refract(args)
        assert cannot.mean() > 0.3 and (draws[cannot] == 1).all() and (draws[~cannot] == 2).all()
    elif kind == "dielectric":
        assert set(np.unique(draws)) <= {1, 2}
    else:  # rejection loops: 3 draws a try (after the metal's gate draw)
        assert ((draws - (kind == "metal")) % 3 == 0).all() and draws.max() > 3


def _draws(before, after, limit=60):
    """How many wang_hash steps lead from each `before` seed to `after`."""
    cur = _t(before)
    out = np.full(before.shape, -1)
    after = _t(after)
    for k in range(limit + 1):
        hit = (cur == after).numpy() & (out < 0)
        out[hit] = k
        cur = rng.wang_hash(cur)
    assert (out >= 0).all()
    return out


def _cannot_refract(args):
    d = args["ray_dir"] / np.linalg.norm(args["ray_dir"], axis=-1, keepdims=True)
    cos_t = np.minimum(np.sum(-d * args["normal"], -1), 1.0)
    sin_t = np.sqrt(np.maximum(0.0, 1.0 - cos_t * cos_t))
    ratio = np.where(args["front_face"], 1.0 / args["ir"], args["ir"])
    return ratio * sin_t > 1.0


# ---- frames --------------------------------------------------------------------

def _jax_scene(scene, bvh=False):
    """A tracer Scene (and, with `bvh`, tracer's BVH) of a port scene."""
    f = torch_scene_fields(scene)
    grp = lambda cls, pre: cls(*(jnp.asarray(f[f"{pre}.{n}"]) for n in cls._fields))
    sp, pl = grp(jax_T.Spheres, "spheres"), grp(jax_T.Planes, "planes")
    tree = None
    if bvh:
        tree = jax_bb.build_bvh_arrays(f["spheres.center"], f["spheres.radius"],
                                       f["planes.base"], f["planes.u"], f["planes.v"],
                                       f["planes.ptype"])
    tex = jnp.asarray(f["textures"]) if "textures" in f else None
    return jax_T.Scene(sp, pl, grp(jax_T.Materials, "materials"), tex, tree)


def _pair(name, bvh=False):
    """(tracer scene, tracer camera, port scene, port camera, w, h) with the
    same BVH on both sides."""
    if name == "smoke":
        jscene, jcam = _smoke(jax_side=True), _jcam(24, 16, background=SKY)
        if bvh:
            jscene = _jax_scene(_both(jscene, jcam)[0], bvh=True)
    else:
        jscene = _jax_scene(tie_free_scene("cpu"), bvh=bvh)
        jcam = jax_camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 24, 16, 55.0,
                                            background=SKY)
    fields = {f"{g}.{n}": np.asarray(x) for g in ("spheres", "planes", "materials")
              for n, x in getattr(jscene, g)._asdict().items()}
    if jscene.bvh is not None:
        fields.update({f"bvh.{k}": np.asarray(v) for k, v in jscene.bvh._asdict().items()})
    scene = T.scene_from_numpy(fields, "cpu")
    cam = camera.camera_from_numpy({k: np.asarray(v) for k, v in jcam._asdict().items()}, "cpu")
    return jscene, jcam, scene, cam, 24, 16


@pytest.mark.parametrize("intersector", ["brute", "bvh"])
@pytest.mark.parametrize("name", ["smoke", "tie_free"])
def test_reference_frame_matches_tracer(name, intersector):
    jscene, jcam, scene, cam, w, h = _pair(name, bvh=intersector == "bvh")
    want = jax_renderer.render_frame(jscene, jcam, w, h, spp=2, max_depth=6, chunk=w * h,
                                     intersector=intersector, rng_mode="reference")
    got = renderer.render_frame(scene, cam, w, h, 2, 6, intersector=intersector,
                                rng_mode="reference")
    assert_frames_agree(got, want)
    fixed = renderer.render_frame(scene, cam, w, h, 2, 6, intersector=intersector)
    assert (fixed - got).abs().max() > 1e-3  # another stream


def test_reference_frame_stratified_matches_tracer():
    jscene, jcam, scene, cam, w, h = _pair("tie_free")
    want = jax_renderer.render_frame(jscene, jcam, w, h, spp=4, max_depth=5, chunk=w * h,
                                     intersector="brute", rng_mode="reference", stratify=True)
    got = renderer.render_frame(scene, cam, w, h, 4, 5, rng_mode="reference", stratify=True)
    assert_frames_agree(got, want)


def test_reference_frame_chunks_match_tracer_and_one_shot():
    """Sample chunks (sample_start) of the reference stream add up to the
    one-shot frame, and each chunk is tracer's render_pixels chunk."""
    jscene, jcam, scene, cam, w, h = _pair("smoke")
    one = renderer.render_frame(scene, cam, w, h, 5, 5, rng_mode="reference")
    parts = [renderer.render_frame(scene, cam, w, h, n, 5, rng_mode="reference", sample_start=s)
             for s, n in ((0, 2), (2, 3))]
    torch.testing.assert_close(parts[0] + parts[1], one, rtol=1e-5, atol=1e-5)
    ji, jj, jseed = jax_renderer.pixel_grid(w, h)
    want = jax_renderer.render_pixels(jscene, jcam, ji, jj, jseed, 3, 5, intersector="brute",
                                      chunk=w * h, sample_start=2, rng_mode="reference")
    assert_frames_agree(parts[1], np.asarray(want).reshape(h, w, 3))


def _oracle_scene(scene):
    f = torch_scene_fields(scene)
    mats = [{k: f[f"materials.{k}"][m] for k in T.Materials._fields}
            for m in range(scene.materials.mtype.shape[0])]
    planes = [{"ptype": int(f["planes.ptype"][k]), "base": f["planes.base"][k],
               "u": f["planes.u"][k], "v": f["planes.v"][k], "normal": f["planes.normal"][k],
               "d": f["planes.d"][k], "w": f["planes.w"][k],
               "mat": int(f["planes.material_idx"][k])} for k in range(scene.num_planes)]
    return {"sphere_center": f["spheres.center"], "sphere_radius": f["spheres.radius"],
            "sphere_mat": f["spheres.material_idx"], "planes": planes, "materials": mats,
            "textures": f.get("textures")}


def _oracle_cam(cam):
    return {k: v.numpy() for k, v in cam._asdict().items()}


@pytest.mark.parametrize("name, quirk", [("full", True), ("full", False), ("tie_free", True)])
def test_reference_frame_matches_unbounded_oracle(name, quirk):
    """The oracle runs the reference's unbounded rejection loops
    (tests/oracle.py); the port's bounded loops match it wherever no lane
    exhausts its 16 tries."""
    scene = full_scene("cpu") if name == "full" else tie_free_scene("cpu")
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 16, 12, 55.0,
                                   background=SKY, device="cpu")
    got = renderer.render_frame(scene, cam, 16, 12, 2, 5, reference_quirk=quirk,
                                rng_mode="reference")
    want = oracle.render(_oracle_scene(scene), _oracle_cam(cam), 16, 12, spp=2, max_depth=5,
                         reference_quirk=quirk, rng_mode="reference")
    assert_frames_agree(got, want)


@pytest.mark.parametrize("seed", [44716, 101402])
def test_exhausted_lane_frame_matches_tracer_not_the_unbounded_oracle(seed):
    """A one-pixel frame whose first bounce (the Lambertian floor straight
    below the light, torch_scenes.exhausted_lane_view) draws its hemisphere
    direction from an exhausted seed: the port takes tracer's tail (the
    normal, into the light) and agrees with tracer's renderer; the
    reference's unbounded loop draws on, takes another direction, and
    another radiance."""
    scene, cam = exhausted_lane_view("cpu")
    i, j, base = renderer.pixel_grid(1, 1, device="cpu")
    start = sample_start_reaching(seed, int(base[0]))
    s = rng.sample_seed(base, start)
    s, _ = rng.random_float(rng.random_float(s)[0])
    assert int(s[0]) == seed  # the first scatter's seed
    got = renderer.render_frame(scene, cam, 1, 1, 1, 6, sample_start=start,
                                rng_mode="reference").reshape(3)
    # floor albedo 0.5 times the light's emission (6, 5, 4)
    np.testing.assert_allclose(got.numpy(), [3.0, 2.5, 2.0], rtol=1e-6)
    jscene = _jax_scene(scene)
    jcam = jax_camera.CameraData(*(jnp.asarray(x.numpy()) for x in cam))
    ji, jj, jseed = jax_renderer.pixel_grid(1, 1)
    want = jax_renderer.render_pixels(jscene, jcam, ji, jj, jseed, 1, 6, intersector="brute",
                                      chunk=1, sample_start=start, rng_mode="reference")
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(3), rtol=1e-6)
    # the unbounded loop: the oracle's sample with the same seeds
    sample = rng.sample_seed(base, start)
    r = oracle.Rng(int(sample[0]))
    cam_np = _oracle_cam(cam)
    ox, oy = r.random_float() - np.float32(0.5), r.random_float() - np.float32(0.5)
    d = (cam_np["pixel00_loc"] + ox * cam_np["pixel_delta_u"] + oy * cam_np["pixel_delta_v"]
         - cam_np["origin"]).astype(np.float32)
    unbounded = oracle.ray_color(_oracle_scene(scene), r, cam_np["origin"], d,
                                 cam_np["background"], 6, rng_mode="reference")
    assert np.abs(unbounded - got.numpy()).max() > 0.1


def test_kernel_wrapper_takes_the_plain_reference_stream_for_cpu_tensors():
    scene, cam = full_scene("cpu"), camera.build_camera_data(
        [5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 16, 8, 55.0, background=SKY, device="cpu")
    before = megakernel.LAUNCHES_REF
    got = megakernel.render_frame_kernel(scene, cam, 16, 8, 2, 4, rng_mode="reference",
                                         sample_start=3, stratify=True, strat_sqrt_spp=3)
    want = renderer.render_frame(scene, cam, 16, 8, 2, 4, rng_mode="reference", sample_start=3,
                                 stratify=True, strat_sqrt_spp=3)
    assert torch.equal(got, want)
    assert megakernel.LAUNCHES_REF == before  # the plain version is not a launch


def test_reference_query_count_counts_the_reference_paths():
    scene = closed_sphere("cpu")
    cam = camera.build_camera_data([0.0, 0.0, 0.0], [1.0, 0.3, 0.2], 6, 4, 70.0,
                                   background=SKY, device="cpu")
    # a Lambertian never absorbs: every path runs to max_depth on either stream
    for mode in integrator.RNG_MODES:
        assert renderer.query_count(scene, cam, 6, 4, 2, 3, rng_mode=mode) == 6 * 4 * 2 * 3


# ---- refusals --------------------------------------------------------------------

def test_reference_stream_refuses_rr_start_records_and_clusters():
    scene, cam = full_scene("cpu"), camera.build_camera_data(
        [5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 8, 4, 55.0, background=SKY, device="cpu")
    with pytest.raises(ValueError, match="rr_start requires the fixed-budget RNG stream"):
        renderer.render_frame(scene, cam, 8, 4, 1, 3, rr_start=1, rng_mode="reference")
    with pytest.raises(ValueError, match="rr_start requires the fixed-budget RNG stream"):
        megakernel.render_frame_kernel(scene, cam, 8, 4, 1, 3, rr_start=1, rng_mode="reference")
    i, j, base = renderer.pixel_grid(8, 4, device="cpu")
    with pytest.raises(ValueError, match="recording path runs the fixed-budget"):
        renderer.render_pixels(scene, cam, i, j, base, 1, 3, tape_fields=9,
                               rng_mode="reference")
    with pytest.raises(ValueError, match="cluster_k > 0 runs the fixed-budget"):
        renderer.render_frame(scene, cam, 8, 4, 1, 3, cluster_k=4, rng_mode="reference")
    with pytest.raises(ValueError, match="unknown rng_mode"):
        renderer.render_frame(scene, cam, 8, 4, 1, 3, rng_mode="philox")
    # tracer refuses rr_start on the reference stream the same way
    jscene = _jax_scene(scene)
    jcam = jax_camera.CameraData(*(jnp.asarray(x.numpy()) for x in cam))
    with pytest.raises(ValueError, match="rr_start requires the fixed-budget RNG stream"):
        jax_renderer.render_frame(jscene, jcam, 8, 4, 1, 3, intersector="brute", rr_start=1,
                                  rng_mode="reference")


def test_loop_work_refuses_what_has_no_counted_reference_instantiation():
    scene, cam = full_scene("cpu"), camera.build_camera_data(
        [5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 8, 4, 55.0, background=SKY, device="cpu")
    with pytest.raises(ValueError, match="counted inside the CUDA kernel"):
        megakernel.loop_work(scene, cam, 8, 4, 1, 3, rng_mode="reference")
