"""The brute kernels' object groups on the CPU: what the builders note,
what `kernels/pack.py:pack_groups` packs, and that the kernel's ball test
(csrc/megakernel.cu, copied here in float32) never rejects a group with a
primitive that reports a hit, on the plain renderer's own queries.

The cull is exact only if that holds: a primitive's test does not depend
on the others, so skipping primitives that report no hit leaves brute
force's winner, t, alpha and beta bit for bit. The card's tests
(tests/test_torch_cuda.py) hold the frames and tapes with and without
groups equal.
"""

import io
import math

import numpy as np
import pytest
import torch

from tracer_torch.core import T_MAX, T_MIN
from tracer_torch.kernels import pack
from tracer_torch.render import camera, hit, renderer
from tracer_torch.scene import builders, config
from tracer_torch.scene import types as T

from torch_scenes import one_torch_thread  # noqa: F401

PARAMS = config.read_scene_params(io.StringIO(config.default_config_text()))


def _config_scene():
    return builders.create_scene(PARAMS, texture_loader=lambda _path: None, device="cpu")


def _fma(x, y, z):
    """x * y + z rounded once (to float32, through float64, whose product
    of two float32s is exact): the contracted form of the kernel's a*b+c."""
    return (x.double() * y.double() + z.double()).float()


def _dot(x, y, contract=False):
    """The kernel's dot, (x0 y0 + x1 y1) + x2 y2, in float32, or in the
    form nvcc's contraction gives it."""
    if contract:
        return _fma(x[..., 2], y[..., 2], _fma(x[..., 1], y[..., 1], x[..., 0] * y[..., 0]))
    return (x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1]) + x[..., 2] * y[..., 2]


def ball_test(origin, direction, rec, contract=False):
    """`[R, G]` bool: the kernel's test of each ray against each group's
    ball, in float32 with its operations in its order, uncontracted or
    contracted."""
    o, d = origin.float(), direction.float()
    c, r, grow = rec[:, 0, :3], rec[:, 0, 3], rec[:, 2, 0]
    oc = o[:, None, :] - c[None]
    dd = d[:, None, :].expand_as(oc)
    b = _dot(oc, dd, contract)
    inv_a = 1.0 / _dot(d, d, contract)
    q = (b * inv_a[:, None])[..., None]
    l = _fma(-dd, q, oc) if contract else oc - dd * q
    oo = _dot(oc, oc, contract)
    rr = _fma(grow.expand_as(oo), oo, r.expand_as(oo)) if contract else grow * oo + r
    r2 = rr * rr
    return (_dot(l, l, contract) <= r2) & ((b <= 0.0) | (oo <= r2))


def sphere_hits(origin, direction, center, radius, contract=False):
    """`[R, S]` bool: the kernel's sphere_t reports a root in [T_MIN,
    T_MAX], in float32 with its operations in its order, uncontracted or
    contracted."""
    o, d = origin.float()[:, None, :], direction.float()[:, None, :]
    oc = o - center.float()[None]
    dd = d.expand_as(oc)
    r = radius.float()[None].expand(oc.shape[:2])
    a = _dot(dd, dd, contract)
    half_b = _dot(oc, dd, contract)
    if contract:
        c = _fma(-r, r, _dot(oc, oc, True))
        disc = _fma(half_b, half_b, -(a * c))
    else:
        c = _dot(oc, oc) - r * r
        disc = half_b * half_b - a * c
    sq = torch.sqrt(disc.clamp(min=0.0))
    inv_a = 1.0 / a
    ok = lambda t: (t >= T_MIN) & (t <= T_MAX)
    return (disc >= 0.0) & (ok((-half_b - sq) * inv_a) | ok((-half_b + sq) * inv_a))


def _group_of(scene, groups):
    """`[S + P]` long: each primitive's group, -1 outside every group."""
    of = torch.full((scene.num_spheres + scene.num_planes,), -1, dtype=torch.long)
    for g, (s_lo, s_hi, p_lo, p_hi) in enumerate(groups):
        of[s_lo:s_hi] = g
        of[scene.num_spheres + p_lo:scene.num_spheres + p_hi] = g
    return of


# ---- what the builders note and pack_groups packs ---------------------------------

def test_builders_note_one_group_a_polyhedron():
    scene = _config_scene()
    # octahedron: 36 edge lights, 8 faces + 12 borders; cube: 24, 12 + 6;
    # dodecahedron: 30, 36 + 30; then the floor quad and the 4 point lights
    assert scene.groups == ((0, 36, 0, 20), (36, 60, 20, 38), (60, 90, 38, 104))
    assert (scene.num_spheres, scene.num_planes) == (94, 105)
    of = _group_of(scene, scene.groups)
    mats = torch.cat([scene.spheres.material_idx, scene.planes.material_idx]).long()
    lights = scene.materials.mtype[mats] == T.DIFFUSE_LIGHT
    assert (of[90:94] == -1).all() and of[94 + 104] == -1  # point lights, floor
    assert lights[90:94].all() and lights[:90].all()  # the edge lights are in groups


def test_pack_groups_balls_hold_their_primitives_with_the_margin():
    scene = _config_scene()
    rec = pack.pack_groups(scene)
    assert rec.shape == (3, pack.GROUP_F4, 4) and rec.dtype == torch.float32
    ranges = rec[:, 1].contiguous().view(torch.int32).tolist()
    assert [tuple(r) for r in ranges] == list(scene.groups)
    sp, pl = scene.spheres, scene.planes
    corners = torch.stack([pl.base, pl.base + pl.u, pl.base + pl.v, pl.base + pl.u + pl.v],
                          dim=1).double()
    for g, (s_lo, s_hi, p_lo, p_hi) in enumerate(scene.groups):
        c, r = rec[g, 0, :3].double(), float(rec[g, 0, 3])
        far_s = ((sp.center[s_lo:s_hi].double() - c).norm(dim=1)
                 + sp.radius[s_lo:s_hi].double()).max()
        tri = pl.ptype[p_lo:p_hi] == T.TRIANGLE
        dist = (corners[p_lo:p_hi] - c).norm(dim=2)
        dist[tri, 3] = 0.0  # a triangle has three corners
        far = max(float(far_s), float(dist.max()))
        assert far * (1 + pack.GROUP_MARGIN) <= r <= far * (1 + 2 * pack.GROUP_MARGIN) + 1e-3
        assert 2.9 < far < 3.1  # the bodies' radius, 3.0 in config.txt
        # the growth with the origin's distance: 1.25 2^-18 / r_min and the
        # planes' term, r_min = 0.06 (the edge lights)
        assert 1.25 * pack.GROUP_ROUNDING / 0.06 < float(rec[g, 2, 0]) < 1e-4
        assert (rec[g, 2, 1:] == 0).all()


@pytest.mark.parametrize("shape", ["quad", "ellipse", "triangle"])
def test_pack_groups_ball_holds_each_plane_shape(shape):
    """One group of one plane: the ball holds the plane's corners (a
    triangle's three), and little more."""
    ptype = {"quad": T.QUAD, "ellipse": T.ELLIPSE, "triangle": T.TRIANGLE}[shape]
    buf = builders.SceneBuffers()
    m = buf.add_material(T.LAMBERTIAN, albedo=(0.5, 0.5, 0.5))
    buf.add_plane(ptype, (1.0, 2.0, 3.0), (4.0, 0.0, 0.0), (0.0, 2.0, 0.0), m)
    buf.groups.append((0, 0, 0, 1))
    rec = pack.pack_groups(builders.buffers_to_scene(buf, "cpu"))
    c, r = rec[0, 0, :3].double(), float(rec[0, 0, 3])
    pts = torch.tensor([[1.0, 2.0, 3.0], [5.0, 2.0, 3.0], [1.0, 4.0, 3.0], [5.0, 4.0, 3.0]],
                       dtype=torch.float64)
    held = (pts - c).norm(dim=1) * (1 + pack.GROUP_MARGIN) <= r
    assert held[:3].all() and (held[3] or shape == "triangle")
    assert r < math.sqrt(5.0) * 1.01  # the corners' box's half diagonal, and the margin
    assert 0 < float(rec[0, 2, 0]) < 1e-5  # no sphere: the planes' and the test's growth


def test_pack_groups_none_packs_zero_groups():
    scene = _config_scene()._replace(groups=None)
    assert pack.pack_groups(scene).shape == (0, pack.GROUP_F4, 4)
    field = builders.buffers_to_scene(builders.SceneBuffers(), "cpu")
    assert field.groups is None


@pytest.mark.parametrize("groups, what", [
    ([(0, 1, 0, 0)] * 33, "at most 32"),
    ([(0, 36, 0, 20), (30, 60, 20, 38)], "sphere range"),  # overlapping
    ([(36, 60, 20, 38), (0, 36, 0, 20)], "sphere range"),  # descending
    ([(0, 36, 20, 10)], "plane range"),  # empty the wrong way round
    ([(0, 36, 0, 106)], "plane range"),  # past the table
])
def test_pack_groups_refuses_bad_ranges(groups, what):
    with pytest.raises(ValueError, match=what):
        pack.pack_groups(_config_scene()._replace(groups=tuple(groups)))


def test_pack_groups_thirty_two_groups_and_empty_ones():
    scene = _config_scene()
    groups = tuple((k, k + 1, 0, 0) for k in range(31)) + ((31, 31, 0, 0),)
    rec = pack.pack_groups(scene._replace(groups=groups))
    assert rec.shape == (32, pack.GROUP_F4, 4)
    assert math.isnan(float(rec[31, 0, 3]))  # an empty group is never entered
    o, d = torch.tensor([[0.0, 0.0, 0.0]]), torch.tensor([[1.0, 0.0, 0.0]])
    assert not ball_test(o, d, rec[31:]).any()
    sp = scene.spheres
    for g in range(31):  # a group of one sphere: its own ball, a little larger
        c, r = rec[g, 0, :3].double(), float(rec[g, 0, 3])
        assert (c - sp.center[g].double()).norm() < 1e-6
        assert float(sp.radius[g]) * (1 + pack.GROUP_MARGIN) <= r <= float(sp.radius[g]) * 1.01


def test_pack_groups_is_cached_until_the_geometry_changes():
    scene = _config_scene()
    rec = pack.pack_groups(scene)
    assert pack.pack_groups(scene) is rec
    with torch.no_grad():
        scene.spheres.center[0] += 100.0  # an edge light of the octahedron, moved in place
    moved = pack.pack_groups(scene)
    assert moved is not rec and float(moved[0, 0, 3]) > 40.0
    assert torch.equal(moved[1:], rec[1:])


def test_pack_groups_non_finite_primitive_is_always_entered():
    scene = _config_scene()
    center = scene.spheres.center.clone()
    center[40, 0] = float("nan")  # a sphere of the cube
    rec = pack.pack_groups(scene._replace(spheres=scene.spheres._replace(center=center)))
    assert float(rec[1, 0, 3]) == float("inf")
    o = torch.tensor([[0.0, 50.0, 0.0]])
    d = torch.tensor([[0.0, 1.0, 0.0]])  # away from every ball
    assert ball_test(o, d, rec).tolist() == [[False, True, False]]


# ---- the ball test never rejects a group that holds a hit ---------------------------

def _replay(monkeypatch, scene, frames, rng_mode, w=24, h=16, spp=2, depth=50):
    """Render `frames` with the plain renderer and hold every query's ball
    tests against its primitives' hits; returns counts for the caller."""
    rec = pack.pack_groups(scene)
    of = _group_of(scene, scene.groups)
    planes = scene.planes
    stats = dict(queries=0, hits=0, rejected_hits=0, tested=0, on_face=0, max_dist=0.0)
    brute = hit.hit_scene_brute

    def recording(sc, origin, direction, t_min=T_MIN, t_max=T_MAX):
        ts = hit._all_ts(sc, origin, direction, t_min, t_max)
        valid = ts < T.K_INFINITY  # [R, S + P]: the primitives that report a hit
        passes = ball_test(origin, direction, rec)  # [R, G]
        grouped = of >= 0
        needed = torch.zeros_like(passes)
        for g in range(len(scene.groups)):
            needed[:, g] = valid[:, of == g].any(dim=1)
        stats["queries"] += origin.shape[0]
        stats["hits"] += int(valid.any(dim=1).sum())
        contracted = ball_test(origin, direction, rec, contract=True)
        stats["rejected_hits"] += int((needed & ~(passes & contracted)).sum())
        sizes = torch.bincount(of[grouped], minlength=len(scene.groups))
        stats["tested"] += (int((~grouped).sum()) * origin.shape[0]
                            + int((passes.long() @ sizes).sum()))
        # origins on a polyhedron's face: a bounce off glass (offset 1e-4) or a border
        pd = (origin @ planes.normal[of[scene.num_spheres:] >= 0].T
              - planes.d[of[scene.num_spheres:] >= 0]).abs()
        stats["on_face"] += int((pd.min(dim=1).values < 2e-4).sum())
        oc = (origin[:, None, :].double() - rec[None, :, 0, :3].double()).norm(dim=2)
        stats["max_dist"] = max(stats["max_dist"], float(oc.max()))
        return brute(sc, origin, direction, t_min, t_max)

    monkeypatch.setattr(hit, "hit_scene_brute", recording)
    for n in frames:
        cam = camera.camera_at(PARAMS.camera_path, n, PARAMS.num_frames, w, h,
                               PARAMS.fov_degrees, device="cpu")
        renderer.render_frame(scene, cam, w, h, spp, depth, rng_mode=rng_mode)
    return stats


@pytest.mark.parametrize("rng_mode", ["fixed", "reference"])
def test_ball_test_never_rejects_a_hit_on_config_txt(monkeypatch, rng_mode):
    """config.txt at 24x16 spp2 depth 50, frames 0, 20 and 50 (the
    dodecahedron fills the view at 50): no (query, group) where a primitive
    of the group reports a hit and the ball test rejects the group, among
    queries that start on a polyhedron's face too. The renderer queries
    its ended paths' rays too, so more queries miss than the kernel's."""
    s = _replay(monkeypatch, _config_scene(), (0, 20, 50), rng_mode)
    assert s["rejected_hits"] == 0
    assert s["queries"] > 3 * 24 * 16 * 2 * 5 and s["hits"] > s["queries"] // 10
    assert s["on_face"] > s["queries"] // 20
    assert s["max_dist"] < 40.0  # csrc/megakernel.cu's note: within 30 of every ball
    assert s["tested"] < 0.5 * 199 * s["queries"]  # the lanes' own tests, brute's 199


def test_ball_test_never_rejects_a_grazing_hit(monkeypatch):
    """Rays from far origins (up to 100 from the bodies) aimed at every
    corner of every polyhedron's planes and at the far side of every edge
    light, jittered around them: where a primitive of a group reports a
    hit, the ball test passes."""
    scene = _config_scene()
    rec = pack.pack_groups(scene)
    of = _group_of(scene, scene.groups)
    pl, sp = scene.planes, scene.spheres
    g = torch.Generator().manual_seed(7)
    targets = torch.cat([pl.base[:104], (pl.base + pl.u)[:104], (pl.base + pl.v)[:104],
                         sp.center[:90] + sp.radius[:90, None]
                         * torch.nn.functional.normalize(torch.randn(90, 3, generator=g), dim=1)])
    targets = targets.repeat(40, 1)
    targets = targets + 1e-3 * torch.randn(targets.shape, generator=g)
    dist = torch.tensor([3.5, 10.0, 30.0, 100.0]).repeat_interleave(targets.shape[0] // 4 + 1)
    away = torch.nn.functional.normalize(torch.randn(targets.shape, generator=g), dim=1)
    origin = targets + away * dist[:targets.shape[0], None]
    direction = (targets - origin) * torch.rand(targets.shape[0], 1, generator=g).add(0.5)
    valid = hit._all_ts(scene, origin, direction, T_MIN, T_MAX) < T.K_INFINITY
    passes = ball_test(origin, direction, rec)
    for k in range(len(scene.groups)):
        needed = valid[:, of == k].any(dim=1)
        assert needed.sum() > 100
        assert not (needed & ~passes[:, k]).any()


@pytest.mark.parametrize("contract", [False, True])
def test_ball_test_never_rejects_a_rounding_only_hit_from_far_away(contract):
    """Small spheres (radius 0.06, as config.txt's edge lights) that set
    their group's ball, on its surface, seen from 54 to 1000 away: rays
    aimed just past each sphere's outer side, where sphere_t's b^2 - a c
    reports hits that the exact geometry does not have. The ball test
    passes wherever one of them reports a hit; a ball that does not grow
    with the origin's distance would miss some."""
    g = torch.Generator().manual_seed(11)
    c0 = torch.tensor([4.0, 0.0, 6.0])
    n = 40
    out = torch.nn.functional.normalize(torch.randn(n // 2, 3, generator=g, dtype=torch.float64),
                                        dim=1)
    out = torch.cat([out, -out])  # in pairs, so that the ball is centred on c0
    r = 0.06
    buf = builders.SceneBuffers()
    m = buf.add_material(T.DIFFUSE_LIGHT, albedo=(1.0, 1.0, 1.0))
    for k in range(n):
        buf.add_sphere((c0.double() + out[k] * (3.0 - r)).numpy(), r, m)
    buf.groups.append((0, n, 0, 0))
    scene = builders.buffers_to_scene(buf, "cpu")
    rec = pack.pack_groups(scene)
    assert abs(float(rec[0, 0, 3]) - 3.0) < 0.01  # the spheres set the ball
    center, radius = scene.spheres.center, scene.spheres.radius
    rays = 20000
    k = torch.randint(0, n, (rays,), generator=g)
    dist = torch.tensor([54.0, 100.0, 300.0, 1000.0], dtype=torch.float64)[
        torch.randint(0, 4, (rays,), generator=g)]
    cs = center[k].double()
    # the ray's direction, across the sphere's outward normal
    w = torch.nn.functional.normalize(torch.randn(rays, 3, generator=g, dtype=torch.float64), dim=1)
    w = torch.nn.functional.normalize(w - (w * out[k]).sum(1, keepdim=True) * out[k], dim=1)
    # pass the sphere's outer side at r + delta, delta up to 30 e D^2 / r
    delta = torch.rand(rays, generator=g, dtype=torch.float64) * 30 * 2.0**-24 * dist**2 / r
    target = cs + out[k] * (r + delta[:, None])
    origin = (target - w * dist[:, None]).float()
    direction = (target - origin.double()).float()
    hits = sphere_hits(origin, direction, center, radius, contract)
    needed = hits.any(dim=1)
    # the exact distance of each float32 ray's line from each sphere's centre
    o64, d64 = origin.double(), direction.double()
    oc = o64[:, None, :] - center.double()[None]
    across = oc - d64[:, None, :] * ((oc * d64[:, None, :]).sum(2) / (d64 * d64).sum(1)[:, None])[
        ..., None]
    exact = (across.norm(dim=2) <= radius.double()[None]).any(dim=1)
    assert (needed & ~exact).sum() > 100  # rounding-only hits
    assert not (needed & ~ball_test(origin, direction, rec, contract)[:, 0]).any()
    fixed = rec.clone()
    fixed[:, 2, 0] = 0.0
    assert (needed & ~ball_test(origin, direction, fixed, contract)[:, 0]).any()


def test_prim_tests_per_query_reads_the_counted_tests():
    """rtbench's reader: the counted tests over the counted queries of every
    rank; nothing where no rank counted tests (K1 before the object cull)."""
    from rtbench.harness import spec

    reader = spec.metric_reader("prim_tests_per_query")
    work = dict(queries=1000, hits=700, visits=400, tests=35000, passes=50, active_lanes=1500,
                node_tests=0)
    ranks = [{"work": work}, {"work": dict(work, queries=3000, tests=45000)}, {"work": None}]
    assert reader.read({"ranks": ranks}) == 20.0
    assert reader.read({"ranks": [{"work": dict(work, tests=0)}]}) is None
    assert reader.read({}) is None and reader.read({"ranks": [{"work": None}]}) is None
