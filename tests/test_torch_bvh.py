"""The BVH path of tracer_torch against tracer's, on the CPU: the NumPy
median builder (bit-identical arrays), the native median builder (built
here with g++; held to the NumPy tree's invariants and nearest hits, since
std::nth_element and np.argpartition may order a level otherwise), the SAH
builders (native and NumPy arrays equal; the median tree's nearest hits;
the giant primitive near the root; the depth guard), the stack-capacity
check and a tree deeper than a balanced one, the plain traversal against
tracer.bvh.traverse.hit_scene_bvh, the NaN-face ray, BVH frames and their
gradients against tracer's XLA renderer, the BVH kernel's child-pair
records and its walk (tests/bvh_walk.py's emulation against the plain walk
and both traversals), and the CLI's `--bvh`.

Both packages traverse the same tree in the comparisons: the JAX scene's
BVH arrays are carried across with `scene_from_numpy`.

Tolerances: traversal hits and winners equal, t rtol 1e-5 (the emulated
kernel walk: t, winners, work and leaf order equal to the port's plain
walk; against tracer winners equal but on >= 95% of the rays aimed at
plane edges, t rtol 1e-4 atol 1e-6 for grazing and bounce rays), normals atol
1e-5 (tests/test_bvh.py:105); frames atol 1e-4 per pixel and sample on the
tie-free smoke scene (tests/test_bvh.py:123); gradients within a relative
1e-4 of each leaf's max|g|.
"""

import importlib.util
import io
import os
import re
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.bvh import builder as jax_bb
from tracer.bvh import traverse as jax_bt
from tracer.render import camera as jax_camera
from tracer.render import renderer as jax_renderer
from tracer.scene import builders as jax_builders
from tracer.scene import config as jax_config
from tracer.scene import types as jax_T
from tracer_torch import cli
from tracer_torch.bvh import builder as bb
from tracer_torch.bvh import native, traverse
from tracer_torch.geometry import aabb
from tracer_torch.io import image as image_io
from tracer_torch.kernels import diff, megakernel, pack
from tracer_torch.opt import fit as fit_mod
from tracer_torch.render import camera, hit, renderer
from tracer_torch.scene import builders, config
from tracer_torch.scene import types as T

sys.path.insert(0, os.path.dirname(__file__))
from test_grad import H, W, _cam, _scene  # noqa: E402
from test_torch_driver import TSV, _small_config  # noqa: E402
from test_torch_scene import jax_cam_fields, jax_scene_fields  # noqa: E402
from torch_scenes import one_torch_thread  # noqa: E402,F401
import bvh_walk  # noqa: E402
from torch_scenes import sphere_field_fields  # noqa: E402

CONFIGS = {"smoke": config.smoke_config_text, "default": config.default_config_text}


def _fields(jscene) -> dict:
    """jax_scene_fields plus the JAX scene's BVH arrays."""
    fields = jax_scene_fields(jscene)
    if jscene.bvh is not None:
        fields.update({f"bvh.{k}": np.asarray(v) for k, v in jscene.bvh._asdict().items()})
    return fields


def _jax_scene(cfg="smoke"):
    params = jax_config.read_scene_params(io.StringIO(CONFIGS[cfg]()))
    return jax_builders.create_scene(params, with_bvh=True, texture_loader=lambda _p: None)


def _rays(n=512, seed=0):
    g = np.random.default_rng(seed)
    return (g.normal(size=(n, 3), scale=10).astype(np.float32),
            g.normal(size=(n, 3)).astype(np.float32))


def _invariants(bmin, bmax, left, right, kind, n_s, n_p, max_depth=megakernel.BVH_STACK):
    """The structure the kernel's records rely on; no deeper than
    `max_depth` (a median tree: tracer's balanced bound)."""
    n = left.shape[0]
    assert n == 2 * (n_s + n_p) - 1
    leaves = left < 0
    assert sorted(right[leaves & (kind == 0)].tolist()) == list(range(n_s))
    assert sorted(right[leaves & (kind == 1)].tolist()) == list(range(n_p))
    internal = np.nonzero(~leaves)[0]
    np.testing.assert_array_equal(left[internal], internal + 1)  # left subtree first
    for node in internal:
        for ch in (left[node], right[node]):
            assert ch > node and (bmin[node] <= bmin[ch]).all() and (bmax[node] >= bmax[ch]).all()
    assert bb.tree_depth(left, right) <= max_depth


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_numpy_builder_bit_identical_to_tracer(cfg):
    buf = builders.build_buffers(config.read_scene_params(io.StringIO(CONFIGS[cfg]())))
    jbuf = jax_builders.build_buffers(jax_config.read_scene_params(io.StringIO(CONFIGS[cfg]())))
    stack = lambda xs: np.stack(xs) if xs else np.zeros((0, 3), np.float32)
    args = lambda b: (stack(b.sphere_center), np.asarray(b.sphere_radius, np.float32),
                      stack(b.plane_base), stack(b.plane_u), stack(b.plane_v),
                      np.asarray(b.plane_type, np.int32))
    boxes = bb.primitive_boxes(*args(buf))
    jboxes = jax_bb.primitive_boxes(*args(jbuf))
    for a, b in zip(boxes, jboxes):
        np.testing.assert_array_equal(a, b)
    got = bb.build_bvh_numpy(*boxes)
    want = jax_bb.build_bvh_numpy(*jboxes)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _invariants(*got[:5], len(buf.sphere_radius), len(buf.plane_type),
                jax_bt._stack_depth(len(got[2])))


@pytest.mark.skipif(shutil.which("g++") is None, reason="the native builder needs g++")
def test_native_builder_invariants_and_nearest_hits():
    assert native.available() and native.library_path().exists()
    jscene = _jax_scene("default")
    scene = T.scene_from_numpy(_fields(jscene), "cpu")
    sp, pl = scene.spheres, scene.planes
    boxes = bb.primitive_boxes(sp.center.numpy(), sp.radius.numpy(), pl.base.numpy(),
                               pl.u.numpy(), pl.v.numpy(), pl.ptype.numpy())
    tree = native.build_bvh(*boxes)
    _invariants(*tree[:5], scene.num_spheres, scene.num_planes, jax_bt._stack_depth(len(tree[2])))
    np.testing.assert_array_equal(tree[0][0], bb.build_bvh_numpy(*boxes)[0][0])  # root box
    native_scene = scene._replace(bvh=T.BVHArrays(*(torch.tensor(a) for a in tree)))
    o, d = (torch.tensor(x) for x in _rays(2048, seed=3))
    a = traverse.hit_scene_bvh(scene, o, d)
    b = traverse.hit_scene_bvh(native_scene, o, d)
    assert int(a.hit.sum()) > 200
    assert torch.equal(a.hit, b.hit) and torch.equal(a.winner[a.hit], b.winner[b.hit])
    torch.testing.assert_close(a.t[a.hit], b.t[b.hit], rtol=0, atol=0)
    # create_scene(with_bvh=True) takes the native SAH builder here
    params = config.read_scene_params(io.StringIO(config.default_config_text()))
    built = builders.create_scene(params, with_bvh=True, texture_loader=lambda _p: None,
                                  device="cpu")
    for x, y in zip(built.bvh, native.build_bvh_sah(*boxes)):
        assert torch.equal(x, torch.tensor(y))


def test_check_stack_capacity_fails_loudly():
    p = 64
    n = 2 * p - 1
    left = np.full(n, -1, np.int32)
    right = np.zeros(n, np.int32)
    for k in range(p - 1):  # a right spine: internal 2k, leaf 2k+1, next internal 2k+2
        left[2 * k], right[2 * k] = 2 * k + 1, 2 * k + 2
    right[n - 1] = p - 1
    assert bb.tree_depth(left, right) == p
    with pytest.raises(ValueError, match="exceeds the traversal stack capacity"):
        bb.check_stack_capacity(left, right)
    # the kernel's packing refuses it too, and a tree whose left child is not next
    spine = T.BVHArrays(torch.zeros((n, 3)), torch.ones((n, 3)), torch.tensor(left),
                        torch.tensor(right), torch.where(torch.tensor(left) < 0, 0, -1).int(),
                        torch.zeros(n, dtype=torch.int32))
    scene = _port_smoke()._replace(bvh=spine)
    with pytest.raises(ValueError, match="exceeds"):
        pack.pack_bvh(scene, megakernel.BVH_STACK)
    # a tree whose left child is not the next node packs all the same: the
    # root's record (record 1) names both its children
    swapped = _port_smoke()
    left2 = swapped.bvh.left.clone()
    root_l, root_r = int(left2[0]), int(swapped.bvh.right[0])
    left2[0] = root_r
    other = swapped._replace(bvh=swapped.bvh._replace(
        left=left2, right=swapped.bvh.right.clone().index_fill_(0, torch.tensor([0]), root_l)))
    rec = pack.pack_bvh(other, megakernel.BVH_STACK)
    assert torch.equal(rec[1, 0, :3], other.bvh.box_min[root_r])
    assert torch.equal(rec[1, 2, :3], other.bvh.box_min[root_l])


def _port_smoke():
    return T.scene_from_numpy(_fields(_jax_scene("smoke")), "cpu")


def _with_tree(scene, tree):
    return scene._replace(bvh=T.BVHArrays(*(torch.tensor(a) for a in tree)))


def _boxes(scene):
    sp, pl = scene.spheres, scene.planes
    return bb.primitive_boxes(sp.center.numpy(), sp.radius.numpy(), pl.base.numpy(),
                              pl.u.numpy(), pl.v.numpy(), pl.ptype.numpy())


def _sphere_scene(centers, radii):
    """Spheres alone, one Lambertian material, no BVH yet."""
    n = len(radii)
    return T.Scene(spheres=T.make_spheres(centers, radii, np.zeros(n, np.int32), "cpu"),
                   planes=T.make_planes(np.zeros(0, np.int32), *np.zeros((3, 0, 3)),
                                        np.zeros(0, np.int32), "cpu"),
                   materials=T.make_materials([T.LAMBERTIAN], [0.0], [1.0], [[0, 0, 0]],
                                              [[0.5, 0.5, 0.5]], [[0, 0, 0]], [-1], "cpu"),
                   textures=None)


def _sah_scene(name):
    """The port's scene without its tree: the configurations, the 1000-sphere
    field, 40 small spheres on a radius-1000 ground sphere (the RTIOW scene's
    shape; the ground is sphere 0), or 200 spheres with one centre and one
    radius (every split costs the same)."""
    g = np.random.default_rng(5)
    if name in CONFIGS:
        return T.scene_from_numpy(jax_scene_fields(_jax_scene(name)), "cpu")
    if name == "field1000":
        return T.scene_from_numpy(sphere_field_fields(1000)[0], "cpu")
    if name == "ground":
        small = np.concatenate([g.uniform(-10, 10, (40, 2)), g.uniform(0.2, 1.0, (40, 1))], 1)
        return _sphere_scene(np.concatenate([[[0, 0, -1000]], small]).astype(np.float32),
                             np.concatenate([[1000.0], small[:, 2]]).astype(np.float32))
    return _sphere_scene(np.full((200, 3), 1.5, np.float32), np.ones(200, np.float32))


@pytest.mark.skipif(shutil.which("g++") is None, reason="the native builder needs g++")
@pytest.mark.parametrize("name", ["smoke", "default", "field1000", "ground", "same_centre"])
def test_sah_builders_give_equal_arrays_and_keep_the_invariants(name):
    scene = _sah_scene(name)
    boxes = _boxes(scene)
    tree = native.build_bvh_sah(*boxes)
    for a, b in zip(tree, bb.build_bvh_sah_numpy(*boxes)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _invariants(*tree[:5], scene.num_spheres, scene.num_planes)
    depth = bb.tree_depth(tree[2], tree[3])
    if name == "same_centre":  # a chain of one-primitive splits, then the guard's medians
        assert depth == megakernel.BVH_STACK > jax_bt._stack_depth(len(tree[2]))
    # create_scene's and buffers_to_scene's tree (the scene kinds')
    assert all(torch.equal(x, torch.tensor(y))
               for x, y in zip(bb.build_scene_bvh_from_scene(scene), tree))
    pack.pack_bvh(_with_tree(scene, tree), megakernel.BVH_STACK)  # fits the kernel's stack


@pytest.mark.parametrize("name", ["smoke", "default", "field1000"])
def test_sah_tree_takes_the_median_trees_nearest_hits(name):
    """The plain traversal on the SAH tree (deeper than the median tree) and
    on the median tree, over `_rays` and `_walk_rays` (which aims rays at
    plane edges): hits, winners and t equal, except on rays whose nearest t
    two primitives share exactly, where the later visited wins; such ties
    come only from the edges, so scenes of several planes have some."""
    scene = _sah_scene(name)
    boxes = _boxes(scene)
    sah = _with_tree(scene, bb.build_bvh_sah_numpy(*boxes))
    median = _with_tree(scene, bb.build_bvh_numpy(*boxes))
    assert bb.tree_depth(sah.bvh.left, sah.bvh.right) > bb.tree_depth(median.bvh.left,
                                                                      median.bvh.right)
    rays = [_rays(2048, seed=3), _walk_rays(sah, np.random.default_rng(11))[:2]]
    o, d = (torch.tensor(np.concatenate(x)) for x in zip(*rays))
    a, b = (traverse.hit_scene_bvh(s, o, d) for s in (sah, median))
    assert int(a.hit.sum()) > 1000
    t_all = hit._all_ts(scene, o, d, 1e-3, T.K_INFINITY)
    tied = a.hit & ((t_all == t_all.min(dim=1, keepdim=True).values).sum(dim=1) > 1)
    assert torch.equal(a.hit, b.hit)
    same = ~a.hit | ((a.winner == b.winner) & (a.t == b.t))
    assert bool(same[~tied].all()), int((~same & ~tied).sum())
    assert (int(tied.sum()) > 0) == (scene.num_planes > 1) and int(tied.sum()) <= 0.01 * len(o)


def test_sah_tree_hangs_the_giant_sphere_next_to_the_root():
    scene = _sah_scene("ground")
    tree = bb.build_bvh_sah_numpy(*_boxes(scene))
    left, right, kind = tree[2], tree[3], tree[4]
    depth = np.zeros(len(left), np.int64)
    depth[0] = 1
    for i in np.nonzero(left >= 0)[0]:  # preorder: parents first
        depth[left[i]] = depth[right[i]] = depth[i] + 1
    ground = np.nonzero((left < 0) & (kind == 0) & (right == 0))[0]
    assert len(ground) == 1 and depth[ground[0]] <= 3
    median = bb.build_bvh_numpy(*_boxes(scene))
    assert bb._half_areas(tree[0], tree[1])[left >= 0].sum() < \
        bb._half_areas(median[0], median[1])[median[2] >= 0].sum()


def test_a_tree_deeper_than_a_balanced_one_traverses_in_full():
    """A right spine over 24 spheres (depth 24, where tracer's balanced bound
    for its 47 nodes is 8): the plain traversal's stack is the tree's depth,
    so its nearest hits are brute force's."""
    g = np.random.default_rng(9)
    n = 24
    scene = _sphere_scene(g.uniform(-6, 6, (n, 3)).astype(np.float32),
                          g.uniform(0.5, 1.5, n).astype(np.float32))
    lo, hi = _boxes(scene)[:2]
    nodes = 2 * n - 1
    left, right = np.full(nodes, -1, np.int32), np.zeros(nodes, np.int32)
    kind, bmin, bmax = np.zeros(nodes, np.int32), np.zeros((nodes, 3), np.float32), np.zeros(
        (nodes, 3), np.float32)
    for k in range(n - 1):  # internal 2k over spheres k.., leaf 2k + 1 sphere k
        left[2 * k], right[2 * k], kind[2 * k] = 2 * k + 1, 2 * k + 2, -1
        bmin[2 * k], bmax[2 * k] = lo[k:].min(0), hi[k:].max(0)
        right[2 * k + 1], bmin[2 * k + 1], bmax[2 * k + 1] = k, lo[k], hi[k]
    right[-1], bmin[-1], bmax[-1] = n - 1, lo[-1], hi[-1]
    spine = _with_tree(scene, (bmin, bmax, left, right, kind, np.zeros(nodes, np.int32)))
    assert traverse.stack_depth(spine.bvh) == n > jax_bt._stack_depth(nodes)
    o = _rays(2048, seed=4)[0]
    aim = scene.spheres.center.numpy()[g.integers(0, n, 2048)] + g.normal(size=(2048, 3))
    o, d = torch.tensor(o), torch.tensor((aim - o).astype(np.float32))
    got, want = traverse.hit_scene_bvh(spine, o, d), hit.hit_scene_brute(scene, o, d)
    assert int(got.hit.sum()) > 1000
    assert torch.equal(got.hit, want.hit)
    assert torch.equal(got.winner[got.hit], want.winner[want.hit])


def test_traversal_matches_tracer_on_random_rays():
    jscene = _jax_scene("smoke")
    scene = T.scene_from_numpy(_fields(jscene), "cpu")
    o, d = _rays()
    want = jax_bt.hit_scene_bvh(jscene, jnp.asarray(o), jnp.asarray(d))
    got = traverse.hit_scene_bvh(scene, torch.tensor(o), torch.tensor(d))
    h = np.array(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), h)
    assert 50 < h.sum() < 512
    np.testing.assert_allclose(got.t.numpy()[h], np.asarray(want.t)[h], rtol=1e-5)
    np.testing.assert_allclose(got.normal.numpy()[h], np.asarray(want.normal)[h], atol=1e-5)
    midx = np.asarray(want.material_idx)[h]
    mats = jscene.materials
    np.testing.assert_array_equal(got.mtype.numpy()[h], np.asarray(mats.mtype)[midx])
    np.testing.assert_array_equal(got.albedo.numpy()[h], np.asarray(mats.albedo)[midx])
    brute = hit.hit_scene_brute(scene, torch.tensor(o), torch.tensor(d))
    assert torch.equal(brute.hit, got.hit) and torch.equal(brute.winner[h], got.winner[h])
    work = []
    traverse.traverse(scene, torch.tensor(o), torch.tensor(d), work=work)
    node_tests, leaves, tests = (int(x) for x in work[0])
    n = scene.bvh.left.shape[0]
    assert leaves == tests and 512 <= node_tests < 512 * n


def _nan_face():
    """One quad over x, y in [-1, 1] at z = 0 and a camera whose every ray
    starts on the box's x = -1 face with direction x exactly 0: each slab
    test divides 0 by 0 on x (0 x inf = NaN) and culls the box, though the
    brute test hits the quad's edge."""
    fields = {"spheres.center": np.zeros((0, 3), np.float32),
              "spheres.radius": np.zeros(0, np.float32),
              "spheres.material_idx": np.zeros(0, np.int32)}
    planes = T.make_planes([T.QUAD], [[-1, -1, 0]], [[2, 0, 0]], [[0, 2, 0]], [0], "cpu")
    fields.update({f"planes.{k}": v.numpy() for k, v in planes._asdict().items()})
    mats = T.make_materials([T.LAMBERTIAN], [0.0], [1.0], [[0, 0, 0]], [[0.8, 0.6, 0.4]],
                            [[0, 0, 0]], [-1], "cpu")
    fields.update({f"materials.{k}": v.numpy() for k, v in mats._asdict().items()})
    boxes = jax_bb.primitive_boxes(fields["spheres.center"], fields["spheres.radius"],
                                   fields["planes.base"], fields["planes.u"],
                                   fields["planes.v"], fields["planes.ptype"])
    tree = jax_bb.build_bvh_numpy(*boxes)
    fields.update({f"bvh.{k}": v for k, v in zip(T.BVHArrays._fields, tree)})
    cam = {"origin": np.array([-1, 0, 5], np.float32),
           "pixel00_loc": np.array([-1, -0.5, 4], np.float32),
           "pixel_delta_u": np.array([0, 1 / 16, 0], np.float32),
           "pixel_delta_v": np.array([0, 0, -1 / 64], np.float32),
           "background": np.array([0.05, 0.07, 0.1], np.float32)}
    return fields, cam


def _jax_scene_from_fields(fields):
    """tracer's untextured Scene, BVH included, from host fields."""
    group = lambda name, cls: cls(*(jnp.asarray(fields[f"{name}.{k}"]) for k in cls._fields))
    return jax_T.Scene(spheres=group("spheres", jax_T.Spheres),
                       planes=group("planes", jax_T.Planes),
                       materials=group("materials", jax_T.Materials), textures=None,
                       bvh=group("bvh", jax_T.BVHArrays))


def test_nan_face_ray_is_culled_as_tracer_culls_it():
    fields, camf = _nan_face()
    assert fields["bvh.box_min"][0, 0] == -1.0
    scene = T.scene_from_numpy(fields, "cpu")
    cam = camera.camera_from_numpy(camf, "cpu")
    o = torch.tensor([[-1.0, 0.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    assert bool(hit.hit_scene_brute(scene, o, d).hit[0])  # brute hits the edge, alpha = 0
    assert not bool(traverse.hit_scene_bvh(scene, o, d).hit[0])
    box = scene.bvh.box_min[0], scene.bvh.box_max[0]
    assert not bool(aabb.slab_hit(o, d, *box, 1e-3, torch.tensor([1e30])))
    jscene = _jax_scene_from_fields(fields)
    assert not bool(jax_bt.hit_scene_bvh(jscene, jnp.asarray(o.numpy()),
                                         jnp.asarray(d.numpy())).hit[0])
    # whole frames: every ray of this camera starts on the face with d.x = 0
    jcam = jax_camera.CameraData(**{k: jnp.asarray(v) for k, v in camf.items()})
    want = np.asarray(jax_renderer.render_frame(jscene, jcam, 16, 8, spp=1, max_depth=2,
                                                intersector="bvh", chunk=128))
    got = renderer.render_frame(scene, cam, 16, 8, 1, 2, intersector="bvh")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(camf["background"], got.shape))
    brute = renderer.render_frame(scene, cam, 16, 8, 1, 2)
    assert not torch.allclose(brute, got)


@pytest.mark.parametrize("stratify", [False, True])
def test_render_frame_bvh_matches_tracer(stratify):
    jscene = _jax_scene("smoke")
    scene = T.scene_from_numpy(_fields(jscene), "cpu")
    jcam = jax_camera.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 24, 16, 90.0,
                                        background=(0.05, 0.07, 0.1))
    cam = camera.camera_from_numpy(jax_cam_fields(jcam), "cpu")
    want = np.asarray(jax_renderer.render_frame(jscene, jcam, 24, 16, spp=1, max_depth=4,
                                                intersector="bvh", stratify=stratify,
                                                chunk=384))
    got = renderer.render_frame(scene, cam, 24, 16, 1, 4, intersector="bvh", stratify=stratify)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    brute = renderer.render_frame(scene, cam, 24, 16, 1, 4, stratify=stratify)
    np.testing.assert_allclose(got.numpy(), brute.numpy(), atol=1e-4)
    # the kernel wrapper takes the plain traversal for CPU tensors
    before = megakernel.LAUNCHES_BVH
    torch.testing.assert_close(megakernel.render_frame_kernel(
        scene, cam, 24, 16, 1, 4, intersector="bvh", stratify=stratify), got)
    assert megakernel.LAUNCHES_BVH == before


def _tie_free_with_bvh():
    jscene = _scene()
    sp, pl = jscene.spheres, jscene.planes
    bvh = jax_bb.build_bvh_arrays(np.asarray(sp.center), np.asarray(sp.radius),
                                  np.asarray(pl.base), np.asarray(pl.u), np.asarray(pl.v),
                                  np.asarray(pl.ptype))
    return jscene._replace(bvh=bvh)


def test_bvh_gradients_match_jax():
    """jax.grad of tracer's BVH render against torch autograd of the port's,
    on the sphere centres and radii (tests/test_grad.py's scene)."""
    jscene = _tie_free_with_bvh()
    g_fb = np.random.default_rng(4).normal(size=(H, W, 3)).astype(np.float32)

    def jloss(center, radius):
        s = jscene._replace(spheres=jscene.spheres._replace(center=center, radius=radius))
        fb = jax_renderer.render_frame(s, _cam(), W, H, spp=2, max_depth=3, intersector="bvh",
                                       chunk=W * H)
        return jnp.sum(fb * g_fb)

    want = jax.grad(jloss, argnums=(0, 1))(jscene.spheres.center, jscene.spheres.radius)
    scene = T.scene_from_numpy(_fields(jscene), "cpu")
    cam = camera.camera_from_numpy(jax_cam_fields(_cam()), "cpu")
    center = scene.spheres.center.clone().requires_grad_()
    radius = scene.spheres.radius.clone().requires_grad_()
    s = scene._replace(spheres=scene.spheres._replace(center=center, radius=radius))
    fb = renderer.render_frame(s, cam, W, H, 2, 3, intersector="bvh")
    got = torch.autograd.grad(torch.sum(fb * torch.tensor(g_fb)), (center, radius))
    for a, b in zip(got, want):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        assert scale > 0
        assert float(np.abs(a.numpy() - b).max()) <= 1e-4 * scale


def test_diff_and_fit_take_bvh_through_the_plain_renderer():
    scene = T.scene_from_numpy(_fields(_tie_free_with_bvh()), "cpu")
    cam = camera.camera_from_numpy(jax_cam_fields(_cam()), "cpu")
    with pytest.raises(ValueError, match="needs mode 'remat'"):
        diff.render_frame_diff(scene, cam, W, H, 1, 2, intersector="bvh")
    target = renderer.render_frame(scene, cam, W, H, 1, 2) * 0.9
    fitted, losses = fit_mod.fit(scene, cam, target, W, H, spp=1, max_depth=2,
                                 param_paths=("materials.albedo",), steps=2, engine="torch",
                                 intersector="bvh", log_every=0)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert not torch.equal(fitted.materials.albedo, scene.materials.albedo)
    with pytest.raises(ValueError, match="needs a scene on a CUDA device|engine 'torch'"):
        fit_mod.fit(scene, cam, target, W, H, spp=1, max_depth=2, steps=1, engine="cuda",
                    intersector="bvh")


def test_bvh_needs_the_scene_bvh():
    scene = T.scene_from_numpy(jax_scene_fields(_scene()), "cpu")
    cam = camera.camera_from_numpy(jax_cam_fields(_cam()), "cpu")
    with pytest.raises(ValueError, match="needs scene.bvh"):
        renderer.render_frame(scene, cam, 4, 4, 1, 1, intersector="bvh")
    with pytest.raises(ValueError, match="unknown intersector"):
        renderer.render_frame(scene, cam, 4, 4, 1, 1, intersector="octree")


def test_pack_bvh_records():
    scene = _port_smoke()
    rec = pack.pack_bvh(scene, megakernel.BVH_STACK)
    bvh = scene.bvh
    internal = torch.nonzero(bvh.left >= 0).flatten()
    assert rec.shape == (len(internal) + 1, 4, 4) and rec.dtype == torch.float32
    assert 4 * rec.numel() <= megakernel.NODE_SHARED_BYTES_MAX  # staged in shared memory
    bits = rec.view(torch.int32)
    leaf = bvh.left < 0
    record = torch.zeros_like(bvh.left)
    record[internal] = torch.arange(1, len(internal) + 1, dtype=record.dtype)
    prim = torch.where(bvh.kind == 0, bvh.right, scene.num_spheres + bvh.right)
    axis_f = torch.where(leaf, -1, bvh.axis)
    id_f = torch.where(leaf, prim, record)

    def holds(r, q, nodes):  # float4s q, q + 1 of records r hold these nodes as children
        torch.testing.assert_close(rec[r, q, :3], bvh.box_min[nodes], rtol=0, atol=0)
        torch.testing.assert_close(rec[r, q + 1, :3], bvh.box_max[nodes], rtol=0, atol=0)
        assert torch.equal(bits[r, q, 3], axis_f[nodes])
        assert torch.equal(bits[r, q + 1, 3], id_f[nodes])

    holds(0, 0, 0)  # record 0: the root
    assert not rec[0, 2:].any()
    rows = torch.arange(1, len(internal) + 1)
    holds(rows, 0, bvh.left[internal].long())
    holds(rows, 2, bvh.right[internal].long())
    assert pack.pack_bvh(scene, megakernel.BVH_STACK) is rec  # cached per tree
    # a one-primitive scene: the root is a leaf, record 0 is the only record
    one = T.scene_from_numpy(_nan_face()[0], "cpu")
    rec1 = pack.pack_bvh(one, megakernel.BVH_STACK)
    assert rec1.shape == (1, 4, 4)
    assert rec1.view(torch.int32)[0, 0, 3] == -1 and rec1.view(torch.int32)[0, 1, 3] == 0


def _walk_rays(scene, g):
    """Rays for the walk: random ones through the scene's box; rays at
    points on random primitives; rays that start on a node's box face with
    a zero direction component (in the face's plane or across it); rays
    aimed at plane edges, which adjacent faces share (ties; flagged in the
    third array returned); and bounces from the hit points of the others."""
    bvh = scene.bvh
    lo, hi = bvh.box_min[0].numpy(), bvh.box_max[0].numpy()
    pts = lambda n: g.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    o1 = pts(256)
    d1 = g.normal(size=(256, 3)).astype(np.float32)
    sp, pl = scene.spheres, scene.planes
    targets = []
    if scene.num_spheres:
        k = g.integers(0, scene.num_spheres, size=128)
        u = g.normal(size=(128, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        targets.append(sp.center.numpy()[k] + 0.9 * sp.radius.numpy()[k, None] * u)
    if scene.num_planes:
        k = g.integers(0, scene.num_planes, size=128)
        a, b = g.uniform(size=(2, 128, 1)) * 0.5
        targets.append(pl.base.numpy()[k] + a * pl.u.numpy()[k] + b * pl.v.numpy()[k])
    targets = np.concatenate(targets)
    o2 = pts(len(targets))
    d2 = (targets - o2).astype(np.float32)
    boxes = np.concatenate([bvh.box_min.numpy(), bvh.box_max.numpy()], axis=1)
    face = g.integers(0, 6, size=128)
    node = g.integers(0, len(boxes), size=128)
    o3 = g.uniform(bvh.box_min.numpy()[node], bvh.box_max.numpy()[node]).astype(np.float32)
    o3[np.arange(128), face % 3] = boxes[node, face]
    axis = np.where(np.arange(128) % 2 == 0, (face + 1) % 3, face % 3)
    d3 = g.normal(size=(128, 3)).astype(np.float32)
    d3[np.arange(128), axis] = 0.0
    parts = [(o1, d1), (o2, d2), (o3, d3)]
    if scene.num_planes:
        k = g.integers(0, scene.num_planes, size=192)
        s = g.uniform(size=(192, 1)).astype(np.float32)
        tri = pl.ptype.numpy()[k, None] == T.TRIANGLE
        base, u, v = pl.base.numpy()[k], pl.u.numpy()[k], pl.v.numpy()[k]
        # the quad's alpha = 1 edge, the triangle's alpha + beta = 1 edge
        edge = np.where(tri, base + s * u + (1 - s) * v, base + u + s * v)
        o4 = pts(192)
        parts.append((o4, (edge - o4).astype(np.float32)))
    o = np.concatenate([p[0] for p in parts])
    d = np.concatenate([p[1] for p in parts])
    edge = np.zeros(len(o), bool)
    edge[len(o) - (192 if scene.num_planes else 0):] = True
    first = hit.hit_scene_brute(scene, torch.tensor(o), torch.tensor(d))
    o5 = first.point[first.hit].numpy()[:256]
    d5 = g.normal(size=(len(o5), 3)).astype(np.float32)
    return (np.concatenate([o, o5]).astype(np.float32),
            np.concatenate([d, d5]).astype(np.float32),
            np.concatenate([edge, np.zeros(len(o5), bool)]))


def _walk_scene(name):
    """(tracer's scene, the port's twin on the same tree) for the walk tests;
    the field's tree is the port's NumPy median builder's (bit-identical to
    tracer's) or, for "field1000-sah", its SAH builder's (as deep as
    tracer's stack for it, 13)."""
    if not name.startswith("field1000"):
        jscene = _jax_scene(name)
        return jscene, T.scene_from_numpy(_fields(jscene), "cpu")
    fields, _ = sphere_field_fields(1000)
    boxes = bb.primitive_boxes(fields["spheres.center"], fields["spheres.radius"],
                               fields["planes.base"], fields["planes.u"], fields["planes.v"],
                               fields["planes.ptype"])
    build = bb.build_bvh_sah_numpy if name.endswith("-sah") else bb.build_bvh_numpy
    fields.update({f"bvh.{k}": v for k, v in zip(T.BVHArrays._fields, build(*boxes))})
    return _jax_scene_from_fields(fields), T.scene_from_numpy(fields, "cpu")


@pytest.mark.parametrize("name", ["smoke", "default", "field1000", "field1000-sah"])
def test_kernel_walk_takes_the_plain_walks_decisions(name):
    """tests/bvh_walk.py's emulation of K1-bvh's child-pair walk over
    pack_bvh's records: the winner and t of tracer's traverse and of the
    port's plain traverse, its node tests and leaves the plain traversal's
    `work`, and ray by ray the leaves of the plain stack walk in the same
    order."""
    jscene, scene = _walk_scene(name)
    o, d, edge = _walk_rays(scene, np.random.default_rng(11))
    ot, dt = torch.tensor(o), torch.tensor(d)
    # every root over (T_MIN, K_INFINITY), the bounds of the plain traversal's leaf tests
    t_all = hit._all_ts(scene, ot, dt, 1e-3, T.K_INFINITY).numpy()
    rec = pack.pack_bvh(scene, megakernel.BVH_STACK)
    t, winner, node_tests, leaves, order = bvh_walk.walk(rec.numpy(), o, d, t_all)
    b = scene.bvh
    plain = bvh_walk.plain_walk(b.box_min.numpy(), b.box_max.numpy(), b.left.numpy(),
                                b.right.numpy(), b.kind.numpy(), b.axis.numpy(),
                                scene.num_spheres, o, d, t_all)
    np.testing.assert_array_equal(t, plain[0])
    np.testing.assert_array_equal(winner, plain[1])
    np.testing.assert_array_equal(node_tests, plain[2])
    np.testing.assert_array_equal(leaves, plain[3])
    assert order == plain[4]
    # the port's plain traversal
    work = []
    found, is_sphere, idx, t_port = traverse.traverse(scene, ot, dt, work=work)
    hits = found.numpy()
    assert 0.3 < hits.mean() < 1.0
    np.testing.assert_array_equal(winner >= 0, hits)
    want = torch.where(is_sphere, idx, scene.num_spheres + idx).numpy()
    np.testing.assert_array_equal(winner[hits], want[hits])
    np.testing.assert_array_equal(t, t_port.numpy())
    assert (node_tests.sum(), leaves.sum(), leaves.sum()) == tuple(int(x) for x in work[0])
    # tracer's traverse, winner for winner, except on the rays aimed at plane
    # edges: there the edge test is a razor-edge decision that the two
    # frameworks round otherwise (tracer's own traverse and brute force
    # disagree on some of them), so those are held to a share
    jhit, jsph, jidx, jt = (np.asarray(x) for x in jax_bt.traverse(
        jscene, jnp.asarray(o), jnp.asarray(d), 1e-3, 1e30))
    j_winner = np.where(jhit, np.where(jsph, jidx, scene.num_spheres + jidx), -1)
    np.testing.assert_array_equal(j_winner[~edge], winner[~edge])
    # t: rays aimed at sphere points graze some spheres, whose roots XLA and
    # torch round a few ulps apart (2.8e-5 relative seen); the bounces' t is short
    np.testing.assert_allclose(jt[~edge & hits], t[~edge & hits], rtol=1e-4, atol=1e-6)
    assert (j_winner[edge] == winner[edge]).mean() >= 0.95
    # ties: rays where another tested primitive has the winner's t exactly
    tied = [i for i in np.nonzero(hits)[0]
            if sum(t_all[i, p] == t[i] for p in order[i]) > 1]
    assert (len(tied) > 0) == (scene.num_planes > 1), len(tied)


def test_bvh_stack_matches_kernel_source():
    src = (Path(megakernel.__file__).parent.parent / "csrc" / "megakernel.cu").read_text()
    assert int(re.search(r"constexpr int BVH_STACK = (\d+);", src).group(1)) == megakernel.BVH_STACK


def test_count_names_match_kernel_source():
    src = (Path(megakernel.__file__).parent.parent / "csrc" / "megakernel.cu").read_text()
    counts = int(re.search(r"constexpr int COUNTS = (\d+);", src).group(1))
    # the NEXTWEEK instantiations count book 2's three more
    more = int(re.search(r"COUNTS_OF = NEXTWEEK \? COUNTS \+ (\d+) : COUNTS;", src).group(1))
    assert counts + more == len(megakernel.COUNT_NAMES) == len(megakernel.LoopWork._fields)
    assert megakernel.LoopWork._fields == megakernel.COUNT_NAMES


def test_bvh_ab_count_names_are_the_kernels():
    """bvh_ab.py's copy (its main process imports no tree's tracer_torch)."""
    path = Path(__file__).resolve().parents[1] / "bvh_ab.py"
    spec = importlib.util.spec_from_file_location("bvh_ab", path)
    bvh_ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bvh_ab)
    assert bvh_ab.COUNT_NAMES == megakernel.COUNT_NAMES
    assert set(bvh_ab.SAME) | set(bvh_ab.SAME_TREE) <= set(megakernel.COUNT_NAMES)


def test_cli_bvh_stratify_renders(tmp_path, capsys):
    cfg = _small_config(tmp_path)
    assert cli.main(["--cpu", "--config", str(cfg), "--bvh", "--stratify"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and TSV.match(lines[0]).group(1) == "0"
    img = image_io.read_binary(str(tmp_path / "out_0.bin"))
    cli.main(["--cpu", "--config", str(cfg), "--stratify"])  # the same frame, brute force
    capsys.readouterr()
    assert img.any()
    np.testing.assert_array_equal(img, image_io.read_binary(str(tmp_path / "out_0.bin")))


def test_cli_gpu_bvh_without_cuda_exits_1(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _small_config(tmp_path)
    assert cli.main(["--gpu", "--bvh", "--config", str(cfg)]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.glob("out_*"))
