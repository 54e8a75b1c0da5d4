"""The port's cluster-culled path against tracer: the clustering
(kernels/cluster.py against tracer.pallas.cluster) and its tree, the
kernel's walk of that tree (tests/cluster_walk.py's emulation against the
plain clustered nearest hit), the plain clustered
nearest hit (render/hit.py:hit_scene_clustered against the brute one) and
the plain clustered frame (render_frame(cluster_k=16) against
render_frame_pallas(cluster_k=16, interpret=True), both `culled` settings),
on the same NumPy inputs.

The frames are compared on tests/test_scale.py's 300-sphere scene. On
sphere_field(2000) the port's brute frame and tracer's brute XLA frame
already differ on about 2% of pixels at 64x32: last-bit differences that
the field's paths amplify (there a JAX trace of one such ray and JAX's
batched frame disagree with each other too). The clustering and the
nearest hit are held on both scenes.

Tolerances: clusters and boxes exactly (the port copies tracer's NumPy
split and box code); nearest hits exactly (the same t matrix, masked); frames
against tracer by tests/test_torch_render.py's rule (>= 99% of pixels
within 1e-3, frame means to a relative 1e-3: tracer's kernel computes t in
its projection form), and against the port's own brute render exactly.
"""

import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.pallas import cluster as jax_cluster
from tracer.pallas import megakernel as jax_megakernel
from tracer.render import camera as jax_camera
from tracer.render import renderer as jax_renderer
from tracer.scene import builders as jax_builders
from tracer.scene import config as jax_config
from tracer.scene import types as jax_T
from tracer_torch import core
from tracer_torch.kernels import cluster, megakernel
from tracer_torch.render import camera, hit, renderer
from tracer_torch.scene import builders, config
from tracer_torch.scene import types as T

sys.path.insert(0, os.path.dirname(__file__))
from test_scale import _big_scene  # noqa: E402
from test_torch_render import _both, assert_frames_agree  # noqa: E402
from test_torch_scene import jax_scene_fields  # noqa: E402
from torch_scenes import one_torch_thread  # noqa: E402,F401
import cluster_walk  # noqa: E402
from torch_scenes import SKY, big_scene, sphere_field, sphere_field_fields  # noqa: E402
from torch_scenes import tie_free_scene  # noqa: E402

K = 16
W, H, SPP, DEPTH = 16, 8, 2, 3


def _jax_scene(fields):
    def group(cls, prefix):
        return cls(*(jnp.asarray(fields[f"{prefix}.{name}"]) for name in cls._fields))

    return jax_T.Scene(group(jax_T.Spheres, "spheres"), group(jax_T.Planes, "planes"),
                       group(jax_T.Materials, "materials"), None, None)


def _big300():
    """The 300-sphere scene and a camera that sees it whole."""
    jcam = jax_camera.build_camera_data([0, -30, 6], [0, 0, 2], W, H, 50.0, background=SKY)
    return _big_scene(300)._replace(bvh=None), jcam


SCENES = {"big300": lambda: _big300()[0],
          "field2000": lambda: _jax_scene(sphere_field_fields(2000)[0])}
TREE_SCENES = {
    "smoke": lambda: jax_builders.create_scene(
        jax_config.read_scene_params(io.StringIO(jax_config.smoke_config_text())),
        texture_loader=lambda _path: None),
    "big300": lambda: _big300()[0],
    "field250": lambda: _jax_scene(sphere_field_fields(250)[0]),
}


@pytest.fixture(scope="module", params=[False, True], ids=["legacy", "culled"])
def pallas_big300(request):
    jscene, jcam = _big300()
    fb = jax_megakernel.render_frame_pallas(jscene, jcam, W, H, spp=SPP, max_depth=DEPTH,
                                            interpret=True, cluster_k=K, culled=request.param)
    return jscene, jcam, np.asarray(fb)


@pytest.fixture(scope="module")
def pallas_padding():
    """tests/test_pallas.py's padding case: 30 spheres and the floor, so
    k = 16 gives a cluster count that is not a multiple of 8."""
    jscene = _big_scene(30)._replace(bvh=None)
    jcam = jax_camera.build_camera_data([0, -40, 10], [0, 0, 2], 32, 8, 50.0,
                                        background=(0.2, 0.3, 0.5))
    fb = jax_megakernel.render_frame_pallas(jscene, jcam, 32, 8, spp=2, max_depth=3,
                                            interpret=True, cluster_k=K, culled=True,
                                            persistent=False, cull_group=3)
    return jscene, jcam, np.asarray(fb)


@pytest.mark.parametrize("name", sorted({**SCENES, **TREE_SCENES}))
def test_clusters_match_tracer(name):
    jscene = {**SCENES, **TREE_SCENES}[name]()
    scene = T.scene_from_numpy(jax_scene_fields(jscene), "cpu")
    tables = cluster.pack_clustered(scene, K)
    sp, pl = jscene.spheres, jscene.planes
    centroid = np.concatenate([np.asarray(sp.center),
                               np.asarray(pl.base) + (np.asarray(pl.u) + np.asarray(pl.v)) * 0.5])
    groups = jax_cluster._median_split_clusters(centroid, K)
    slots = tables.slots.numpy().reshape(tables.num_clusters, K)
    assert tables.num_clusters == len(groups) and tables.k == K
    for row, idx in zip(slots, groups):
        np.testing.assert_array_equal(row[:len(idx)], idx)
        assert (row[len(idx):] == -1).all()
    want = jax_cluster.pack_clustered(jscene, K)
    assert want["num_clusters"] == tables.num_clusters
    np.testing.assert_array_equal(tables.boxes.numpy().T, np.asarray(want["cboxes"])[:, :6])


def _tree(name):
    """(the port's tables of tracer's scene, node records as numpy, their
    int32 view)."""
    tables = cluster.pack_clustered(
        T.scene_from_numpy(jax_scene_fields(TREE_SCENES[name]()), "cpu"), K)
    nodes = tables.nodes.numpy()
    return tables, nodes, nodes.view(np.int32)


@pytest.mark.parametrize("name", sorted(TREE_SCENES))
def test_tree_leaves_are_the_clusters_in_preorder(name):
    tables, nodes, bits = _tree(name)
    c = tables.num_clusters
    assert c > 1 and nodes.shape == (2 * c - 1, 2, 4) and nodes.dtype == np.float32
    cid = bits[:, 1, 3]
    np.testing.assert_array_equal(cid[cid >= 0], np.arange(c))
    assert (cid >= -1).all() and (cid == -1).sum() == c - 1


@pytest.mark.parametrize("name", sorted(TREE_SCENES))
def test_tree_boxes_are_the_cluster_boxes_and_their_unions(name):
    tables, nodes, bits = _tree(name)
    boxes = tables.boxes.numpy()
    box = np.concatenate([nodes[:, 0, :3], nodes[:, 1, :3]], axis=1)  # [N, 6]
    for i, c in enumerate(bits[:, 1, 3]):
        if c >= 0:  # a leaf: its cluster's column, bit for bit
            np.testing.assert_array_equal(box[i].view(np.int32), boxes[:, c].view(np.int32))
        else:  # an internal node: the exact min/max of its children
            lower, upper = i + 1, bits[i + 1, 0, 3]
            np.testing.assert_array_equal(box[i, :3], np.minimum(box[lower, :3], box[upper, :3]))
            np.testing.assert_array_equal(box[i, 3:], np.maximum(box[lower, 3:], box[upper, 3:]))


@pytest.mark.parametrize("name", sorted(TREE_SCENES))
def test_tree_skip_indices_are_well_formed(name):
    tables, _, bits = _tree(name)
    n = 2 * tables.num_clusters - 1
    skip, cid = bits[:, 0, 3], bits[:, 1, 3]
    assert skip[0] == n  # the root's subtree is the tree
    for i in range(n):
        if cid[i] >= 0:
            assert skip[i] == i + 1
        else:  # the lower child follows, the upper one starts where it ends
            upper = skip[i + 1]
            assert i + 1 < upper < n and skip[i] == skip[upper] <= n
            # the subtree of 2m - 1 nodes holds m leaves
            assert skip[i] - i == 2 * (cid[i:skip[i]] >= 0).sum() - 1


WALK_SCENES = {
    "big300": lambda: big_scene(300, "cpu"),
    "field500": lambda: sphere_field(500, "cpu")[0],
    "smoke": lambda: builders.create_scene(
        config.read_scene_params(io.StringIO(config.smoke_config_text())),
        texture_loader=lambda _path: None, device="cpu"),
}


def _walk_rays(scene, tables, g):
    """A few hundred rays where ties and rounding live: toward sphere
    centres, plane corners and edge midpoints and cluster-box corners from
    random points; axis-aligned rays from points on cluster-box faces (the
    ray in the face's plane or crossing it); random rays; and rays leaving
    the brute hit points of those (a bounce)."""
    boxes = tables.boxes.numpy().T  # [C, 6]
    lo, hi = boxes[:, :3].min(0), boxes[:, 3:].max(0)
    span = hi - lo

    def points(m):
        return (lo - 0.2 * span + g.uniform(size=(m, 3)) * 1.4 * span).astype(np.float32)

    pl = scene.planes
    base, u, v = pl.base.numpy(), pl.u.numpy(), pl.v.numpy()
    corners = np.concatenate([boxes[:, [0, 1, 2]], boxes[:, [3, 4, 5]], boxes[:, [0, 4, 2]],
                              boxes[:, [3, 1, 5]]])
    targets = np.concatenate([scene.spheres.center.numpy(), base, base + u, base + v,
                              base + 0.5 * u, base + u + 0.5 * v, corners]).astype(np.float32)
    targets = targets[g.choice(len(targets), size=160)]
    o1 = points(160)
    d1 = targets - o1
    # axis-aligned, from a point on a box face: in the face's plane, or across it
    o2 = points(96)
    face = g.integers(0, 6, size=96)
    o2[np.arange(96), face % 3] = boxes[g.integers(0, len(boxes), size=96), face]
    axis = np.where(np.arange(96) % 2 == 0, (face + 1) % 3, face % 3)
    d2 = np.zeros((96, 3), np.float32)
    d2[np.arange(96), axis] = np.where(g.uniform(size=96) < 0.5, -1.0, 1.0)
    o3, d3 = points(96), g.normal(size=(96, 3)).astype(np.float32)
    o, d = np.concatenate([o1, o2, o3]), np.concatenate([d1, d2, d3])
    first = hit.hit_scene_brute(scene, torch.tensor(o), torch.tensor(d))
    o4 = first.point[first.hit].numpy()[:96]
    d4 = g.normal(size=(len(o4), 3)).astype(np.float32)
    return (np.concatenate([o, o4]).astype(np.float32),
            np.concatenate([d, d4]).astype(np.float32))


@pytest.mark.parametrize("name", sorted(WALK_SCENES))
def test_walk_finds_the_flat_visits_nearest_hit(name):
    """The kernel's walk (emulated with its float32 slab and margin) gives
    the winner and t of hit_scene_clustered, which tests every cluster box
    the ray's slab passes, with fewer node tests than clusters per ray."""
    scene = WALK_SCENES[name]()
    tables = cluster.pack_clustered(scene, K)
    o, d = _walk_rays(scene, tables, np.random.default_rng(7))
    assert len(o) > 400
    ot, dt = torch.tensor(o), torch.tensor(d)
    want = hit.hit_scene_clustered(scene, tables, ot, dt)
    t_all = hit._all_ts(scene, ot, dt, core.T_MIN, core.T_MAX)
    t, winner, node_tests, leaves, tests = cluster_walk.walk(
        tables.nodes.numpy(), tables.slots.numpy(), K, o, d, t_all.numpy())
    hits = want.hit.numpy()
    assert 0.3 < hits.mean() < 1.0
    np.testing.assert_array_equal(t, want.t.numpy())
    np.testing.assert_array_equal(winner >= 0, hits)
    np.testing.assert_array_equal(winner[hits], want.winner.numpy()[hits])
    vis = hit.cluster_visibility(tables, ot, dt)
    filled = (tables.slots.reshape(tables.num_clusters, K) >= 0).sum(dim=1)
    assert (leaves <= vis.sum(dim=1).numpy()).all()
    assert (tests <= (vis * filled).sum(dim=1).numpy()).all()
    assert node_tests.mean() < tables.num_clusters
    assert (node_tests <= 2 * tables.num_clusters - 1).all()


def test_walk_prune_factor_is_one_plus_2_to_the_minus_12():
    assert cluster_walk.kernel_prune() == np.float32(1 + 2.0**-12)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_hit_scene_clustered_matches_brute(name):
    scene = T.scene_from_numpy(jax_scene_fields(SCENES[name]()), "cpu")
    tables = cluster.pack_clustered(scene, K)
    g = np.random.default_rng(1)
    o = torch.tensor(g.uniform(-25, 25, size=(4096, 3)).astype(np.float32))
    d = torch.tensor(g.normal(size=(4096, 3)).astype(np.float32))
    want = hit.hit_scene_brute(scene, o, d)
    got = hit.hit_scene_clustered(scene, tables, o, d)
    assert want.hit.float().mean() > 0.3
    assert torch.equal(got.hit, want.hit) and torch.equal(got.t, want.t)
    for f in ("winner", "point", "normal", "albedo", "emit"):  # a miss's record is masked
        assert torch.equal(getattr(got, f)[want.hit], getattr(want, f)[want.hit]), f
    visits = hit.cluster_visibility(tables, o, d).sum(dim=1)
    assert visits.double().mean() < tables.num_clusters / 2  # the culling culls


def test_plain_clustered_render_equals_brute_per_sample():
    scene = tie_free_scene("cpu")
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 12, 8, 55.0,
                                   background=SKY, device="cpu")
    assert cluster.pack_clustered(scene, 2).num_clusters == 3
    before = megakernel.LAUNCHES_CLUSTERED
    for s in range(3):
        got = megakernel.render_frame_kernel(scene, cam, 12, 8, 1, 4, sample_start=s, cluster_k=2)
        want = renderer.render_frame(scene, cam, 12, 8, 1, 4, sample_start=s)
        assert torch.equal(got, want), s
    assert megakernel.LAUNCHES_CLUSTERED == before  # the plain version is not a launch


def test_plain_clustered_render_matches_pallas_interpret(pallas_big300):
    jscene, jcam, want = pallas_big300
    scene, cam = _both(jscene, jcam)
    got = renderer.render_frame(scene, cam, W, H, SPP, DEPTH, cluster_k=K)
    assert (want.max(axis=-1) > 0).mean() > 0.9  # every path is lit
    assert_frames_agree(got, want)
    assert torch.equal(got, renderer.render_frame(scene, cam, W, H, SPP, DEPTH))


def test_rr_start_matches_jax_brute():
    """tracer's clustered path drops rr_start (megakernel.py:300-305), so
    roulette is held against its brute XLA renderer."""
    jscene, jcam = _big300()
    scene, cam = _both(jscene, jcam)
    want = jax_renderer.render_frame(jscene, jcam, W, H, spp=SPP, max_depth=6, rr_start=3,
                                     chunk=128, intersector="brute")
    got = renderer.render_frame(scene, cam, W, H, SPP, 6, rr_start=3, cluster_k=K)
    assert_frames_agree(got, want)
    assert not torch.equal(got, renderer.render_frame(scene, cam, W, H, SPP, 6, cluster_k=K))


def test_padding_case_matches_pallas_culled(pallas_padding):
    jscene, jcam, want = pallas_padding
    scene, cam = _both(jscene, jcam)
    assert cluster.pack_clustered(scene, K).num_clusters % 8 != 0
    got = renderer.render_frame(scene, cam, 32, 8, 2, 3, cluster_k=K)
    assert_frames_agree(got, want)


def test_material_change_with_same_geometry_is_not_stale():
    scene = tie_free_scene("cpu")
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 12, 8, 55.0,
                                   background=SKY, device="cpu")
    before = renderer.render_frame(scene, cam, 12, 8, 2, 4, cluster_k=2)
    redder = scene._replace(materials=scene.materials._replace(
        albedo=scene.materials.albedo * torch.tensor([1.0, 0.5, 0.5])))
    assert cluster.pack_clustered(redder, 2) is cluster.pack_clustered(scene, 2)  # cached
    after = renderer.render_frame(redder, cam, 12, 8, 2, 4, cluster_k=2)
    assert not torch.equal(after, before)
    assert torch.equal(after, renderer.render_frame(redder, cam, 12, 8, 2, 4))


def test_cluster_tables_follow_the_geometry_tensors():
    """The cache holds the tables of the geometry tensors themselves: an
    in-place change builds them anew, and so does a new scene with the same
    geometry, to the same tables."""
    scene = tie_free_scene("cpu")
    tables = cluster.pack_clustered(scene, 2)
    assert cluster.pack_clustered(scene, 2) is tables
    assert cluster.pack_clustered(scene, 3) is not tables
    twin = tie_free_scene("cpu")
    again = cluster.pack_clustered(twin, 2)
    assert again is not tables
    assert torch.equal(again.boxes, tables.boxes) and torch.equal(again.slots, tables.slots)
    with torch.no_grad():
        twin.spheres.center[:, 2] += 5.0
    moved = cluster.pack_clustered(twin, 2)
    assert moved is not again and not torch.equal(moved.boxes, again.boxes)
    assert torch.equal(moved.boxes, cluster._build(cluster._geometry(twin), 2, "cpu").boxes)


@pytest.mark.parametrize("bad", [-1, 1.5, True, "16"])
def test_bad_cluster_k_raises(bad):
    scene = tie_free_scene("cpu")
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 4, 4, 55.0, device="cpu")
    with pytest.raises(ValueError, match="cluster_k must be an int >= 0"):
        megakernel.render_frame_kernel(scene, cam, 4, 4, 1, 2, cluster_k=bad)


def test_recording_renderer_refuses_clusters():
    scene = tie_free_scene("cpu")
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 4, 4, 55.0, device="cpu")
    i, j, seeds = renderer.pixel_grid(4, 4, device="cpu")
    with pytest.raises(ValueError, match="brute force only"):
        renderer.render_pixels(scene, cam, i, j, seeds, 1, 2, tape_fields=9, cluster_k=K)
