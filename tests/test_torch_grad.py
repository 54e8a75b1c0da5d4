"""The gradient path of tracer_torch against tracer's, on the CPU: the plain
recording renderer against the Pallas recording kernel, the plain replay
(the backward kernel's twin) against the Pallas backward kernel fed the
same tape, the texture-gradient scatter, render_frame_diff's two modes,
and a finite-difference check.

Scene and camera are tests/test_grad.py's tie-free 12x8 scene, spp 2,
depth 4 (sphere 0 textured with a seeded 40x56 texture in the textured
case). The JAX kernels run in interpret mode once per module.

Tolerances: gradients by tests/test_grad.py:_cmp (every float leaf within
1e-5 * max(1, max|ref|) absolute and 1e-4 relative), replayed frames atol
1e-5. Index tapes are equal. Texture tape fields come from the hit point,
which the Pallas kernel computes in its projection form (|o|^2 - 2 o.c +
|c|^2 - r^2, and alpha = A.o + t A.d - A.base) and the port in the direct
form: their hit points differ by ~1e-6, which moves fu, fv by up to 2e-4
texel and the derivative fields (slope tw*th*|dT| in fu, fv) by up to
1e-2. So the tape is held to JAX's end to end at those bounds, and the
field definitions at atol 1e-5 on the same (u, v).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.core import vec as jax_vec
from tracer.pallas import bwd as jax_bwd
from tracer.pallas import kernel_lib as jax_kernel_lib
from tracer.pallas import megakernel as jax_megakernel
from tracer_torch.core import vec
from tracer_torch.kernels import bwd, diff, megakernel, pack, tex_scatter
from tracer_torch.materials import texture
from tracer_torch.render import camera, hit, renderer
from tracer_torch.scene import types as T

sys.path.insert(0, os.path.dirname(__file__))
from test_grad import H, W, _cam, _scene  # noqa: E402
from test_torch_scene import _cu_enum, jax_cam_fields, jax_scene_fields  # noqa: E402
from torch_scenes import one_torch_thread  # noqa: E402,F401
from torch_scenes import tie_free_scene  # noqa: E402

SPP, DEPTH = 2, 4
RR = 2  # roulette in the textured case


def _textured(scene):
    tex = np.random.default_rng(5).uniform(0.2, 1.0, size=(1, 40, 56, 3)).astype(np.float32)
    tid = np.asarray(scene.materials.tex_id).copy()
    tid[0] = 0
    return scene._replace(textures=jnp.asarray(tex),
                          materials=scene.materials._replace(tex_id=jnp.asarray(tid)))


def _port(jscene):
    return T.scene_from_numpy(jax_scene_fields(jscene), "cpu")


def _pcam():
    return camera.camera_from_numpy(jax_cam_fields(_cam()), "cpu")


G_FB = np.random.default_rng(1).normal(size=(H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    """The JAX recording and backward kernels (interpret mode), once:
    untextured without roulette, and textured with 13 tape fields and
    roulette from bounce 2 (its first 9 fields are the 9-field tape)."""
    out = {}
    for key, jscene, rr, tf in (("untextured", _scene(), None, 3),
                                ("textured", _textured(_scene()), RR, 13)):
        rec = jax_megakernel.render_frame_pallas_record(
            jscene, _cam(), W, H, SPP, DEPTH, interpret=True, rr_start=rr, tape_fields=tf)
        tex = rec[2] if len(rec) == 3 else None
        gs, gc, fb2 = jax_bwd.scene_cam_grads(
            jscene, _cam(), rec[1], jnp.asarray(G_FB), W, H, SPP, DEPTH, rr_start=rr,
            interpret=True, tex_tape=tex, texture_grads=tex is not None)
        out[key] = dict(scene=jscene, rr=rr, fb=np.asarray(rec[0]), idx=np.asarray(rec[1]),
                        tex=None if tex is None else np.asarray(tex), g_scene=gs, g_cam=gc,
                        fb2=np.asarray(fb2))
    return out


def _cmp(got, want, atol_scale=1e-5):
    """tests/test_grad.py:_cmp on one leaf."""
    want = np.asarray(want)
    tol = atol_scale * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=1e-4)


@pytest.mark.parametrize("key", ["untextured", "textured"])
def test_record_twin_matches_jax_record(ref, key):
    r = ref[key]
    out = renderer.render_frame_record(_port(r["scene"]), _pcam(), W, H, SPP, DEPTH,
                                       rr_start=r["rr"], tape_fields=13)
    np.testing.assert_array_equal(out[1].numpy(), r["idx"])
    np.testing.assert_allclose(out[0].numpy(), r["fb"], atol=1e-4, rtol=1e-4)
    assert (r["idx"] >= 0).mean() > 0.15 and (r["idx"] == -1).any()
    if r["tex"] is None:
        assert len(out) == 2
        return
    got, want = out[2].numpy(), r["tex"]
    assert got.shape == want.shape == (SPP, DEPTH, W * H, 13)
    reached = (want[..., 9:].any(-1)) | (got[..., 9:].any(-1))
    assert reached.sum() >= 8  # textured hits
    np.testing.assert_array_equal(got[~reached], want[~reached])  # neutral slots
    g, w = got[reached], want[reached]
    np.testing.assert_array_equal(g[:, 9:11], w[:, 9:11])  # texel x0, y0
    np.testing.assert_allclose(g[:, 0:3], w[:, 0:3], atol=1e-4)  # texel
    np.testing.assert_allclose(g[:, 11:13], w[:, 11:13], atol=5e-4)  # fu, fv
    np.testing.assert_allclose(g[:, 3:9], w[:, 3:9], atol=1e-2)  # d(texel)/d(u, v)
    nine = renderer.render_frame_record(_port(r["scene"]), _pcam(), W, H, SPP, DEPTH,
                                        rr_start=r["rr"], tape_fields=9)
    np.testing.assert_array_equal(nine[2].numpy(), got[..., :9])


def test_tape_fields_match_jax_bilinear():
    """bilinear_tape's fields against the Pallas kernel's own texture fetch
    (kernel_lib._sample_texture with want_grad, _tex_addressing) on the same
    (u, v), wrap edges included."""
    g = np.random.default_rng(7)
    tex = g.uniform(0.1, 1.0, size=(1, 40, 56, 3)).astype(np.float32)
    u = g.uniform(-2.0, 3.0, size=512).astype(np.float32)
    v = g.uniform(-2.0, 3.0, size=512).astype(np.float32)
    u[:4], v[:4] = [0.0, 1.0, 0.5, -1e-9], [0.0, 1.0, 1e-9, 0.25]
    t = jnp.asarray(tex[0])
    val, dpx, dpy = jax_kernel_lib._sample_texture(
        t[:, :, 0], t[:, :, 1], t[:, :, 2], jnp.asarray(u)[None], jnp.asarray(v)[None],
        40, 56, want_grad=True)
    x0, y0, _, _, fu, fv = jax_kernel_lib._tex_addressing(jnp.asarray(u), jnp.asarray(v), 40, 56)
    want = np.concatenate([np.concatenate(val), np.concatenate(dpx) * 56.0,
                           np.concatenate(dpy) * -40.0,
                           np.stack([x0, y0, fu, fv]).astype(np.float32)]).T
    got = texture.bilinear_tape(torch.from_numpy(tex), torch.zeros(512, dtype=torch.int32),
                                torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(torch.cat(got, dim=-1).numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("key, fields", [("untextured", 0), ("textured", 9), ("textured", 13)],
                         ids=["untextured", "rr2-textured9", "rr2-textured13"])
def test_replay_matches_jax_backward_kernel(ref, key, fields):
    """The plain replay fed JAX's own tape against bwd.scene_cam_grads."""
    r = ref[key]
    tape = None if r["tex"] is None else torch.from_numpy(r["tex"][..., :fields].copy())
    g_scene, g_cam, fb = bwd.scene_cam_grads(
        _port(r["scene"]), _pcam(), torch.from_numpy(r["idx"].copy()), torch.from_numpy(G_FB), W, H,
        SPP, DEPTH, rr_start=r["rr"], tex_tape=tape, texture_grads=fields == 13)
    np.testing.assert_allclose(fb.numpy(), r["fb2"], atol=1e-5)
    nonzero = 0
    for grp in ("spheres", "planes", "materials"):
        for name, want in getattr(r["g_scene"], grp)._asdict().items():
            if jnp.issubdtype(want.dtype, jnp.floating):
                got = getattr(getattr(g_scene, grp), name)
                _cmp(got, want)
                nonzero += bool(np.abs(np.asarray(want)).max() > 0)
    for name, want in r["g_cam"]._asdict().items():
        _cmp(getattr(g_cam, name), want)
    assert nonzero >= 8
    if fields == 13:
        want = np.asarray(r["g_scene"].textures)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(g_scene.textures.numpy(), want, rtol=1e-4, atol=1e-7)
    elif fields == 9:
        assert float(g_scene.textures.abs().max()) == 0.0  # the image is frozen


def test_texture_image_grads_matches_jax():
    """The plain scatter against bwd.texture_image_grads, on random
    addressing with wrap corners and zero-cotangent rows."""
    rng = np.random.default_rng(0)
    spp, depth, p, th, tw = 2, 3, 3 * 128, 40, 200
    r = spp * depth
    g = rng.normal(size=(3 * r, p)).astype(np.float32)
    g *= np.repeat((rng.random((r, p)) < 0.5)[None], 3, axis=0).reshape(3 * r, p)
    t2 = np.ones((13 * r, p), np.float32)
    t2[9 * r:10 * r] = rng.integers(0, tw, size=(r, p))
    t2[10 * r:11 * r] = rng.integers(0, th, size=(r, p))
    t2[9 * r:9 * r + 3], t2[10 * r:10 * r + 3] = tw - 1, th - 1  # wrap corners
    t2[11 * r:13 * r] = rng.random((2 * r, p))
    want = np.asarray(jax_bwd.texture_image_grads(jnp.asarray(g), jnp.asarray(t2), spp, depth,
                                                  th, tw))
    before = tex_scatter.LAUNCHES
    got = tex_scatter.texture_image_grads_kernel(torch.from_numpy(g), torch.from_numpy(t2), spp,
                                                 depth, th, tw)
    assert tex_scatter.LAUNCHES == before  # the plain version is not a launch
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-7)


def _leaves(scene):
    return [scene.spheres.center, scene.spheres.radius, scene.planes.normal, scene.planes.d,
            scene.materials.albedo, scene.materials.emit, scene.materials.absorption]


@pytest.mark.parametrize("textured, rr", [(False, None), (True, RR)], ids=["plain", "tex-rr2"])
def test_render_frame_diff_replay_kernel_matches_remat(textured, rr):
    jscene = _textured(_scene()) if textured else _scene()
    grads = {}
    for mode in ("replay-kernel", "remat"):
        scene, cam = _port(jscene), _pcam()
        leaves = _leaves(scene) + list(cam) + ([scene.textures] if textured else [])
        for x in leaves:
            x.requires_grad_()
        fb = diff.render_frame_diff(scene, cam, W, H, SPP, DEPTH, mode=mode, rr_start=rr,
                                    texture_grads=textured)
        loss = torch.sum(fb * fb) / (W * H * SPP)
        grads[mode] = (fb.detach(), torch.autograd.grad(loss, leaves, allow_unused=True))
    torch.testing.assert_close(grads["replay-kernel"][0], grads["remat"][0], rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(grads["replay-kernel"][1], grads["remat"][1]):
        b = torch.zeros_like(a) if b is None else b
        tol = 1e-5 * max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=1e-4, atol=tol)


def test_replay_kernel_finite_differences():
    """d loss / d sphere z through mode replay-kernel against central
    differences (tests/test_grad.py:492), with a ramp texture on that sphere
    so that the gradient is not 0 (the untextured scene's is exactly 0) and
    the loss summed in float64 so that the differences rise above rounding."""
    def loss_at(cz, grad=False):
        scene = tie_free_scene("cpu", cz, ramp=True)
        z = scene.spheres.center
        if grad:
            z.requires_grad_()
        fb = diff.render_frame_diff(scene, _pcam(), W, H, SPP, DEPTH).double()
        loss = torch.sum(fb * fb) / (W * H * SPP)
        return (loss, z) if grad else float(loss)

    loss, z = loss_at(1.0, grad=True)
    (g,) = torch.autograd.grad(loss, z)
    eps = 1e-2
    fd = (loss_at(1.0 + eps) - loss_at(1.0 - eps)) / (2 * eps)
    assert abs(fd) > 1e-6
    np.testing.assert_allclose(float(g[0, 2]), fd, rtol=2e-2)


def test_render_frame_diff_rejects():
    scene, cam = _port(_scene()), _pcam()
    with pytest.raises(ValueError, match="texture_grads requires"):
        diff.render_frame_diff(scene, cam, W, H, 1, 2, mode="replay", texture_grads=True)
    with pytest.raises(ValueError, match="unknown mode"):
        diff.render_frame_diff(scene, cam, W, H, 1, 2, mode="replay-bogus")


def test_sqrt_grad_safe_matches_jax():
    x = np.array([0.0, 1e-30, 0.25, 4.0], np.float32)
    t = torch.from_numpy(x).requires_grad_()
    y = vec._sqrt_grad_safe(t)
    (g,) = torch.autograd.grad(y.sum(), t)
    want = jax.grad(lambda a: jnp.sum(jax_vec._sqrt_grad_safe(a)))(jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.sqrt(x), rtol=0, atol=0)
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-6)
    assert np.isfinite(g.numpy()).all()


def test_winner_is_the_argmin_primitive():
    scene = _port(_scene())
    o = torch.tensor([[5.0, -6.0, 3.0]] * 3)
    d = torch.tensor([[-5.0, 6.0, -2.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    rec = hit.hit_scene_brute(scene, o, d)
    assert rec.winner.tolist()[:2] == [0, 4] and rec.hit.tolist() == [True, True, False]


def test_kernel_wrappers_take_the_plain_versions_for_cpu_tensors():
    scene, cam = _port(_textured(_scene())), _pcam()
    before = (megakernel.LAUNCHES_RECORD, bwd.LAUNCHES)
    got = megakernel.render_frame_kernel_record(scene, cam, W, H, SPP, DEPTH, tape_fields=9)
    want = renderer.render_frame_record(scene, cam, W, H, SPP, DEPTH, tape_fields=9)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    bwd.scene_cam_grads(scene, cam, got[1], torch.ones(H, W, 3), W, H, SPP, DEPTH,
                        tex_tape=got[2])
    assert (megakernel.LAUNCHES_RECORD, bwd.LAUNCHES) == before


@pytest.mark.parametrize("enum, rows", [("TableRow", pack.BWD_ROWS), ("CamvRow", pack.CAMV_ROWS)])
def test_bwd_rows_match_kernel_source(enum, rows):
    assert _cu_enum(enum) == rows


def test_pack_tables_match_jax():
    """The combined table and camera rows against tracer/pallas/bwd.py's
    (its join rows are padded to 24, its camera broadcast over 128 lanes)."""
    jscene = _textured(_scene())
    jtab, jcamv = jax_bwd.pack_tables(jscene, _cam())
    table, camv = bwd.pack_tables(_port(jscene), _pcam())
    n = table.shape[1]
    jrows = list(range(pack.JROWS)) + [jax_kernel_lib.JROWS + g for g in range(9)]
    np.testing.assert_allclose(table.numpy(), np.asarray(jtab)[jrows, :n], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(camv.numpy(), np.asarray(jcamv)[:15, 0])


def test_frozen_texture_warns():
    """A texture that requires grad gets a zero gradient unless texture_grads
    is on: render_frame_diff says so (the silent-zero hazard of
    tracer/pallas/diff.py's default)."""
    scene = _port(_textured(_scene()))
    scene.textures.requires_grad_()
    with pytest.warns(UserWarning, match="texture_grads"):
        fb = diff.render_frame_diff(scene, _pcam(), W, H, 1, 2)
    (g,) = torch.autograd.grad(fb.sum(), scene.textures)
    assert float(g.abs().max()) == 0.0
