"""The depth-independent gradient path of tracer_torch against tracer's, on
the CPU: `scene_grads_chunked` and `l2_grads_deep` (tracer/pallas/bwd.py),
the 3-field record tape, and render_frame_diff's modes "replay" and
"replay-sample" (tracer/pallas/diff.py).

Scene and camera are tests/test_grad.py's tie-free 12x8 scene, depth 4
(sphere 0 textured with a seeded 40x56 texture, and roulette from bounce
2, in the textured case): spp 4 in chunks of 2 for the chunked path, spp 2
for the modes. The JAX side runs once per module, its kernels in
interpret mode.

Tolerances: every float leaf within 1e-5 * max(1, max|ref|) absolute and
1e-4 relative (tests/test_grad.py:_cmp and its chunked test's rule), the
loss within a relative 1e-6; tapes equal. As in tests/test_torch_grad.py's
test_replay_matches_jax_backward_kernel, the port's chunked backward is
fed tracer's own chunk tapes: the index tapes are equal, but the
derivative fields of the texture tape differ by up to 1e-2 (that file's
docstring says why), which moves a camera gradient by ~5e-5 of its scale.
"""

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.pallas import bwd as jax_bwd
from tracer.pallas import diff as jax_diff
from tracer.pallas import megakernel as jax_megakernel
from tracer_torch.kernels import bwd, diff, megakernel
from tracer_torch.render import renderer

sys.path.insert(0, os.path.dirname(__file__))
from test_grad import H, W, _cam, _scene  # noqa: E402
from test_torch_grad import RR, _pcam, _port, _textured  # noqa: E402
from torch_scenes import one_torch_thread  # noqa: E402,F401

DEPTH = 4
SPP, CHUNK = 4, 2  # the chunked path
MODE_SPP = 2  # the replay modes
CASES = {"untextured": (_scene, None), "textured": (lambda: _textured(_scene()), RR)}
G_FB = np.random.default_rng(3).normal(size=(H, W, 3)).astype(np.float32)
TARGET = np.random.default_rng(4).uniform(0.0, 2.0, size=(H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    """tracer's chunked gradients and their chunks' tapes, l2_grads_deep
    (untextured) and the two replay modes' gradients (both scenes)."""
    out = {}
    for key, (make, rr) in CASES.items():
        jscene = make()
        out[key, "chunked"] = jax_bwd.scene_grads_chunked(
            jscene, _cam(), jnp.asarray(G_FB), W, H, SPP, DEPTH, spp_chunk=CHUNK, rr_start=rr,
            interpret=True)
        out[key, "tapes"] = [
            [np.asarray(x) for x in jax_megakernel.render_frame_pallas_record(
                jscene, _cam(), W, H, CHUNK, DEPTH, interpret=True, sample_start=c * CHUNK,
                rr_start=rr, tape_fields=9 if jscene.textures is not None else 3)[1:]]
            for c in range(SPP // CHUNK)]
        for mode in ("replay", "replay-sample"):
            def loss(scene, cam, mode=mode, rr=rr):
                fb = jax_diff.render_frame_diff(scene, cam, W, H, MODE_SPP, DEPTH, mode=mode,
                                                rr_start=rr)
                return jnp.sum(fb * fb) / (W * H * MODE_SPP)
            out[key, mode] = jax.grad(loss, argnums=(0, 1), allow_int=True)(jscene, _cam())
    make, rr = CASES["untextured"]
    out["l2"] = jax_bwd.l2_grads_deep(make(), _cam(), jnp.asarray(TARGET), W, H, SPP, DEPTH,
                                      spp_chunk=CHUNK, rr_start=rr, interpret=True)
    return out


def _cmp(got, want, name):
    want = np.asarray(want)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=1e-4, err_msg=name)


def _cmp_jax(scene, cam, g_scene, g_cam, want_scene, want_cam):
    """Every float leaf of the port's (d(scene), d(cam)) against tracer's;
    returns the number of leaves with a nonzero gradient."""
    nonzero = 0
    for name, got, want in zip(bwd.leaf_names(scene, cam), bwd.float_grads(scene, g_scene, g_cam),
                               _jax_float_grads(want_scene, want_cam)):
        _cmp(got, want, name)
        nonzero += bool(np.abs(np.asarray(want)).max() > 0)
    return nonzero


def _jax_float_grads(g_scene, g_cam):
    return [x for g in ("spheres", "planes", "materials") for x in getattr(g_scene, g)
            if jnp.issubdtype(x.dtype, jnp.floating)] + list(g_cam)


@pytest.mark.parametrize("key", list(CASES))
def test_chunked_matches_jax(ref, key, monkeypatch):
    """The port's chunk loop and plain backward fed tracer's chunk tapes
    (after checking its own index tapes equal them) against tracer's
    scene_grads_chunked."""
    make, rr = CASES[key]
    scene, cam = _port(make()), _pcam()
    record = megakernel.render_frame_kernel_record

    def record_then_swap(*args, sample_start, **kw):
        out = record(*args, sample_start=sample_start, **kw)
        tapes = ref[key, "tapes"][sample_start // CHUNK]
        np.testing.assert_array_equal(out[1].numpy(), tapes[0])
        if len(out) == 3:
            np.testing.assert_allclose(out[2].numpy(), tapes[1], atol=1e-2)
        return (out[0], *(torch.from_numpy(t.copy()) for t in tapes))

    monkeypatch.setattr(bwd.megakernel, "render_frame_kernel_record", record_then_swap)
    g_scene, g_cam = bwd.scene_grads_chunked(scene, cam, torch.from_numpy(G_FB), W, H, SPP, DEPTH,
                                             spp_chunk=CHUNK, rr_start=rr)
    assert _cmp_jax(scene, cam, g_scene, g_cam, *ref[key, "chunked"]) >= 8
    assert g_scene.spheres.material_idx is None and g_scene.materials.mtype is None
    if scene.textures is not None:
        assert float(g_scene.textures.abs().max()) == 0.0  # the image is frozen


def _one_shot(scene, cam, spp, g_fb, mode="replay-kernel", rr=None, texture_grads=False):
    """(float leaves' gradients, texture gradient or None) of <fb, g_fb>
    through render_frame_diff."""
    leaves = [x.detach().clone().requires_grad_() for x in bwd.float_leaves(scene, cam)]
    scene, cam = bwd.with_float_leaves(scene, cam, leaves)
    frozen = contextlib.nullcontext()
    if scene.textures is not None:
        scene = scene._replace(textures=scene.textures.detach().clone().requires_grad_())
        leaves.append(scene.textures)
        if not texture_grads:
            frozen = pytest.warns(UserWarning, match="texture_grads")
    with frozen:
        fb = diff.render_frame_diff(scene, cam, W, H, spp, DEPTH, mode=mode, rr_start=rr,
                                    texture_grads=texture_grads)
    grads = list(torch.autograd.grad(fb, leaves, g_fb))
    tex = grads.pop() if scene.textures is not None else None
    return grads, tex


@pytest.mark.parametrize("key, texture_grads", [("untextured", False), ("textured", False),
                                                ("textured", True)],
                         ids=["untextured", "rr2-textured", "rr2-textured-texgrads"])
def test_chunked_matches_one_shot(key, texture_grads):
    """Chunk sums equal the one-shot render_frame_diff gradients up to
    float32 addition order (tests/test_grad.py:560-565), the texture
    image's included."""
    make, rr = CASES[key]
    scene, cam = _port(make()), _pcam()
    g_fb = torch.from_numpy(G_FB)
    g_scene, g_cam = bwd.scene_grads_chunked(scene, cam, g_fb, W, H, SPP, DEPTH,
                                             spp_chunk=CHUNK, rr_start=rr,
                                             texture_grads=texture_grads)
    want, want_tex = _one_shot(scene, cam, SPP, g_fb, rr=rr, texture_grads=texture_grads)
    for name, a, b in zip(bwd.leaf_names(scene, cam), bwd.float_grads(scene, g_scene, g_cam),
                          want):
        _cmp(a, b.numpy(), name)
    if texture_grads:
        assert float(want_tex.abs().max()) > 0
        torch.testing.assert_close(g_scene.textures, want_tex, rtol=1e-4, atol=1e-7)


def test_chunked_rejects_a_chunk_that_does_not_divide_spp():
    scene, cam = _port(_scene()), _pcam()
    with pytest.raises(ValueError, match="spp_chunk"):
        bwd.scene_grads_chunked(scene, cam, torch.zeros(H, W, 3), W, H, 4, DEPTH, spp_chunk=3)


@pytest.mark.parametrize("fwd_chunk", [None, 2], ids=["one-frame", "fwd-chunks"])
def test_l2_grads_deep_matches_jax(ref, fwd_chunk):
    make, rr = CASES["untextured"]
    scene, cam = _port(make()), _pcam()
    loss, g_scene, g_cam = bwd.l2_grads_deep(scene, cam, torch.from_numpy(TARGET), W, H, SPP,
                                             DEPTH, spp_chunk=CHUNK, rr_start=rr,
                                             fwd_spp_chunk=fwd_chunk)
    want_loss, want_scene, want_cam = ref["l2"]
    assert loss.shape == () and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    fb = renderer.render_frame(scene, cam, W, H, SPP, DEPTH, rr_start=rr)
    np.testing.assert_allclose(float(loss), float(torch.mean((fb / SPP - torch.from_numpy(TARGET))
                                                             ** 2)), rtol=1e-6)
    assert _cmp_jax(scene, cam, g_scene, g_cam, want_scene, want_cam) >= 8


@pytest.mark.parametrize("kernel_wrapper", [False, True], ids=["plain", "kernel-wrapper"])
def test_three_field_tape_is_the_nine_field_tape_head(kernel_wrapper):
    make, rr = CASES["textured"]
    scene, cam = _port(make()), _pcam()
    record = megakernel.render_frame_kernel_record if kernel_wrapper else \
        renderer.render_frame_record
    three = record(scene, cam, W, H, SPP, DEPTH, rr_start=rr, tape_fields=3)
    nine = record(scene, cam, W, H, SPP, DEPTH, rr_start=rr, tape_fields=9)
    assert three[2].shape == (SPP, DEPTH, W * H, 3)
    assert torch.equal(three[0], nine[0]) and torch.equal(three[1], nine[1])
    assert torch.equal(three[2], nine[2][..., :3])
    assert (three[2] != 1.0).any()  # textured hits were recorded


@pytest.mark.parametrize("kernel_wrapper", [False, True], ids=["plain", "kernel-wrapper"])
def test_zero_field_record_is_the_index_tape_alone(kernel_wrapper):
    """tape_fields=0, what mode "replay-sample" records: the frame and the
    index tape of the 9-field record, and no texture tape."""
    make, rr = CASES["textured"]
    scene, cam = _port(make()), _pcam()
    record = megakernel.render_frame_kernel_record if kernel_wrapper else \
        renderer.render_frame_record
    zero = record(scene, cam, W, H, SPP, DEPTH, rr_start=rr, tape_fields=0)
    nine = record(scene, cam, W, H, SPP, DEPTH, rr_start=rr, tape_fields=9)
    assert len(zero) == 2
    assert torch.equal(zero[0], nine[0]) and torch.equal(zero[1], nine[1])


@pytest.mark.parametrize("mode", ["replay", "replay-sample"])
@pytest.mark.parametrize("key", list(CASES))
def test_replay_modes_match_jax(ref, key, mode):
    make, rr = CASES[key]
    scene, cam = _port(make()), _pcam()
    fb = diff.render_frame_diff(scene, cam, W, H, MODE_SPP, DEPTH, mode=mode, rr_start=rr)
    grads, tex = _one_shot(scene, cam, MODE_SPP, 2.0 * fb.detach() / (W * H * MODE_SPP),
                           mode=mode, rr=rr)
    want_scene, want_cam = ref[key, mode]
    nonzero = 0
    for name, got, want in zip(bwd.leaf_names(scene, cam), grads,
                               _jax_float_grads(want_scene, want_cam)):
        _cmp(got, want, name)
        nonzero += bool(np.abs(np.asarray(want)).max() > 0)
    assert nonzero >= 8
    if tex is not None:
        assert float(tex.abs().max()) == 0.0  # the image takes no gradient in either mode


@pytest.mark.parametrize("key", list(CASES))
def test_replay_sample_matches_replay_kernel(key):
    """Both carry d(texel)/d(uv) (live sampling and the 9-field tape's
    linearised texel), so every gradient agrees; "replay" agrees on the
    material colours."""
    make, rr = CASES[key]
    scene, cam = _port(make()), _pcam()
    g_fb = torch.from_numpy(G_FB)
    out = {m: _one_shot(scene, cam, MODE_SPP, g_fb, mode=m, rr=rr)[0]
           for m in ("replay-kernel", "replay-sample", "replay")}
    names = bwd.leaf_names(scene, cam)
    for name, a, b, c in zip(names, out["replay-sample"], out["replay-kernel"], out["replay"]):
        _cmp(a, b.numpy(), name)
        if name in ("materials.albedo", "materials.emit"):
            _cmp(c, b.numpy(), name)
    if key == "textured":  # the frozen texel loses d(texel)/d(uv): sphere 0's centre moves
        i = names.index("spheres.center")
        assert not torch.allclose(out["replay"][i], out["replay-kernel"][i], rtol=1e-3)


def test_replay_modes_refuse_texture_grads():
    scene, cam = _port(_textured(_scene())), _pcam()
    for mode in ("replay", "replay-sample"):
        with pytest.raises(ValueError, match="texture_grads requires"):
            diff.render_frame_diff(scene, cam, W, H, 1, 2, mode=mode, texture_grads=True)


def test_backward_refuses_the_three_field_tape():
    """The backward (kernel or plain) takes 9 or 13 fields: the frozen
    texel is mode "replay"'s, through the plain replay."""
    scene, cam = _port(_textured(_scene())), _pcam()
    out = renderer.render_frame_record(scene, cam, W, H, 1, 2, tape_fields=3)
    with pytest.raises(ValueError, match="9- or 13-field"):
        bwd.scene_cam_grads(scene, cam, out[1], torch.ones(H, W, 3), W, H, 1, 2, tex_tape=out[2])
