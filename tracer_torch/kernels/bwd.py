"""The backward kernel: packing, binding and dispatch (port of the host
side of tracer/pallas/bwd.py).

`scene_cam_grads` turns a recorded frame's tapes and the loss cotangent
on its raw sample sums into (d(scene), d(cam), replayed fb). The kernel
works on two packed inputs: the combined table (`pack_bwd_tables`, rows
in tracer_torch.kernels.pack) and the camera rows. Both are built with
plain differentiable torch ops, so `torch.autograd.grad` of the packing
maps the kernel's `dtable` / `dcam` back onto the scene and camera leaves
(the port of the JAX package's `jax.vjp(pack_tables)`).

`band_cotangents` dispatches by the table's device, and only by that:

  - CPU tensors   -> the plain replay (tracer_torch.kernels.replay);
  - CUDA tensors  -> the CUDA kernel (`csrc/bwd.cu`), or an error.

`texture_image_grads` is the plain version of the texture-gradient scatter
(tracer_torch.kernels.tex_scatter holds its kernel). `LAUNCHES` counts the
backward kernel's launches.

`scene_grads_chunked` and `l2_grads_deep` (tracer/pallas/bwd.py:937,
:1012) take gradients at any depth, the reference's 50 included, with
tape memory bounded by an spp chunk: each chunk is recorded by the record
kernel and back-propagated by the backward kernel, and its tapes are
freed before the next chunk is recorded.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tracer_torch.core import vec
from tracer_torch.kernels import megakernel, nvcc
from tracer_torch.kernels import pack as P
from tracer_torch.kernels import replay
from tracer_torch.render import camera as camera_mod
from tracer_torch.scene.types import Scene

LAUNCHES = 0  # launches of the CUDA backward kernel since import (or since reset to 0)
SHARED_BYTES_MAX = 200 * 1024  # a dtable up to this size accumulates in shared memory
THREADS = 128


def pack_bwd_tables(scene: Scene) -> torch.Tensor:
    """The combined `[TROWS, S+P]` table (tracer/pallas/bwd.py:pack_bwd_tables),
    spheres first, built differentiably from the scene's leaves."""
    sph, pla, mats = scene.spheres, scene.planes, scene.materials
    num_s, num_p = scene.num_spheres, scene.num_planes
    dev = sph.center.device
    zs = torch.zeros(num_s, dtype=torch.float32, device=dev)
    zp = torch.zeros(num_p, dtype=torch.float32, device=dev)
    one_s, one_p = torch.ones_like(zs), torch.ones_like(zp)
    sp = lambda x: torch.cat([x, zp])  # a sphere field, 0 on planes
    pl = lambda x: torch.cat([zs, x])  # a plane field, 0 on spheres
    midx = torch.cat([sph.material_idx, pla.material_idx]).long()
    a_vec = vec.cross(pla.v, pla.w)
    b_vec = vec.cross(pla.w, pla.u)
    rows = [
        sp(sph.center[:, 0]), sp(sph.center[:, 1]), sp(sph.center[:, 2]),
        torch.cat([sph.radius, one_p]),  # planes: a division-safe placeholder
        pl(pla.normal[:, 0]), pl(pla.normal[:, 1]), pl(pla.normal[:, 2]),
        torch.cat([one_s, zp]),
        mats.mtype[midx].to(torch.float32), mats.fuzz[midx], mats.ir[midx],
        *mats.absorption[midx].unbind(1), *mats.albedo[midx].unbind(1),
        *mats.emit[midx].unbind(1), mats.tex_id[midx].to(torch.float32),
        pl(pla.d), *(pl(a_vec[:, k]) for k in range(3)), *(pl(b_vec[:, k]) for k in range(3)),
        pl(torch.sum(pla.base * a_vec, dim=-1)), pl(torch.sum(pla.base * b_vec, dim=-1)),
    ]
    return torch.stack(rows)


def pack_tables(scene: Scene, cam: camera_mod.CameraData):
    """(table `[TROWS, S+P]`, camera rows `[15]` in `CAMV_ROWS` order): the two
    inputs whose cotangents carry every scene and camera gradient. The
    backward pass (K2 and its plain replay) knows the pinhole, the
    background and the reference's materials only: a scene or camera with
    any of `pack.rtiow_features` raises."""
    unsupported = P.rtiow_features(scene, cam)
    if unsupported:
        raise ValueError(f"K2 (the backward pass) does not support {', '.join(unsupported)}")
    camv = torch.cat([cam.pixel00_loc, cam.pixel_delta_u, cam.pixel_delta_v, cam.origin,
                      cam.background]).to(torch.float32)
    return pack_bwd_tables(scene), camv


def texture_image_grads(gtex2, t2, spp: int, max_depth: int, th: int, tw: int):
    """d(texture image) `[th, tw, 3]` from the per-bounce texel cotangents
    (tracer/pallas/bwd.py:texture_image_grads): `gtex2` `[3*spp*D, P]`
    channel-major, `t2` the field-major 13-field tape whose rows 9-12 hold
    the bilinear addressing (x0, y0, fu, fv). Four weighted `index_add_`s,
    one per bilinear corner, with the neighbour wrap of the fetch."""
    rows = spp * max_depth
    g = gtex2.reshape(3, rows, -1).permute(1, 2, 0)  # [rows, P, 3]
    x0 = t2[9 * rows:10 * rows].long()
    y0 = t2[10 * rows:11 * rows].long()
    fu = t2[11 * rows:12 * rows]
    fv = t2[12 * rows:13 * rows]
    x1 = torch.where(x0 + 1 < tw, x0 + 1, 0)  # neighbour wrap
    y1 = torch.where(y0 + 1 < th, y0 + 1, 0)
    out = torch.zeros((th * tw, 3), dtype=torch.float32, device=gtex2.device)
    for yy, xx, w in ((y0, x0, (1.0 - fu) * (1.0 - fv)), (y0, x1, fu * (1.0 - fv)),
                      (y1, x0, (1.0 - fu) * fv), (y1, x1, fu * fv)):
        out.index_add_(0, (yy * tw + xx).reshape(-1), (w[..., None] * g).reshape(-1, 3))
    return out.reshape(th, tw, 3)


def _field_major(tex_tape, spp, max_depth, num_pixels):
    """[spp, D, N, F] -> [F*spp*D, N]; free when the tape came from the
    recording kernel, which stores it field-major."""
    f = tex_tape.shape[-1]
    return tex_tape.reshape(spp, max_depth, num_pixels, f).permute(3, 0, 1, 2).contiguous() \
        .reshape(f * spp * max_depth, num_pixels)


def band_cotangents(table, camv, idx, g_fb, width: int, band_rows: int, spp: int,
                    max_depth: int, *, row_offset: int = 0, sample_start: int = 0,
                    reference_quirk: bool = True, rr_start=None, tex_tape=None,
                    texture_grads: bool = False, tex_shape=None, strat_k: int = 0):
    """(dtable, dcam, fb `[N, 3]`[, dtex `[th, tw, 3]`]) for one band of
    `band_rows` rows starting at image row `row_offset`.

    idx: `[spp, max_depth, N]` int32 (or any shape reshapable to it);
    g_fb: the cotangent on the band's raw sample sums, reshapable to
    `[N, 3]`; tex_tape: `[spp, max_depth, N, F]` or None. With
    `texture_grads` (13 fields, `tex_shape` = (th, tw)) the texel
    cotangents are scattered onto the texture image. `strat_k`: the
    recording's stratification grid (0: uniform jitter)."""
    from tracer_torch.kernels import tex_scatter

    n = width * band_rows
    rows = spp * max_depth
    idx2 = idx.reshape(rows, n)
    g2 = g_fb.reshape(n, 3).to(torch.float32)
    t2 = None if tex_tape is None else _field_major(tex_tape, spp, max_depth, n)
    if t2 is not None and t2.shape[0] not in (9 * rows, 13 * rows):
        raise ValueError(f"the backward takes a 9- or 13-field texture tape, got "
                         f"{t2.shape[0] // rows} fields")
    if texture_grads:
        if t2 is None or t2.shape[0] != 13 * rows or tex_shape is None:
            raise ValueError("texture_grads needs a 13-field tape and tex_shape")
    kw = dict(row_offset=row_offset, sample_start=sample_start,
              reference_quirk=reference_quirk, rr_start=rr_start, strat_k=strat_k)
    dev = table.device
    if dev.type == "cpu":
        dtable, dcam, fb, gtex = replay.replay_cotangents(
            table, camv, idx2, g2, width, spp, max_depth, t2=t2, want_texgrad=texture_grads,
            **kw)
    elif dev.type == "cuda":
        dtable, dcam, fb, gtex = bwd_kernel(table, camv, idx2, g2, width, spp, max_depth,
                                            t2=t2, want_texgrad=texture_grads, **kw)
    else:
        raise ValueError(f"band_cotangents: no kernel for device {dev}")
    if not texture_grads:
        return dtable, dcam, fb
    dtex = tex_scatter.texture_image_grads_kernel(gtex, t2, spp, max_depth, *tex_shape)
    return dtable, dcam, fb, dtex


_GROUPS = ("spheres", "planes", "materials")


def float_leaves(scene: Scene, cam: camera_mod.CameraData) -> list:
    """The leaves the packed tables depend on: every float leaf of the
    scene's spheres, planes and materials, then the camera's fields."""
    return [x for g in _GROUPS for x in getattr(scene, g) if x.is_floating_point()] + list(cam)


def leaf_names(scene: Scene, cam: camera_mod.CameraData) -> list:
    return [f"{g}.{name}" for g in _GROUPS for name, x in getattr(scene, g)._asdict().items()
            if x.is_floating_point()] + [f"cam.{name}" for name in cam._fields]


def with_float_leaves(scene: Scene, cam: camera_mod.CameraData, values, ints="keep"):
    """(scene, cam) with the float leaves replaced by `values` (in
    `float_leaves` order); the integer leaves kept, or set to `ints`."""
    it = iter(values)
    groups = {g: getattr(scene, g)._make(next(it) if x.is_floating_point()
                                         else (x if ints == "keep" else ints)
                                         for x in getattr(scene, g)) for g in _GROUPS}
    return scene._replace(**groups), type(cam)(*it)


def leaf_cotangents(scene: Scene, cam: camera_mod.CameraData, dtable, dcam) -> list:
    """The cotangents of `float_leaves(scene, cam)` for the packed tables'
    cotangents (dtable, dcam): autograd through the packing."""
    with torch.enable_grad():
        req = [x.detach().requires_grad_() for x in float_leaves(scene, cam)]
        table, camv = pack_tables(*with_float_leaves(scene, cam, req))
        grads = torch.autograd.grad((table, camv), req, (dtable, dcam), allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(req, grads)]


def leaf_grads(scene: Scene, cam: camera_mod.CameraData, dtable, dcam) -> list:
    """[(leaf name, cotangent)] of the scene and camera float leaves for the
    packed tables' cotangents (dtable, dcam)."""
    return list(zip(leaf_names(scene, cam), leaf_cotangents(scene, cam, dtable, dcam)))


def scene_cam_cotangents(scene: Scene, cam: camera_mod.CameraData, idx, g_fb, width: int,
                         height: int, spp: int, max_depth: int, reference_quirk: bool = True,
                         rr_start=None, sample_start: int = 0, row_offset: int = 0,
                         tex_tape=None, texture_grads: bool = False, stratify: bool = False,
                         strat_sqrt_spp: int = 0):
    """(cotangents of `float_leaves(scene, cam)`, d(texture layer 0) or
    None, replayed fb `[H, W, 3]`): `scene_cam_grads` as flat lists."""
    strat_k = camera_mod.strat_grid(stratify, spp, strat_sqrt_spp)
    tex_shape = None
    if texture_grads:
        if scene.textures is None:
            raise ValueError("texture_grads needs a textured scene")
        tex_shape = tuple(scene.textures.shape[1:3])
    table, camv = pack_tables(scene, cam)
    out = band_cotangents(table.detach(), camv.detach(), idx, g_fb, width, height, spp,
                          max_depth, row_offset=row_offset, sample_start=sample_start,
                          reference_quirk=reference_quirk, rr_start=rr_start,
                          tex_tape=tex_tape, texture_grads=texture_grads, tex_shape=tex_shape,
                          strat_k=strat_k)
    grads = leaf_cotangents(scene, cam, out[0], out[1])
    return grads, (out[3] if texture_grads else None), out[2].reshape(height, width, 3)


def scene_cam_grads(scene: Scene, cam: camera_mod.CameraData, idx, g_fb, width: int,
                    height: int, spp: int, max_depth: int, reference_quirk: bool = True,
                    rr_start=None, sample_start: int = 0, row_offset: int = 0,
                    tex_tape=None, texture_grads: bool = False, stratify: bool = False,
                    strat_sqrt_spp: int = 0):
    """(d(scene), d(cam), fb `[H, W, 3]`) for the cotangent `g_fb` `[H, W, 3]`
    on a recorded frame (tracer/pallas/bwd.py:scene_cam_grads).

    `stratify` (and `strat_sqrt_spp` for a chunk of a larger frame) must
    be what the recording took: the backward regenerates its primary rays.

    d(scene) is a Scene of gradients: one per float leaf, None for the
    integer leaves, and for the textures zeros (or, with `texture_grads`,
    the image cotangent on layer 0). d(cam) is a CameraData."""
    grads, dtex, fb = scene_cam_cotangents(
        scene, cam, idx, g_fb, width, height, spp, max_depth, reference_quirk=reference_quirk,
        rr_start=rr_start, sample_start=sample_start, row_offset=row_offset,
        tex_tape=tex_tape, texture_grads=texture_grads, stratify=stratify,
        strat_sqrt_spp=strat_sqrt_spp)
    g_scene, g_cam = with_float_leaves(scene, cam, grads, ints=None)
    if scene.textures is not None:
        g_tex = torch.zeros_like(scene.textures)
        if dtex is not None:
            g_tex[0] += dtex
        g_scene = g_scene._replace(textures=g_tex)
    return g_scene, g_cam, fb


def float_grads(scene: Scene, g_scene: Scene, g_cam) -> list:
    """The gradients of `float_leaves(scene, cam)` out of a (d(scene),
    d(cam)) pair, in that order."""
    return [getattr(g_scene, g)[k] for g in _GROUPS for k, x in enumerate(getattr(scene, g))
            if x.is_floating_point()] + list(g_cam)


def _add_grads(a, b):
    """Sum two (d(scene), d(cam)) pairs leaf by leaf; None (the integer
    leaves) stays None."""
    add = lambda x, y: None if x is None else x + y
    g_scene = a[0]._replace(**{g: getattr(a[0], g)._make(
        map(add, getattr(a[0], g), getattr(b[0], g))) for g in _GROUPS},
        textures=add(a[0].textures, b[0].textures))
    return g_scene, type(a[1])(*map(add, a[1], b[1]))


def scene_grads_chunked(scene: Scene, cam: camera_mod.CameraData, g_fb, width: int,
                        height: int, spp: int, max_depth: int, spp_chunk: int = 4,
                        reference_quirk: bool = True, rr_start=None,
                        texture_grads: bool = False, stratify: bool = False):
    """(d(scene), d(cam)) for the cotangent `g_fb` `[H, W, 3]` on the raw
    sample sums of `spp` samples, with tape memory bounded by `spp_chunk`
    (tracer/pallas/bwd.py:scene_grads_chunked).

    Samples are independent, so each chunk's output cotangent is `g_fb`
    unchanged: chunk c is recorded by `megakernel.render_frame_kernel_record
    (..., sample_start=c * spp_chunk)` (9 texture fields on a textured
    scene, 13 with `texture_grads`) and back-propagated by `scene_cam_grads`
    with the same `sample_start`, and the chunks' gradients are summed
    (None stays None for the integer leaves). Each chunk's tapes are freed
    before the next is recorded, so that the peak tape memory is one
    chunk's (`megakernel.tape_bytes(width, height, spp_chunk, ...)`). The
    sum equals the one-shot gradients up to float32 addition order.
    With `stratify`, every chunk takes the whole frame's grid, k =
    sqrt(spp) (tracer's chunks have no stratify: its driver took k from a
    chunk's spp).

    Dispatch goes by the scene's device, as its two calls' does: the plain
    versions for CPU tensors, the kernels for CUDA tensors.

    The JAX function's TPU knobs are left out: `interpret`, `fast_math`,
    and the depth buckets (`bucketed`, `scene_grads_bucketed`,
    `_needed_depth_per_tile`), which skip a tile's dead tape rows because
    the TPU kernel's unrolled bounces cannot. The backward kernel stops
    each path at its last bounce, and its scratch holds 10 floats a bounce
    only up to where the path dies (csrc/bwd.cu); whether depth buckets
    would still pay on the GPU is measured by chip_smoke.py (phase 11:
    the share of tape slots with a winner and the last live bounce), not
    assumed."""
    if not (isinstance(spp_chunk, int) and spp_chunk > 0 and spp % spp_chunk == 0):
        raise ValueError(f"spp_chunk must be a positive int dividing spp {spp}, "
                         f"got {spp_chunk!r}")
    texture_grads = bool(texture_grads) and scene.textures is not None
    k = camera_mod.strat_grid(stratify, spp)
    strat = dict(stratify=bool(k), strat_sqrt_spp=k)
    total = None
    for c in range(spp // spp_chunk):
        start = c * spp_chunk
        out = megakernel.render_frame_kernel_record(
            scene, cam, width, height, spp_chunk, max_depth, reference_quirk=reference_quirk,
            rr_start=rr_start, sample_start=start, tape_fields=13 if texture_grads else 9,
            **strat)
        idx, tex = out[1], (out[2] if len(out) == 3 else None)
        del out
        part = scene_cam_grads(scene, cam, idx, g_fb, width, height, spp_chunk, max_depth,
                               reference_quirk=reference_quirk, rr_start=rr_start,
                               sample_start=start, tex_tape=tex,
                               texture_grads=texture_grads, **strat)[:2]
        del idx, tex  # this chunk's tapes go before the next chunk's are made
        total = part if total is None else _add_grads(total, part)
    return total


def l2_grads_deep(scene: Scene, cam: camera_mod.CameraData, target, width: int, height: int,
                  spp: int, max_depth: int, spp_chunk: int = 4, reference_quirk: bool = True,
                  rr_start=None, fwd_spp_chunk=None, texture_grads: bool = False,
                  stratify: bool = False):
    """(loss, d(scene), d(cam)) of `mean((fb / spp - target) ** 2)` at any
    depth (tracer/pallas/bwd.py:l2_grads_deep); `target` is `[H, W, 3]`.

    The loss frame `fb` is rendered first by the forward kernel
    (`megakernel.render_frame_kernel`; with `fwd_spp_chunk` < spp, as a sum
    of frames of that many samples each, through `sample_start`); its
    cotangent then goes to `scene_grads_chunked`. The loss is a 0-d
    float32 tensor on the scene's device. `stratify` stratifies every
    sample's jitter over the whole frame's sqrt(spp) grid.

    `fwd_spp_chunk` is kept for parity with tracer's API, where it bounds
    the length of one TPU dispatch: on the card the forward kernel holds
    no tapes, so splitting it buys nothing, and no caller in this package
    passes it."""
    k = camera_mod.strat_grid(stratify, spp)
    strat = dict(stratify=bool(k), strat_sqrt_spp=k)
    if fwd_spp_chunk and fwd_spp_chunk < spp:
        if spp % fwd_spp_chunk:
            raise ValueError(f"fwd_spp_chunk {fwd_spp_chunk} does not divide spp {spp}")
        fb = None
        for c in range(spp // fwd_spp_chunk):
            part = megakernel.render_frame_kernel(
                scene, cam, width, height, fwd_spp_chunk, max_depth,
                reference_quirk=reference_quirk, rr_start=rr_start,
                sample_start=c * fwd_spp_chunk, **strat)
            fb = part if fb is None else fb + part
    else:
        fb = megakernel.render_frame_kernel(scene, cam, width, height, spp, max_depth,
                                            reference_quirk=reference_quirk, rr_start=rr_start,
                                            **strat)
    target = torch.as_tensor(target, dtype=torch.float32, device=fb.device)
    err = fb / spp - target
    loss = torch.mean(err * err)
    g_fb = err * (2.0 / (spp * err.numel()))
    del fb, err
    g_scene, g_cam = scene_grads_chunked(
        scene, cam, g_fb, width, height, spp, max_depth, spp_chunk,
        reference_quirk=reference_quirk, rr_start=rr_start, texture_grads=texture_grads,
        stratify=stratify)
    return loss, g_scene, g_cam


# ---- the CUDA kernel ---------------------------------------------------------


def _fn():
    fn = nvcc.library("bwd").tracer_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_uint, i, i, i, i,
                   p, p, p, p, p, i, i, i, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def blocks_per_sm(shared: bool, num_prims: int) -> int:
    """Resident blocks an SM of the kernel variant with these arguments
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), queried once per
    variant and table width."""
    fn = nvcc.library("bwd").tracer_bwd_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(int(shared), num_prims, ctypes.byref(out))
    if err != 0 or out.value < 1:
        raise RuntimeError(f"backward kernel occupancy query failed: CUDA error {err}, "
                           f"{out.value} blocks")
    return out.value


def grid_blocks(num_pixels: int, shared: bool, num_prims: int, device) -> int:
    """The launch's blocks: one wave of resident blocks on every SM, or
    one block for each THREADS pixels of a smaller band."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-num_pixels // THREADS), sms * blocks_per_sm(shared, num_prims)))


def scratch_floats_per_thread(max_depth: int) -> int:
    """Entry states the kernel keeps per thread: origin, direction,
    throughput and seed, 10 floats per bounce (STATE_FLOATS in bwd.cu)."""
    return 10 * max_depth


def bwd_kernel(table, camv, idx2, g2, width: int, spp: int, max_depth: int, *,
               row_offset: int = 0, sample_start: int = 0, reference_quirk: bool = True,
               rr_start=None, t2=None, want_texgrad: bool = False, strat_k: int = 0):
    """Launch `csrc/bwd.cu` on CUDA tensors; same contract and outputs as
    tracer_torch.kernels.replay.replay_cotangents. Raises on what the
    kernel does not take; does not synchronise.

    `dtable` accumulates per block in shared memory and is added to the
    output with one atomicAdd per entry; a table above SHARED_BYTES_MAX
    (about 1700 primitives) takes the kernel's global-atomic variant. The
    grid is one wave of the blocks the card holds at once (`grid_blocks`),
    whose warps take their next 32 pixels from a counter."""
    dev = table.device
    rows, n = idx2.shape
    trows, num_prims = table.shape
    if trows != P.TROWS:
        raise ValueError(f"table must have {P.TROWS} rows, got {trows}")
    if rows != spp * max_depth:
        raise ValueError(f"idx has {rows} rows, expected spp*max_depth = {spp * max_depth}")
    for name, t, dtype, shape in (("table", table, torch.float32, None),
                                  ("camv", camv, torch.float32, (len(P.CAMV_ROWS),)),
                                  ("idx", idx2, torch.int32, None),
                                  ("g_fb", g2, torch.float32, (n, 3))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the table on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    tape_f = 0
    if t2 is not None:
        if t2.device != dev or t2.dtype != torch.float32:
            raise TypeError("the texture tape must be float32 on the table's device")
        tape_f = t2.shape[0] // rows
        if tape_f not in (9, 13) or t2.shape != (tape_f * rows, n):
            raise ValueError(f"texture tape must be [9 or 13 x {rows}, {n}], got {tuple(t2.shape)}")
        t2 = t2.contiguous()
    if want_texgrad and tape_f != 13:
        raise ValueError("texture gradients need the 13-field tape")
    if isinstance(strat_k, bool) or not isinstance(strat_k, int) or strat_k < 0:
        raise ValueError(f"strat_k must be an int >= 0, got {strat_k!r}")
    if n >= 2**31 or n % width:
        raise ValueError(f"{n} pixels is not a band of width {width} in int32 range")
    table, camv, idx2, g2 = (t.contiguous() for t in (table, camv, idx2, g2))

    dtable = torch.zeros_like(table)
    dcam = torch.zeros(len(P.CAMV_ROWS), dtype=torch.float32, device=dev)
    fb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    gtex = (torch.zeros((3 * rows, n), dtype=torch.float32, device=dev)
            if want_texgrad else None)
    shared = table.numel() * 4 <= SHARED_BYTES_MAX
    blocks = grid_blocks(n, shared, num_prims, dev)
    scratch = torch.empty((scratch_floats_per_thread(max_depth), blocks * THREADS),
                          dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    nxt = torch.zeros(1, dtype=torch.int32, device=dev)  # the warps' pixel counter
    err = _fn()(table.data_ptr(), num_prims, camv.data_ptr(), idx2.data_ptr(), g2.data_ptr(),
                None if t2 is None else t2.data_ptr(), tape_f, int(want_texgrad), width, n,
                spp, max_depth, row_offset, sample_start, int(reference_quirk),
                -1 if rr_start is None else rr_start, strat_k, int(shared),
                dtable.data_ptr(), dcam.data_ptr(), fb.data_ptr(),
                None if gtex is None else gtex.data_ptr(), scratch.data_ptr(), blocks,
                THREADS, scratch.shape[0], stream, nxt.data_ptr())
    if err != 0:
        raise RuntimeError(f"backward kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return dtable, dcam, fb, gtex
