"""Frames and scene gradients across ranks (port of tracer/dist/sharding.py).

tracer runs one controller over a `jax.sharding.Mesh` and shards the pixel
axis with `shard_map`. The port runs one process per rank (SPMD) in a
torch.distributed process group, and every rank:

- holds the replicated scene and camera on its own device (`make_mesh`:
  `cuda:(LOCAL_RANK % device_count())`, or the device the caller names);
- computes its own share, split as tracer splits it: a contiguous range
  of flat pixels (`render_frame_sharded`), a row band (the kernel path and
  the gradients) or a slice of the samples (`render_frame_spp_sharded`);
- takes part in the collectives, which are `all_reduce(SUM)` only: a
  frame is built by zero-filling the whole frame, writing the rank's share
  and summing, which is exact (x + 0.0 == x), so a sharded frame is bit
  for bit the one-device frame; gradients are the ranks' partial sums;
- returns what tracer returns: the whole `[H, W, 3]` frame, or the summed
  gradients, on every rank.

Seeds depend only on (image pixel, global sample id), so a share renders
what the one-device frame renders there: a row band launches the forward
kernel with its `row_offset`, the image row of its first row (tracer's
params slot 15). `tracer` renders `ceil(H / n)` rows in every band and
slices off the rows below the image; here the last band is shorter, and a
band wholly below the image renders nothing but still takes part in the
sum.

The backend is the caller's (multihost.initialize): NCCL on the card,
gloo on the CPU and for several ranks that share one card (NCCL refuses
two ranks on one device). gloo's support of CUDA tensors covers
all_reduce, which is all this module uses.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from tracer_torch.kernels import bwd, megakernel, replay
from tracer_torch.render import camera as camera_mod
from tracer_torch.render import renderer
from tracer_torch.utils import profiling

AXIS = "tiles"


class Mesh(NamedTuple):
    """This rank's view of the process group: tracer's 1-D mesh over the
    axis "tiles", one device per rank."""
    group: Any  # the torch.distributed process group
    size: int  # ranks in the group
    rank: int  # this process's rank in it
    device: torch.device  # where this rank keeps its scene and renders
    axis: str = AXIS


def _local_device() -> torch.device:
    """`cuda:(LOCAL_RANK % device_count())`, LOCAL_RANK from the environment
    (torchrun sets it) or else the rank in the default group."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to shard on the CPU")
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", int(local) % torch.cuda.device_count())


def make_mesh(device=None) -> Mesh:
    """The mesh of the initialized default process group, on `device`
    (default `cuda:(LOCAL_RANK % device_count())`)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(tracer_torch.dist.multihost.initialize, or torchrun)")
    device = _local_device() if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank(), device)


def pixel_range(num_pixels: int, size: int, rank: int):
    """(start, stop) of rank's contiguous flat pixels: the pixel axis padded
    to a multiple of `size` and cut in equal parts, as tracer's P('tiles');
    the padding is not rendered."""
    per = -(-num_pixels // size)
    start = min(num_pixels, rank * per)
    return start, min(num_pixels, start + per)


def row_band(height: int, size: int, rank: int):
    """(row0, rows) of rank's band: `ceil(height / size)` rows from `rank *
    that`, cut at the image's edge (0 rows for a band below it)."""
    start, stop = pixel_range(height, size, rank)
    return start, stop - start


def _check(scene, mesh: Mesh):
    if scene.device != mesh.device:
        raise ValueError(f"the scene is on {scene.device}, the mesh's rank {mesh.rank} on "
                         f"{mesh.device}")


def _sum(mesh: Mesh, tensors):
    """The tensors summed over the mesh's ranks, in one all_reduce."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    out, k = [], 0
    for t in tensors:
        out.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return out


def _frame_by_bands(render, scene, cam, width, height, mesh, **kw):
    """The whole frame from each rank's row band, rendered by `render`
    (render_frame_kernel, which dispatches by the scene's device)."""
    row0, rows = row_band(height, mesh.size, mesh.rank)
    with profiling.span("tracer.band.render"):
        fb = torch.zeros((height, width, 3), dtype=torch.float32, device=mesh.device)
        if rows:
            fb[row0:row0 + rows] = render(scene, cam, width, rows, row_offset=row0, **kw)
    with profiling.span("tracer.band.all_reduce"):
        dist.all_reduce(fb, op=dist.ReduceOp.SUM, group=mesh.group)
    return fb


def render_frame_sharded(scene, cam: camera_mod.CameraData, width: int, height: int, spp: int,
                         max_depth: int, mesh: Mesh, intersector: str = "brute",
                         reference_quirk: bool = True, chunk: int = renderer.DEFAULT_CHUNK,
                         stratify: bool = False, rr_start=None, sample_start: int = 0,
                         strat_sqrt_spp: int = 0, rng_mode: str = "fixed"):
    """`[height, width, 3]` raw sample sums, bit for bit
    renderer.render_frame's: each rank renders its contiguous range of flat
    pixels (`pixel_range`) with the plain renderer on its device, chunked
    by `chunk`. `sample_start` and `strat_sqrt_spp` take a sample chunk of
    a larger frame, as render_frame's; `rng_mode` picks the stream, as
    render_frame's (a lane's stream depends on its pixel and sample only,
    so the split stays invisible)."""
    _check(scene, mesh)
    n = width * height
    start, stop = pixel_range(n, mesh.size, mesh.rank)
    fb = torch.zeros((n, 3), dtype=torch.float32, device=mesh.device)
    if stop > start:
        i, j, base = renderer.pixel_grid(width, height, reference_quirk, device=mesh.device)
        fb[start:stop] = renderer.render_pixels(
            scene, cam, i[start:stop], j[start:stop], base[start:stop], spp, max_depth,
            chunk=chunk, sample_start=sample_start, rr_start=rr_start, stratify=stratify,
            strat_sqrt_spp=strat_sqrt_spp, intersector=intersector, rng_mode=rng_mode)
    dist.all_reduce(fb, op=dist.ReduceOp.SUM, group=mesh.group)
    return fb.reshape(height, width, 3)


def render_frame_spp_sharded(scene, cam: camera_mod.CameraData, width: int, height: int,
                             spp: int, max_depth: int, mesh: Mesh, intersector: str = "brute",
                             reference_quirk: bool = True,
                             chunk: int = renderer.DEFAULT_CHUNK, stratify: bool = False,
                             rr_start=None, rng_mode: str = "fixed"):
    """Sample-axis sharding: every rank renders all pixels with its slice of
    `spp / n` global samples from `rank * spp / n` (stratified over the
    whole frame's sqrt(spp) grid), and the raw sums are summed over the
    ranks: renderer.render_frame's frame up to float32 addition order.
    `rng_mode` as render_frame's. Raises when spp does not divide over the
    ranks."""
    _check(scene, mesh)
    if spp % mesh.size:
        raise ValueError(f"spp {spp} does not divide over {mesh.size} ranks")
    local = spp // mesh.size
    k = camera_mod.strat_grid(stratify, spp)
    i, j, base = renderer.pixel_grid(width, height, reference_quirk, device=mesh.device)
    fb = renderer.render_pixels(scene, cam, i, j, base, local, max_depth, chunk=chunk,
                                sample_start=mesh.rank * local, rr_start=rr_start,
                                stratify=bool(k), strat_sqrt_spp=k, intersector=intersector,
                                rng_mode=rng_mode)
    dist.all_reduce(fb, op=dist.ReduceOp.SUM, group=mesh.group)
    return fb.reshape(height, width, 3)


def render_frame_kernel_sharded(scene, cam: camera_mod.CameraData, width: int, height: int,
                                spp: int, max_depth: int, mesh: Mesh,
                                reference_quirk: bool = True, rr_start=None,
                                sample_start: int = 0, stratify: bool = False,
                                strat_sqrt_spp: int = 0, rng_mode: str = "fixed"):
    """The forward kernel over row bands (port of render_frame_pallas_sharded):
    each rank launches K1 (K1-ref with `rng_mode="reference"`) on its band
    (`row_band`) with the band's `row_offset`, and the bands are summed
    into the whole `[height, width, 3]` frame on every rank, bit for bit
    the one-launch frame of megakernel.render_frame_kernel. Brute force, as
    tracer's. Needs a CUDA scene and raises on any other:
    render_frame_sharded is the plain path."""
    if scene.device.type != "cuda":
        raise ValueError(f"render_frame_kernel_sharded launches the CUDA kernel: the scene is "
                         f"on {scene.device} (render_frame_sharded renders with the plain "
                         f"version)")
    _check(scene, mesh)
    return _frame_by_bands(megakernel.render_frame_kernel, scene, cam, width, height, mesh,
                           spp=spp, max_depth=max_depth, reference_quirk=reference_quirk,
                           rr_start=rr_start, sample_start=sample_start, stratify=stratify,
                           strat_sqrt_spp=strat_sqrt_spp, rng_mode=rng_mode)


def _scene_leaves(scene, cam):
    """The scene's float leaves (bwd.float_leaves without the camera's),
    then its textures if it has them."""
    leaves = bwd.float_leaves(scene, cam)[:-len(cam)]
    return leaves + ([] if scene.textures is None else [scene.textures])


def _scene_grads(scene, cam, grads):
    """A Scene of gradients from the cotangents of `_scene_leaves`: None for
    the integer leaves."""
    n = len(grads) - (scene.textures is not None)
    g_scene = bwd.with_float_leaves(scene, cam, list(grads[:n]) + list(cam), ints=None)[0]
    return g_scene._replace(textures=grads[n] if scene.textures is not None else None)


def scene_grads_sharded(scene, cam: camera_mod.CameraData, target, width: int, height: int,
                        spp: int, max_depth: int, mesh: Mesh, intersector: str = "brute"):
    """(loss, d(scene)) of `mean((fb / spp - target) ** 2)` over the whole
    frame by autograd through the plain renderer, sharded: each rank
    differentiates its row band's share of the loss (its squared errors
    over the GLOBAL `height * width * 3`), and the loss and the gradients
    of the scene's float leaves and textures are summed over the ranks.
    d(scene) is a Scene of gradients (None for the integer leaves)."""
    _check(scene, mesh)
    row0, rows = row_band(height, mesh.size, mesh.rank)
    target = torch.as_tensor(target, dtype=torch.float32, device=mesh.device)
    leaves = [x.detach().requires_grad_() for x in _scene_leaves(scene, cam)]
    loss = torch.zeros((), dtype=torch.float32, device=mesh.device)
    grads = [torch.zeros_like(x) for x in leaves]
    if rows:
        n = len(leaves) - (scene.textures is not None)
        with torch.enable_grad():
            s = bwd.with_float_leaves(scene, cam, leaves[:n] + list(cam))[0]
            if scene.textures is not None:
                s = s._replace(textures=leaves[n])
            fb = renderer.render_frame(s, cam, width, rows, spp, max_depth,
                                       intersector=intersector, row_offset=row0)
            err = fb / spp - target[row0:row0 + rows]
            loss = torch.sum(err * err) / (height * width * 3)
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [z if g is None else g for z, g in zip(grads, got)]
    loss, *grads = _sum(mesh, [loss.detach(), *grads])
    return loss, _scene_grads(scene, cam, grads)


def scene_grads_replay_sharded(scene, cam: camera_mod.CameraData, target, width: int,
                               height: int, spp: int, max_depth: int, mesh: Mesh,
                               reference_quirk: bool = True):
    """(loss, d(scene)) of `mean((fb / spp - target) ** 2)` through the
    replay, sharded: each rank records its row band with the record kernel
    (K1-rec; the plain record on the CPU), the winner tape and the 3-field
    texel tape, and autograd runs through kernels/replay.py's replay of the
    band (render_frame_diff's mode "replay": a textured hit's texel is the
    recorded constant, and the texture image gets a zero gradient). The
    loss and the packed tables' cotangents are summed over the ranks, then
    mapped onto the scene's leaves."""
    _check(scene, mesh)
    row0, rows = row_band(height, mesh.size, mesh.rank)
    target = torch.as_tensor(target, dtype=torch.float32, device=mesh.device)
    table, camv = (t.detach() for t in bwd.pack_tables(scene, cam))
    loss = torch.zeros((), dtype=torch.float32, device=mesh.device)
    dtable, dcam = torch.zeros_like(table), torch.zeros_like(camv)
    if rows:
        n = width * rows
        out = megakernel.render_frame_kernel_record(
            scene, cam, width, rows, spp, max_depth, reference_quirk=reference_quirk,
            tape_fields=3, row_offset=row0)
        err = out[0] / spp - target[row0:row0 + rows]
        loss = torch.sum(err * err) / (height * width * 3)
        g = err * (2.0 / (spp * height * width * 3))
        t2 = None if len(out) == 2 else bwd._field_major(out[2], spp, max_depth, n)
        dtable, dcam, _, _ = replay.replay_cotangents(
            table, camv, out[1].reshape(spp * max_depth, n), g.reshape(n, 3), width, spp,
            max_depth, row_offset=row0, reference_quirk=reference_quirk, t2=t2)
    loss, dtable, dcam = _sum(mesh, [loss, dtable, dcam])
    grads = bwd.leaf_cotangents(scene, cam, dtable, dcam)[:-len(cam)]
    if scene.textures is not None:
        grads.append(torch.zeros_like(scene.textures))
    return loss, _scene_grads(scene, cam, grads)


def _chunk_cotangents_sharded(scene, cam, table, camv, g_band, width: int, row0: int, rows: int,
                              spp_chunk: int, max_depth: int, sample_start: int,
                              reference_quirk: bool, rr_start, texture_grads: bool,
                              strat_k: int):
    """One spp chunk of the sharded kernel backward on this rank: record the
    band's tapes (K1-rec, `row_offset=row0`) and run the backward kernel
    on them (K2, and K3 with `texture_grads`) through bwd.band_cotangents,
    which takes the plain replay on the CPU. Returns the band's (dtable,
    dcam, fb[, dtex]); the caller sums them over chunks and ranks. The
    tapes never leave the rank and are freed on return."""
    out = megakernel.render_frame_kernel_record(
        scene, cam, width, rows, spp_chunk, max_depth, reference_quirk=reference_quirk,
        rr_start=rr_start, sample_start=sample_start, tape_fields=13 if texture_grads else 9,
        stratify=bool(strat_k), strat_sqrt_spp=strat_k, row_offset=row0)
    idx, tex = out[1], (out[2] if len(out) == 3 else None)
    del out
    return bwd.band_cotangents(
        table, camv, idx, g_band, width, rows, spp_chunk, max_depth, row_offset=row0,
        sample_start=sample_start, reference_quirk=reference_quirk, rr_start=rr_start,
        tex_tape=tex, texture_grads=texture_grads,
        tex_shape=tuple(scene.textures.shape[1:3]) if texture_grads else None, strat_k=strat_k)


def l2_grads_deep_sharded(scene, cam: camera_mod.CameraData, target, width: int, height: int,
                          spp: int, max_depth: int, mesh: Mesh, spp_chunk: int = 8,
                          reference_quirk: bool = True, rr_start=None, fwd_spp_chunk=None,
                          texture_grads: bool = False, stratify: bool = False):
    """(loss, d(scene), d(cam)) of `mean((fb / spp - target) ** 2)` at any
    depth, sharded over row bands and chunked over samples: bwd.l2_grads_deep
    across ranks.

    The forward renders the whole frame by bands (render_frame_kernel on
    each band, optionally in `fwd_spp_chunk` sample chunks), so every rank
    holds the one-device frame and computes the loss and its cotangent
    from it: the loss is bit for bit bwd.l2_grads_deep's. Then for each
    chunk of `spp_chunk` samples each rank records its band and runs the
    backward on it (`_chunk_cotangents_sharded`); the packed tables' and
    the texture image's cotangents are summed over the chunks, then over
    the ranks in one all_reduce, and mapped onto the scene's and camera's
    leaves as bwd.scene_cam_grads does. The gradients equal the one-device
    ones up to float32 addition order. Dispatch goes by the scene's
    device, as bwd.l2_grads_deep's: the kernels on the card, their plain
    versions on the CPU."""
    _check(scene, mesh)
    if not (isinstance(spp_chunk, int) and spp_chunk > 0 and spp % spp_chunk == 0):
        raise ValueError(f"spp_chunk must be a positive int dividing spp {spp}, "
                         f"got {spp_chunk!r}")
    k = camera_mod.strat_grid(stratify, spp)
    kw = dict(max_depth=max_depth, reference_quirk=reference_quirk, rr_start=rr_start,
              stratify=bool(k), strat_sqrt_spp=k)
    if fwd_spp_chunk and fwd_spp_chunk < spp:
        if spp % fwd_spp_chunk:
            raise ValueError(f"fwd_spp_chunk {fwd_spp_chunk} does not divide spp {spp}")
        fb = None
        for c in range(spp // fwd_spp_chunk):
            part = _frame_by_bands(megakernel.render_frame_kernel, scene, cam, width, height,
                                   mesh, spp=fwd_spp_chunk, sample_start=c * fwd_spp_chunk, **kw)
            fb = part if fb is None else fb + part
    else:
        fb = _frame_by_bands(megakernel.render_frame_kernel, scene, cam, width, height, mesh,
                             spp=spp, **kw)
    target = torch.as_tensor(target, dtype=torch.float32, device=mesh.device)
    err = fb / spp - target
    loss = torch.mean(err * err)
    g_fb = err * (2.0 / (spp * err.numel()))
    del fb, err

    texture_grads = bool(texture_grads) and scene.textures is not None
    row0, rows = row_band(height, mesh.size, mesh.rank)
    table, camv = (t.detach() for t in bwd.pack_tables(scene, cam))
    cot = [torch.zeros_like(table), torch.zeros_like(camv)]
    if texture_grads:
        cot.append(torch.zeros(scene.textures.shape[1:], dtype=torch.float32,
                               device=mesh.device))
    for c in range(spp // spp_chunk if rows else 0):
        part = _chunk_cotangents_sharded(scene, cam, table, camv, g_fb[row0:row0 + rows], width,
                                         row0, rows, spp_chunk, max_depth, c * spp_chunk,
                                         reference_quirk, rr_start, texture_grads, k)
        for acc, p in zip(cot, part[:2] + part[3:]):
            acc += p
    cot = _sum(mesh, cot)
    grads = bwd.leaf_cotangents(scene, cam, cot[0], cot[1])
    g_scene, g_cam = bwd.with_float_leaves(scene, cam, grads, ints=None)
    if scene.textures is not None:
        g_tex = torch.zeros_like(scene.textures)
        if texture_grads:
            g_tex[0] += cot[2]
        g_scene = g_scene._replace(textures=g_tex)
    return loss, g_scene, g_cam
