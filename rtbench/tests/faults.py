"""Faults planted under the timed path, to see `correct` come out false.
Each replaces a function of the program in the process that calls it
(every rank calls it first: tiny.py's trailing arguments)."""

import torch


def _wrap(fn_of_frame):
    """Break the frame renderer of both engines: the plain one (CPU, and its
    sharded form) and the kernel's entry (the card, which its row bands
    call)."""
    from tracer_torch.dist import sharding
    from tracer_torch.kernels import megakernel
    from tracer_torch.render import renderer

    for mod, name in ((renderer, "render_frame"), (megakernel, "render_frame_kernel"),
                      (sharding, "render_frame_sharded")):
        sound = getattr(mod, f"_sound_{name}", getattr(mod, name))  # a second call re-breaks it

        def broken(scene, cam, width, height, spp, max_depth, _sound=sound, **kw):
            return fn_of_frame(_sound, scene, cam, width, height, spp, max_depth, **kw)

        setattr(mod, f"_sound_{name}", sound)
        setattr(mod, name, broken)


def state_unchanged():
    """A frame's render returns the framebuffer it started from: zeros."""
    _wrap(lambda plain, s, c, w, h, spp, d, **kw: torch.zeros((h, w, 3), device=s.device))


def half_batch():
    """Half of the samples left out, the mean taken over the rest."""
    _wrap(lambda plain, s, c, w, h, spp, d, **kw:
          plain(s, c, w, h, max(1, spp // 2), d, **kw) * (spp / max(1, spp // 2)))


def answer_altered():
    """Each frame altered where it is produced: 2% too bright."""
    _wrap(lambda plain, s, c, w, h, spp, d, **kw: plain(s, c, w, h, spp, d, **kw) * 1.02)


def no_exchange():
    """The exchange between ranks left out: each keeps its own share."""
    import torch.distributed as dist

    dist.all_reduce = lambda tensor, *a, **kw: None
