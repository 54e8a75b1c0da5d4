"""Process-group setup and work splitting across processes (port of
tracer/dist/multihost.py).

tracer's two levers carry over, with one process per rank (one device
each) in place of one controller per host:

- ROW sharding (within a frame): every frame is rendered by row bands over
  the whole group (sharding.render_frame_kernel_sharded, or the plain
  sharding.render_frame_sharded), and rank 0 prints and writes. Used when
  one frame must go fast.
- FRAME sharding (across frames): frames are independent (their own
  output files, camera.cu:297-300), so ranks take whole frames round-robin
  with no communication, each on its own device. Used for animation
  throughput.

Run N ranks with `torchrun --nproc_per_node=N` (it sets MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK), or start them yourself with
COORDINATOR_ADDRESS (host:port of rank 0), NUM_PROCESSES and PROCESS_ID,
and call `initialize` in each.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from tracer_torch.dist import sharding
from tracer_torch.render import driver

BACKENDS = ("nccl", "gloo")


def _env_int(*names):
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: str = "nccl",
               timeout: float = 300.0) -> bool:
    """Open the default process group of this process; returns whether it
    did.

    The arguments fall back on tracer's environment (COORDINATOR_ADDRESS
    as host:port, NUM_PROCESSES, PROCESS_ID), then on torch's (MASTER_ADDR
    and MASTER_PORT, WORLD_SIZE, RANK). One process (no count, or 1) is a
    no-op. `backend`: "nccl" (the default, one card per rank) or "gloo"
    (the CPU, or several ranks on one card, which NCCL refuses); a backend
    that fails to start raises, and no other is tried. An explicit
    multi-process setup that does not come together within `timeout`
    seconds raises as well."""
    n = num_processes if num_processes is not None else _env_int("NUM_PROCESSES", "WORLD_SIZE")
    if n is None or n == 1:
        return False
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    pid = process_id if process_id is not None else _env_int("PROCESS_ID", "RANK")
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if addr is None or pid is None:
        raise ValueError(f"{n} processes need a coordinator address and this process's id "
                         f"(arguments, COORDINATOR_ADDRESS/PROCESS_ID or MASTER_ADDR/RANK)")
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device((pid if local is None else local) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=n, rank=pid,
                            timeout=datetime.timedelta(seconds=timeout))
    return True


def _rank_and_size():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def my_frames(num_frames: int, process_id: Optional[int] = None,
              num_processes: Optional[int] = None) -> list:
    """Round-robin frame assignment of this process (frame sharding): the
    frames f with f % num_processes == process_id, both defaulting to the
    process group's (rank 0 of 1 without one)."""
    rank, size = _rank_and_size()
    pid = rank if process_id is None else process_id
    n = size if num_processes is None else num_processes
    return [f for f in range(num_frames) if f % n == pid]


def render_animation_multihost(scene, params, frame_shard: bool = True, **kwargs):
    """Render an animation across the process group; returns this rank's
    last framebuffer (driver.render_animation's keyword arguments pass
    through).

    frame_shard=True: each rank renders its round-robin frames
    (`my_frames`) on its own device, with no communication, and writes only
    those frames' files and TSV lines.

    frame_shard=False: every frame is rendered by row bands over the whole
    group (driver.render_animation with `mesh`), and only rank 0 prints the
    TSV and writes the files; every rank returns the whole last frame.
    Without a group (one process) this is driver.render_animation.
    `rng_mode` passes through as the other keywords do (tracer/dist/
    multihost.py:123 passes it to its sharded renderer)."""
    if frame_shard:
        return driver.render_animation(scene, params, frames=my_frames(params.num_frames),
                                       **kwargs)
    if _rank_and_size()[1] == 1:
        return driver.render_animation(scene, params, **kwargs)
    return driver.render_animation(scene, params, mesh=sharding.make_mesh(scene.device),
                                   **kwargs)
