"""Inverse rendering: gradient-descent fitting of scene parameters (port
of tracer/opt/fit.py).

Parameters are addressed by dotted paths into the Scene (e.g.
"spheres.center", "materials.albedo") and, with `cam_spec`, "camera.*"
entries that rebuild the camera differentiably each step. The optimiser
is torch.optim.Adam, the update of optax.adam (`mu_hat / (sqrt(nu_hat) +
1e-8)`). Checkpoints are npz files with the JAX package's key layout
(`param:<path>`, `opt:<i>`, `step`, the optimiser state flattened as
optax's `(count, mu, nu)` leaves), so a fit resumes across the two
packages in either direction.

Engines: "cuda" renders with the recording kernel and differentiates
with the backward kernel (render_frame_diff mode "replay-kernel"); it
needs a scene on a CUDA device and is brute force only, as tracer's
Pallas gradient path. "torch" differentiates the plain renderer (mode
"remat") on the scene's device, with either intersector (the BVH is the
scene's own, built for its starting geometry, as in tracer). Both take
`stratify`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from tracer_torch.kernels import diff
from tracer_torch.render import camera as camera_mod
from tracer_torch.scene.types import Scene

DEFAULT_PARAMS = ("spheres.center", "spheres.radius", "materials.albedo")
ENGINES = {"cuda": "replay-kernel", "torch": "remat"}
ADAM_EPS = 1e-8  # optax.adam's eps (eps_root 0)


def get_path(tree, path: str):
    for part in path.split("."):
        tree = getattr(tree, part)
    return tree


def set_path(tree, path: str, value):
    """Functional set on nested NamedTuples."""
    head, _, rest = path.partition(".")
    if not rest:
        return tree._replace(**{head: value})
    return tree._replace(**{head: set_path(getattr(tree, head), rest, value)})


def extract_params(scene: Scene, paths: Iterable[str]) -> Dict[str, torch.Tensor]:
    return {p: get_path(scene, p) for p in paths}


def apply_params(scene: Scene, params: Dict[str, torch.Tensor]) -> Scene:
    for p, v in params.items():
        scene = set_path(scene, p, v)
    return scene


def render_loss_fn(scene: Scene, cam: camera_mod.CameraData, target, width: int, height: int,
                   spp: int, max_depth: int, engine: str = "cuda",
                   cam_spec: Optional[Dict] = None, stratify: bool = False,
                   intersector: str = "brute") -> Callable:
    """L2 image loss `mean((fb / spp - target)^2)` as a function of a params
    dict. `cam_spec` (dict with "origin"/"look_at" and optionally "vfov",
    "vup", "background") lets "camera.*" params override it; the camera is
    then rebuilt differentiably inside the loss (camera.cu:171-196)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {tuple(ENGINES)}")
    if engine == "cuda" and scene.device.type != "cuda":
        raise ValueError(f"engine 'cuda' needs a scene on a CUDA device, got {scene.device}")
    if engine == "cuda" and intersector == "bvh":
        raise ValueError("engine 'cuda' differentiates with the brute-force kernels: "
                         "intersector 'bvh' needs engine 'torch'")
    target = _f32(target, scene.device)

    def loss(params):
        cam_l = cam
        if cam_spec is not None:
            spec = dict(cam_spec)
            spec.update({k[len("camera."):]: v for k, v in params.items()
                         if k.startswith("camera.")})
            cam_l = camera_mod.build_camera_data(width=width, height=height,
                                                 device=scene.device, **spec)
        s = apply_params(scene, {k: v for k, v in params.items() if not k.startswith("camera.")})
        fb = diff.render_frame_diff(s, cam_l, width, height, spp, max_depth, mode=ENGINES[engine],
                                    stratify=stratify, intersector=intersector)
        return torch.mean((fb / spp - target) ** 2)

    return loss


def _f32(v, device) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def _opt_leaves(params: Dict[str, torch.Tensor], opt: torch.optim.Adam):
    """optax.adam's flattened state: [count, mu (sorted keys), nu (sorted keys)]."""
    keys = sorted(params)
    states = [opt.state.get(params[k], {}) for k in keys]
    count = int(states[0]["step"]) if states and "step" in states[0] else 0
    mu = [st.get("exp_avg", torch.zeros_like(params[k])) for k, st in zip(keys, states)]
    nu = [st.get("exp_avg_sq", torch.zeros_like(params[k])) for k, st in zip(keys, states)]
    return [np.asarray(count, np.int32)] + [t.detach().cpu().numpy() for t in mu + nu]


def save_checkpoint(path: str, step: int, params: Dict[str, torch.Tensor],
                    opt: torch.optim.Adam) -> None:
    """Flat npz checkpoint in the JAX package's layout."""
    arrays = {f"param:{k}": v.detach().cpu().numpy() for k, v in params.items()}
    arrays.update({f"opt:{i}": v for i, v in enumerate(_opt_leaves(params, opt))})
    arrays["step"] = np.asarray(step)
    tmp = path + ".tmp.npz"  # np.savez appends .npz unless present
    np.savez(tmp, **arrays)
    os.replace(tmp, path)  # atomic publish


def load_checkpoint(path: str, params: Dict[str, torch.Tensor], opt: torch.optim.Adam) -> int:
    """Inverse of save_checkpoint, and the reader of the JAX package's
    checkpoints: sets `params` in place and the Adam state of `opt`
    (optax's count, mu, nu -> torch's step, exp_avg, exp_avg_sq); returns
    the step to resume from."""
    keys = sorted(params)
    with np.load(path) as z:
        step = int(z["step"])
        with torch.no_grad():
            for k in params:
                params[k].copy_(torch.as_tensor(z[f"param:{k}"]))
        count = int(z["opt:0"])
        for i, k in enumerate(keys):
            p = params[k]
            mu = torch.as_tensor(z[f"opt:{1 + i}"], device=p.device)
            nu = torch.as_tensor(z[f"opt:{1 + len(keys) + i}"], device=p.device)
            opt.state[p] = {"step": torch.tensor(float(count)), "exp_avg": mu.clone(),
                            "exp_avg_sq": nu.clone()}
    return step


def fit(scene: Scene, cam: camera_mod.CameraData, target, width: int, height: int,
        spp: int = 4, max_depth: int = 6, param_paths: Iterable[str] = DEFAULT_PARAMS,
        steps: int = 100, learning_rate: float = 1e-2, checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 25, log_every: int = 10, log=print, engine: str = "cuda",
        cam_spec: Optional[Dict] = None, stratify: bool = False, intersector: str = "brute"):
    """Fit the named scene parameters to a target image (mean radiance
    `[H, W, 3]`).

    Returns (fitted_scene, losses), or (fitted_scene, losses,
    fitted_cam_spec) when `cam_spec` is given; include "camera.origin" /
    "camera.look_at" / "camera.vfov" in `param_paths` to fit the camera.
    If `checkpoint_path` exists, training resumes from it (step counter,
    params, Adam moments). `losses[k]` is the loss before update k."""
    param_paths = tuple(param_paths)
    cam_keys = [p for p in param_paths if p.startswith("camera.")]
    if cam_keys and cam_spec is None:
        raise ValueError("camera.* param_paths require cam_spec")
    dev = scene.device
    if cam_spec is not None:
        cam_spec = {k: (v if k == "vfov" else _f32(v, dev)) for k, v in cam_spec.items()}
        cam_spec.setdefault("vfov", camera_mod.DEFAULT_VFOV)
    loss_fn = render_loss_fn(scene, cam, target, width, height, spp, max_depth,
                             engine=engine, cam_spec=cam_spec, stratify=stratify,
                             intersector=intersector)

    params = {p: v.detach().clone().requires_grad_() for p, v in extract_params(
        scene, [p for p in param_paths if not p.startswith("camera.")]).items()}
    for p in cam_keys:
        params[p] = _f32(cam_spec[p[len("camera."):]], dev).clone().requires_grad_()
    opt = torch.optim.Adam([params[k] for k in sorted(params)], lr=learning_rate,
                           eps=ADAM_EPS)
    start_step = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        start_step = load_checkpoint(checkpoint_path, params, opt)
        log(f"resumed from {checkpoint_path} at step {start_step}")

    losses = []
    for step in range(start_step, steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        losses.append(float(loss.detach()))
        if log_every and step % log_every == 0:
            log(f"step {step}\tloss {losses[-1]:.6g}")
        if checkpoint_path and checkpoint_every and (step + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, step + 1, params, opt)

    if checkpoint_path:
        save_checkpoint(checkpoint_path, steps, params, opt)
    fitted = {k: v.detach() for k, v in params.items()}
    fitted_scene = apply_params(scene, {k: v for k, v in fitted.items()
                                        if not k.startswith("camera.")})
    if cam_spec is not None:
        spec = dict(cam_spec)
        spec.update({p[len("camera."):]: fitted[p] for p in cam_keys})
        return fitted_scene, losses, spec
    return fitted_scene, losses
