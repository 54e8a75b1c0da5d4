"""Debug-mode guards: NaN/Inf detection for render and gradient paths
(port of tracer/utils/debug.py).

What can go wrong on a vector machine is silent NaN poisoning through
masked lanes (0 * inf in reverse mode, see geometry/sphere.py); these
helpers make it loud.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped `torch.autograd.set_detect_anomaly(enable, check_nan=True)`,
    the nearest counterpart of `jax_debug_nans`: a backward function that
    returns NaN raises, naming the forward operation that made it. It
    checks the BACKWARD only: a NaN made in the forward passes unnoticed
    (use check_finite on the forward's outputs)."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield


def _leaves(tree, path=""):
    """(path, leaf) of every leaf of dataclasses, NamedTuples, dicts, lists
    and tuples, paths spelled as jax.tree_util.keystr spells them
    (`.field`, `['key']`, `[i]`)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def check_finite(tree, name: str = "value") -> None:
    """Raise FloatingPointError naming the first float leaf of `tree` (a
    tensor, an array, or dataclasses, NamedTuples, dicts and sequences of
    them) that holds a NaN or an infinity, and how many it holds."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
        else:
            arr = np.asarray(leaf)
            if arr.dtype.kind != "f":
                continue
            t = torch.from_numpy(np.ascontiguousarray(arr))
        if not t.is_floating_point():
            continue
        bad = int((~torch.isfinite(t)).sum())
        if bad:
            raise FloatingPointError(f"{name}{path}: {bad}/{t.numel()} non-finite values")


def check_framebuffer(fb, name: str = "framebuffer") -> None:
    """Sanity for raw sample sums (a tensor or an array): finite and
    non-negative."""
    arr = fb.detach().cpu().numpy() if isinstance(fb, torch.Tensor) else np.asarray(fb)
    if not np.isfinite(arr).all():
        raise FloatingPointError(f"{name}: non-finite pixels")
    if (arr < 0).any():
        raise FloatingPointError(f"{name}: negative radiance")
