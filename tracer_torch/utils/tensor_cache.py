"""Host values made from tensors (a tree's packed records, its depth, a
scene's material flags), kept while the tensors live and are not changed
in place, so that a cached call reads nothing from the device."""

from __future__ import annotations

import weakref

_CACHE = []  # (weak refs to the tensors, their versions, key, value), newest last
_CACHE_MAX = 8


def cached(tensors, key, make):
    """make(), cached while `tensors` live and are not changed in place (an
    inference tensor has no version to key on: made anew every call)."""
    if any(t.is_inference() for t in tensors):
        return make()
    versions = tuple(t._version for t in tensors)
    for i, (refs, vers, k, value) in enumerate(_CACHE):
        if k == key and vers == versions and all(r() is t for r, t in zip(refs, tensors)):
            _CACHE.append(_CACHE.pop(i))
            return value
    value = make()
    _CACHE.append((tuple(weakref.ref(t) for t in tensors), versions, key, value))
    del _CACHE[:-_CACHE_MAX]
    return value
