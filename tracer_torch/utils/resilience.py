"""Transient-failure resilience for long renders (port of
tracer/utils/resilience.py).

The reference binary has no failure handling (a CUDA fault kills the run,
src/main.cu). Long animations should ride through failures that are
TRANSIENT: a dropped or refused connection, a store or collective that
timed out, a backend that was briefly unavailable. `retry_transient`
retries those and re-raises everything else at once.

`TRANSIENT_MARKERS` holds tracer's markers (the JAX runtime's spellings)
and torch.distributed's spellings of the same conditions (gloo's dropped
connection and collective timeouts, the TCP store's timeouts). A CUDA
error is never transient: a faulted CUDA context is sticky, so every
later call in the same process fails too and a retry cannot succeed
(`torch.cuda.OutOfMemoryError` and any message naming a CUDA error or an
illegal address).
"""

from __future__ import annotations

import time
from typing import Callable, TypeVar

import torch

T = TypeVar("T")

TRANSIENT_MARKERS = (
    # tracer's (tracer/utils/resilience.py)
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "worker process crashed",
    "Connection reset",
    "Connection refused",
    "Socket closed",
    "ABORTED",
    # torch.distributed's: gloo's dropped connection
    "Connection closed by peer",
    "Socket unexpectedly closed",
    # gloo's collective timeouts ("Timed out waiting <n>ms for recv operation to complete")
    "for recv operation to complete",
    "for send operation to complete",
    # the TCP store's timeouts: a client's socket, a key wait, the rendezvous
    "Socket Timeout",
    "wait timeout after",
    "waiting for clients",
)
# a message with one of these is a CUDA fault, whatever else it says
CUDA_FAULT_MARKERS = ("CUDA error", "CUDA out of memory", "illegal memory access",
                      "illegal address", "cudaError")


def is_cuda_fault(err: BaseException) -> bool:
    """Does this exception come from a faulted (or out-of-memory) CUDA
    context? Such a fault is never retried."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    msg = str(err)
    return any(m in msg for m in CUDA_FAULT_MARKERS)


def is_transient(err: BaseException) -> bool:
    """Heuristic: does this exception look like a recoverable backend
    failure rather than a programming error or a CUDA fault?"""
    if is_cuda_fault(err):
        return False
    msg = str(err)
    return any(m in msg for m in TRANSIENT_MARKERS)


def retry_transient(
    fn: Callable[[], T],
    retries: int = 3,
    backoff_s: float = 5.0,
    backoff_factor: float = 2.0,
    on_retry: Callable[[int, BaseException], None] | None = None,
) -> T:
    """Run fn(), retrying up to `retries` times on transient errors with
    exponential backoff (`on_retry(attempt, err)` before each retry).
    Other errors and the last failure propagate unchanged."""
    delay = backoff_s
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as err:  # noqa: BLE001 - filtered by is_transient
            if attempt >= retries or not is_transient(err):
                raise
            if on_retry is not None:
                on_retry(attempt + 1, err)
            time.sleep(delay)
            delay *= backoff_factor
    raise AssertionError("unreachable")
