"""Device profiling helpers (SURVEY.md §7 "Tracing / profiling").

``trace`` wraps ``jax.profiler`` for Perfetto traces; ``device_timer``
measures steady-state time of a jitted callable, fetching one output leaf
to the host per repetition so the timed region ends after the device
work.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a Perfetto/XPlane trace of the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _touch(out) -> None:
    leaf = jax.tree.leaves(out)[0]
    np.asarray(jax.device_get(leaf))


def device_timer(fn: Callable, *args, reps: int = 5, warmup: int = 1) -> float:
    """Median seconds per call of ``fn(*args)`` with forced materialization."""
    for _ in range(warmup):
        _touch(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.time()
        _touch(fn(*args))
        times.append(time.time() - t0)
    return sorted(times)[len(times) // 2]
