"""Host-clock timing of device calls.

The reference times kernels with a host ns stopwatch around each call
(src/profiling.cpp:6-13 ``_clock``; src/benchmark.cpp:63-68).  Device calls
return before the device finishes, so every timed call here ends in
``jax.block_until_ready``; the first call (compilation) is warm-up and is
not timed.  Kernel device times and idle shares come from a profiler
trace, not from this module.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import jax


@dataclasses.dataclass
class Measurement:
    """Median wall time per call plus the raw samples."""

    seconds: float        # median seconds per call
    samples: list[float]  # seconds of each timed call

    @property
    def millis(self) -> float:
        return self.seconds * 1e3


def measure(fn: Callable, *args, reps: int = 10) -> Measurement:
    """Warm up ``fn(*args)`` once, then time ``reps`` calls, each ending
    in ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return Measurement(statistics.median(samples), samples)
