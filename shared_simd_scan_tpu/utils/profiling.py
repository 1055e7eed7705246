"""Timing + profiling (P1: reference src/profiling.{hpp,cpp}).

Three mechanisms, mirroring the reference's:
  1. ``clock_ns()`` — delta stopwatch (profiling.cpp:6-13 ``_clock``); note
     that host stopwatches only bound device work if the caller waits for
     results — device timing should use ``bench.timing.measure``.
  2. ``ProfileSample`` / ``profile_block`` — named accumulating sections
     with a global sample registry (profiling.cpp:15-52, the RAII
     ``ProfileSample`` and ``get_sample``), enabled at runtime via the
     ``SSS_PROFILING=1`` env var instead of a compile-time CMake flag
     (SURVEY.md §5.1).
  3. ``trace`` — a ``jax.profiler`` trace context producing TensorBoard /
     xprof dumps, the device analog of the reference's external
     profiler hooks (MSVC /Profile, callgrind).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import jax

_last_ns: int | None = None


def clock_ns() -> int:
    """Nanoseconds since the previous call (0 on the first call) —
    the reference's static-state delta timer semantics."""
    global _last_ns
    now = time.perf_counter_ns()
    if _last_ns is None:
        _last_ns = now
        return 0
    delta = now - _last_ns
    _last_ns = now
    return delta


def profiling_enabled() -> bool:
    return os.environ.get("SSS_PROFILING", "0") not in ("", "0", "false")


@dataclass
class _Sample:
    total_ns: int = 0
    count: int = 0

    @property
    def avg_ns(self) -> float:
        return self.total_ns / self.count if self.count else 0.0


_samples: dict[str, _Sample] = defaultdict(_Sample)


def get_sample(name: str) -> _Sample:
    """Accumulated sample for a named section (profiling.cpp ``get_sample``)."""
    return _samples[name]


def reset_samples() -> None:
    _samples.clear()


class ProfileSample:
    """Context manager accumulating wall time under a name; prints the
    running average on exit when profiling is enabled — the reference's
    RAII ``ProfileSample`` (profiling.cpp:25-29), as a ``with`` block."""

    def __init__(self, name: str, sync: bool = False):
        self.name = name
        self.sync = sync  # block on outstanding device work before stopping
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.sync:
            jax.effects_barrier()
        dt = time.perf_counter_ns() - self._t0
        s = _samples[self.name]
        s.total_ns += dt
        s.count += 1
        if profiling_enabled():
            print(f"[profile] {self.name}: {dt / 1e6:.3f} ms "
                  f"(avg {s.avg_ns / 1e6:.3f} ms over {s.count})")
        return False


@contextlib.contextmanager
def profile_block(name: str):
    """PROFILE_BLOCK_START/END macro analog (profiling.hpp:33-48): a no-op
    unless SSS_PROFILING is set."""
    if not profiling_enabled():
        yield
        return
    with ProfileSample(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/sss_trace"):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
