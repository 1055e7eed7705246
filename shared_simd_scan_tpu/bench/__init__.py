"""Benchmark harness: timing, verification, drivers, CLI.

Counterpart of the reference's L5/L6 layers (src/benchmark.{hpp,cpp},
src/benchmark_misc.cpp, src/main.cpp — SURVEY.md §2.3 B1-B6/E1)."""

from shared_simd_scan_tpu.bench.timing import measure, Measurement  # noqa: F401
