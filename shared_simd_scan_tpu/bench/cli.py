"""CLI entry point (E1: src/main.cpp:12-103).

Usage (mirrors the reference's positional convention, ``_`` = default):

    python -m shared_simd_scan_tpu.bench [data_size] [repetitions] [bench] [args]

    data_size    packed payload bytes (suffixes k/m/g), default 500m
    repetitions  timing trials, default 5
    bench        memory | decompression | scan | sharedscan | pack |
                 linear | member | conj | aggregate | histogram |
                 scaling | all
    args         sharedscan/linear/member/aggregate/scaling: predicate
                 count k (default 8); conj: column count m (default 2)
                 histogram: key count k (default: full domain, <= 4096)

With no arguments the full default suite runs, with sharedscan at
data_size/8 — exactly the reference's no-arg behavior (main.cpp:75-102).
Extra keyword flag: ``--width=W`` (default 9) — the reference's
compile-time BITS_NEEDED becomes a runtime arg triggering jit
specialization (SURVEY.md §5.6).
"""
from __future__ import annotations

import sys

import jax

from shared_simd_scan_tpu.bench import harness
from shared_simd_scan_tpu.utils.cache import enable_compile_cache


def parse_size(s: str) -> int:
    """'512m' / '64k' / '2g' / plain bytes -> int (shared by the bench
    scripts — the one home of the suffix rule)."""
    s = s.lower()
    mult = 1
    if s and s[-1] in "kmg":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[s[-1]]
        s = s[:-1]
    return int(s) * mult


_parse_size = parse_size


def _usage() -> str:
    return __doc__


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    width = harness.DEFAULT_WIDTH
    for a in list(argv):
        if a.startswith("--width="):
            width = int(a.split("=", 1)[1])
            argv.remove(a)

    data_size = harness.DEFAULT_DATA_SIZE
    reps = harness.DEFAULT_REPETITIONS
    bench = None
    bench_args: list[str] = []

    try:
        if argv:
            if argv[0] not in ("_",):
                data_size = _parse_size(argv[0])
            if len(argv) > 1 and argv[1] != "_":
                reps = int(argv[1])
            if len(argv) > 2:
                bench = argv[2]
                bench_args = argv[3:]
    except ValueError as e:
        print(_usage())
        print(f"error: {e}", file=sys.stderr)
        return 1

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"# shared_simd_scan_tpu bench on {dev.device_kind} "
          f"({len(jax.devices())} device(s)); width={width}, "
          f"data_size={data_size}, reps={reps}")

    if bench is None:
        print(_usage())
        print("## memory")
        harness.bench_memory(data_size, reps)
        print("## decompression")
        harness.bench_decompression(data_size, reps, width)
        print("## scan")
        harness.bench_scan(data_size, reps, width)
        print("## sharedscan")
        harness.bench_shared_scan(data_size // 8, reps, 8, width)
        return 0

    if bench == "memory":
        harness.bench_memory(data_size, reps)
    elif bench == "decompression":
        harness.bench_decompression(data_size, reps, width)
    elif bench == "scan":
        harness.bench_scan(data_size, reps, width)
    elif bench == "sharedscan":
        k = int(bench_args[0]) if bench_args else 8
        harness.bench_shared_scan(data_size, reps, k, width)
    elif bench == "pack":
        harness.bench_pack(data_size, reps, width)
    elif bench == "linear":
        k = int(bench_args[0]) if bench_args else 8
        harness.bench_linear(data_size, reps, k, width)
    elif bench == "member":
        k = int(bench_args[0]) if bench_args else 8
        harness.bench_member(data_size, reps, k, width)
    elif bench == "conj":
        m = int(bench_args[0]) if bench_args else 2
        harness.bench_conj(data_size, reps, m, width)
    elif bench == "aggregate":
        k = int(bench_args[0]) if bench_args else 8
        harness.bench_aggregate(data_size, reps, k, width)
    elif bench == "histogram":
        k = int(bench_args[0]) if bench_args else None
        harness.bench_histogram(data_size, reps, k, width)
    elif bench == "scaling":
        from shared_simd_scan_tpu.bench.scaling import bench_scaling

        k = int(bench_args[0]) if bench_args else 8
        bench_scaling(data_size // 8, reps, k, width)
    elif bench == "all":
        harness.bench_memory(data_size, reps)
        harness.bench_decompression(data_size, reps, width)
        harness.bench_scan(data_size, reps, width)
        harness.bench_shared_scan(data_size // 8, reps, 8, width)
        harness.bench_pack(data_size, reps, width)
    else:
        print(_usage())
        print(f"error: unknown bench '{bench}'", file=sys.stderr)
        return 1
    return 0
