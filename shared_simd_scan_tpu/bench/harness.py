"""Benchmark drivers: data synthesis, timing of the public entry points,
verification.

Counterpart of the reference benchmark harness:
  - result printer ``* name: avg ms; [..] ms``  (src/benchmark.cpp:14-36)
  - verifiers run after timing                   (src/benchmark.cpp:38-140)
  - decompression / scan / shared-scan drivers   (src/benchmark.cpp:51-306)
  - raw memory-bandwidth comparator              (src/benchmark_misc.cpp:9-52)

plus bytes/s and %-of-peak columns (SURVEY.md §5.5).  Every driver times a
public call (ops.*, query, stats) with ``bench.timing.measure``; the copy
comparator is plain XLA.  Metric design (cells, trace-derived kernel
times, idle shares) belongs to the benchmark, not to this module.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from shared_simd_scan_tpu import layout
from shared_simd_scan_tpu.bench.timing import Measurement, measure
from shared_simd_scan_tpu.layout import packed_nbytes
from shared_simd_scan_tpu.ops import aggregate as agg_ops
from shared_simd_scan_tpu.ops import conj as conj_ops
from shared_simd_scan_tpu.ops import member as member_ops
from shared_simd_scan_tpu.ops import scan as scan_ops
from shared_simd_scan_tpu.ops import unpack as unpack_ops

# Default workload: 500 MiB packed payload, shared scan at 1/8 of that —
# mirrors the reference defaults (src/benchmark.hpp:4-5, src/main.cpp:98).
DEFAULT_DATA_SIZE = 500 * 1024 * 1024
DEFAULT_REPETITIONS = 5
DEFAULT_WIDTH = 9

# Published peak device-memory bandwidth by ``device_kind`` (bytes/s).
# NVIDIA H100 SXM5 80 GB: 3.35 TB/s (NVIDIA H100 Tensor Core GPU
# datasheet), at its full 700 W power limit.
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_peak_bytes_per_s(kind: str | None = None) -> float:
    """Peak device-memory bandwidth of ``kind`` (default: device 0).
    A device missing from :data:`HBM_PEAK` is an error, not a default."""
    kind = jax.devices()[0].device_kind if kind is None else kind
    if kind not in HBM_PEAK:
        raise KeyError(
            f"no published memory bandwidth for device kind {kind!r}; "
            "add it to bench.harness.HBM_PEAK with its source"
        )
    return HBM_PEAK[kind]


# ---------------------------------------------------------------------------
# Result printer (B1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BenchResult:
    name: str
    meas: Measurement
    bytes_moved: int  # device-memory traffic per call (read + write)

    @property
    def bytes_per_s(self) -> float:
        return self.bytes_moved / self.meas.seconds


def print_result(res: BenchResult, roofline: float | None = None) -> None:
    """Stable machine-parsable line format, identical shape to the
    reference's (src/benchmark.cpp:14-36)."""
    reps = ", ".join(f"{t * 1e3:.6f}" for t in res.meas.samples)
    print(f"* {res.name}: {res.meas.millis:.6f} ms; [{reps}] ms")
    gbs = res.bytes_per_s / 1e9
    if roofline:
        pct = 100.0 * res.bytes_per_s / roofline
        print(f"    {gbs:.1f} GB/s ({pct:.1f}% of {roofline / 1e9:.0f} GB/s peak)")
    else:
        print(f"    {gbs:.1f} GB/s")


def _roofline() -> float | None:
    dev = jax.devices()[0]
    return hbm_peak_bytes_per_s(dev.device_kind) if dev.platform == "gpu" else None


def _report(name, fn, args, traffic, reps):
    res = BenchResult(name, measure(fn, *args, reps=reps), traffic)
    print_result(res, _roofline())
    return res


# ---------------------------------------------------------------------------
# Data synthesis (reference corpora, src/benchmark.cpp:79-82, 170-174, 274-278)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n", "width"))
def synth_ramp(n: int, width: int) -> jax.Array:
    """Decompression corpus: ``i & ((1<<width)-1)`` (benchmark.cpp:79-82)."""
    return jnp.arange(n, dtype=jnp.uint32) & jnp.uint32((1 << width) - 1)


@functools.partial(jax.jit, static_argnames=("n",))
def synth_mod5(n: int) -> jax.Array:
    """Scan corpus: ``i % 5``, predicate key 3 (benchmark.cpp:150, 174)."""
    return jnp.arange(n, dtype=jnp.uint32) % jnp.uint32(5)


@functools.partial(jax.jit, static_argnames=("n", "k", "width"))
def synth_modk(n: int, k: int, width: int) -> jax.Array:
    """Shared-scan corpus: ``i % k % (1<<width adjusted)``
    (benchmark.cpp:277 uses ``i % k % 512``)."""
    m = min(512, 1 << width)
    return jnp.arange(n, dtype=jnp.uint32) % jnp.uint32(k) % jnp.uint32(m)


def values_for(data_size: int, width: int) -> int:
    """Value count whose packed payload is ~data_size bytes."""
    return max((data_size * 8) // width, layout.BLOCK_VALUES)


def _column(data_size, width, synth):
    n = values_for(data_size, width)
    vals = synth(n)
    return vals, unpack_ops.pack_device_kernel(vals, width)


# ---------------------------------------------------------------------------
# Verifiers (B2: src/benchmark.cpp:38-140) — run after timing
# ---------------------------------------------------------------------------


def check_decompression(dev: layout.DeviceColumn, expect: jax.Array) -> bool:
    ok = bool(jnp.all(unpack_ops.unpack_device(dev) == expect))
    if not ok:
        print("    VERIFY FAILED: decompression mismatch")
    return ok


def check_shared_scan(
    dev: layout.DeviceColumn, keys, vals: jax.Array, bits=None, counts=None
) -> bool:
    """Every count and every bitvector word against a direct compare of
    the values (``bits``/``counts``: a result to check; default: run
    ``shared_scan_device``)."""
    if bits is None:
        bits, counts = scan_ops.shared_scan_device(dev, keys)
    keys = np.asarray(keys, np.uint32)
    ok = True
    for j, key in enumerate(keys.tolist()):
        match = vals == jnp.uint32(key)
        ok = ok and int(counts[j]) == int(jnp.sum(match, dtype=jnp.uint32))
        want = _pack_bits(match)
        ok = ok and bool(jnp.all(bits[j] == want))
        if not ok:
            break
    if not ok:
        print("    VERIFY FAILED: shared scan mismatch")
    return ok


@jax.jit
def _pack_bits(match: jax.Array) -> jax.Array:
    """bool (n,) -> LSB-first uint32 words (ceil(n/32),)."""
    n = match.shape[0]
    w = layout.bitvector_words(n)
    m = jnp.zeros(w * 32, jnp.uint32).at[:n].set(match.astype(jnp.uint32))
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(m.reshape(w, 32) << shifts, axis=1, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# Benchmark drivers (B3-B6)
# ---------------------------------------------------------------------------


@jax.jit
def _copy(x):
    return x + jnp.uint32(1)


def bench_memory(data_size: int = DEFAULT_DATA_SIZE, reps: int = DEFAULT_REPETITIONS):
    """Same-run copy comparator (the reference's memcpy row,
    benchmark_misc.cpp:9-52): one plain-XLA read+write pass."""
    buf = jnp.zeros(data_size // 4, jnp.uint32)
    return _report("copy (XLA elementwise)", _copy, (buf,), 2 * buf.nbytes, reps)


def bench_decompression(data_size=DEFAULT_DATA_SIZE, reps=DEFAULT_REPETITIONS,
                        width=DEFAULT_WIDTH):
    vals, dev = _column(data_size, width, lambda n: synth_ramp(n, width))
    fn = jax.jit(lambda t: unpack_ops.unpack_device(layout.DeviceColumn(width, dev.n, t)))
    res = _report(f"unpack w={width}", fn, (dev.tiles,),
                  packed_nbytes(width, dev.n) + 4 * dev.n, reps)
    check_decompression(dev, vals)
    return res


def bench_pack(data_size=DEFAULT_DATA_SIZE, reps=DEFAULT_REPETITIONS,
               width=DEFAULT_WIDTH):
    n = values_for(data_size, width)
    vals = synth_ramp(n, width)
    fn = jax.jit(lambda v: unpack_ops.pack_device_kernel(v, width).tiles)
    return _report(f"pack w={width}", fn, (vals,),
                   4 * n + packed_nbytes(width, n), reps)


def _shared_traffic(width, n, k):
    return packed_nbytes(width, n) + k * layout.bitvector_words(n) * 4


def bench_scan(data_size=DEFAULT_DATA_SIZE, reps=DEFAULT_REPETITIONS,
               width=DEFAULT_WIDTH):
    vals, dev = _column(data_size, width, synth_mod5)
    fn = jax.jit(lambda t: scan_ops.scan_device(layout.DeviceColumn(width, dev.n, t), 3))
    res = _report(f"scan w={width} key=3", fn, (dev.tiles,),
                  _shared_traffic(width, dev.n, 1), reps)
    bits, count = fn(dev.tiles)
    check_shared_scan(dev, [3], vals, bits[None], count[None])
    return res


def bench_shared_scan(data_size=DEFAULT_DATA_SIZE, reps=DEFAULT_REPETITIONS,
                      k=8, width=DEFAULT_WIDTH):
    """k consecutive keys (the reference's predicate set 0..k-1), k spread
    concrete keys and k traced keys, each through shared_scan_device."""
    vals, dev = _column(data_size, width, lambda n: synth_modk(n, k, width))
    dom = 1 << width
    sets = {
        "consecutive": np.arange(k, dtype=np.uint32) % dom,
        "spread": (np.arange(k, dtype=np.uint32) * 61 + 3) % dom,
    }
    out = []
    for name, keys in sets.items():
        fn = jax.jit(lambda t, keys=keys: scan_ops.shared_scan_device(
            layout.DeviceColumn(width, dev.n, t), keys))
        out.append(_report(f"shared scan k={k} {name}", fn, (dev.tiles,),
                           _shared_traffic(width, dev.n, k), reps))
        check_shared_scan(dev, keys, vals, *fn(dev.tiles))
    traced = jax.jit(lambda t, kv: scan_ops.shared_scan_device(
        layout.DeviceColumn(width, dev.n, t), kv))
    kv = jnp.asarray(sets["spread"])
    out.append(_report(f"shared scan k={k} traced", traced, (dev.tiles, kv),
                       _shared_traffic(width, dev.n, k), reps))
    return out


def bench_linear(data_size=DEFAULT_DATA_SIZE, reps=DEFAULT_REPETITIONS, k=8,
                 width=DEFAULT_WIDTH):
    vals, dev = _column(data_size, width, lambda n: synth_modk(n, k, width))
    keys = np.arange(k, dtype=np.uint32)
    fn = jax.jit(lambda t: scan_ops.shared_scan_linear_device(
        layout.DeviceColumn(width, dev.n, t), keys))
    nbytes = (dev.n + 7) // 8
    return _report(f"linear export k={k}", fn, (dev.tiles,),
                   packed_nbytes(width, dev.n) + nbytes * k, reps)


def bench_member(data_size=DEFAULT_DATA_SIZE, reps=DEFAULT_REPETITIONS, k=8,
                 width=DEFAULT_WIDTH):
    vals, dev = _column(data_size, width, lambda n: synth_ramp(n, width))
    keys = (np.arange(k, dtype=np.uint32) * 61 + 3) % (1 << width)
    fn = jax.jit(lambda t: member_ops.member_scan_device(
        layout.DeviceColumn(width, dev.n, t), keys))
    return _report(
        f"member k={k} ({member_ops.member_dispatch_tier(keys, width)})", fn,
        (dev.tiles,), _shared_traffic(width, dev.n, 1), reps)


def bench_conj(data_size=DEFAULT_DATA_SIZE, reps=DEFAULT_REPETITIONS, m=2,
               width=DEFAULT_WIDTH):
    vals, dev = _column(data_size // m, width, lambda n: synth_ramp(n, width))
    lows = np.full(m, 10, np.uint32)
    highs = np.full(m, 300, np.uint32)
    fn = jax.jit(lambda t: conj_ops.conj_range_scan_device(
        [layout.DeviceColumn(width, dev.n, t)] * m, lows, highs))
    return _report(f"conj m={m}", fn, (dev.tiles,),
                   m * packed_nbytes(width, dev.n) + layout.bitvector_words(dev.n) * 4,
                   reps)


def bench_aggregate(data_size=DEFAULT_DATA_SIZE, reps=DEFAULT_REPETITIONS, k=8,
                    width=DEFAULT_WIDTH):
    _, pdev = _column(data_size // 2, width, lambda n: synth_modk(n, k, width))
    mvals = synth_ramp(pdev.n, 16)
    mdev = unpack_ops.pack_device_kernel(mvals, 16)
    keys = np.arange(k, dtype=np.uint32)
    tier = agg_ops.pick_aggregate_tier(width, 16, keys)
    if tier == "bitplane":
        fn = jax.jit(lambda p, m: agg_ops.aggregate_bitplane_static_tiles(
            p, m, keys, width, 16, pdev.n))
    else:
        fn = jax.jit(lambda p, m: agg_ops.aggregate_scan_tiles(
            p, m, keys, width, 16, pdev.n))
    return _report(f"aggregate k={k} ({tier})", fn, (pdev.tiles, mdev.tiles),
                   packed_nbytes(width, pdev.n) + packed_nbytes(16, pdev.n), reps)


def bench_histogram(data_size=DEFAULT_DATA_SIZE, reps=DEFAULT_REPETITIONS,
                    k=None, width=DEFAULT_WIDTH):
    _, dev = _column(data_size, width, lambda n: synth_ramp(n, width))
    k = k or min(1 << width, 4096)
    fn = jax.jit(lambda t: scan_ops.histogram_device(
        layout.DeviceColumn(width, dev.n, t), 0, k))
    return _report(f"histogram k={k}", fn, (dev.tiles,),
                   packed_nbytes(width, dev.n), reps)
