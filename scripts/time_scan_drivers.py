"""Time the XLA and the Triton scan drivers on the card, end to end.

Each configuration runs the public tier call (tier + count reduction +
canonical reshape, one jitted program) under both drivers on a 9-bit
column of 477,218,588 values (512 MiB packed), checks the Triton result
bit-exact against the XLA one, and prints one JSON line per (config,
driver) with the median wall time of ``--reps`` calls.

    python scripts/time_scan_drivers.py [--n N] [--reps R] [--seed S]

Needs a GPU (the Triton driver is compiled only there).
"""
from __future__ import annotations

import argparse
import functools
import json
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from shared_simd_scan_tpu.ops import scan  # noqa: E402
from shared_simd_scan_tpu.ops.unpack import pack_device_kernel  # noqa: E402
from shared_simd_scan_tpu.utils.cache import enable_compile_cache  # noqa: E402

WIDTH = 9
SPREAD8 = np.array([3, 70, 141, 212, 283, 354, 425, 496], np.uint32)


def spread(k):
    return ((np.arange(k, dtype=np.uint32) * 61 + 3) % (1 << WIDTH)).astype(np.uint32)


# Key counts timed per tier: the driver trial's k=8 (k=1 for compare),
# the powers of two up to the old caps and the non-powers of two between.
KEY_COUNTS = {
    "interval": (8, 24, 32, 33, 48, 64),
    "static_dag": (8, 20, 32, 33, 48, 64),
    "traced_bitsliced": (8, 20, 32, 33),
    "compare": (1, 2, 4, 8),
}


def configs(w, n):
    """config name -> call(tiles, backend)."""
    calls = {
        "interval": lambda t, be, k: scan.interval_scan_tiles(t, 0, k, w, n, backend=be),
        "static_dag": lambda t, be, k: scan.shared_scan_bitsliced_static_tiles(
            t, SPREAD8 if k == 8 else spread(k), w, n, backend=be),
        "traced_bitsliced": lambda t, be, k: scan.shared_scan_bitsliced_tiles(
            t, jnp.asarray(SPREAD8 if k == 8 else spread(k)), w, n, backend=be),
        "compare": lambda t, be, k: scan.shared_scan_tiles(
            t, jnp.asarray(spread(k) + 2), w, n, backend=be),
    }
    return {
        f"{tier}_k{k}": functools.partial(calls[tier], k=k)
        for tier, ks in KEY_COUNTS.items() for k in ks
    }


def histogram_variants(w, n):
    """Full-domain histogram: one static AND-DAG over 512 keys vs the
    traced-lo 32-key window form mapped over the domain (both XLA)."""
    return {
        "dag": lambda t: scan._histogram_dag_impl(t, 0, lo=0, k=512, width=w, n=n),
        "window": lambda t: scan.histogram_tiles(t, jnp.uint32(0), 512, w, n),
    }


def timed(fn, tiles, reps):
    out = fn(tiles)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(tiles)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return out, statistics.median(ts), min(ts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=477_218_588)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="", help="comma list of configs")
    args = ap.parse_args(argv)
    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        print("no GPU: the Triton driver compiles only on the card", file=sys.stderr)
        return 2
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    vals = jax.random.bits(jax.random.key(args.seed), (args.n,), jnp.uint32)
    vals = vals & jnp.uint32((1 << WIDTH) - 1)
    col = pack_device_kernel(vals, WIDTH)
    del vals
    tiles = jax.block_until_ready(col.tiles)
    n = col.n
    sel = [c for c in args.only.split(",") if c]
    for name, call in configs(WIDTH, n).items():
        if sel and name not in sel:
            continue
        ref = None
        for be in ("xla", "triton"):
            fn = jax.jit(lambda t, be=be, call=call: (
                lambda r: (scan.bits_to_canonical(r[0], n), r[1]))(call(t, be)))
            rec = {"config": name, "driver": be, "n": n, "card": card}
            try:
                t0 = time.perf_counter()
                fn.lower(tiles).compile()
                rec["compile_s"] = round(time.perf_counter() - t0, 3)
                out, med, best = timed(fn, tiles, args.reps)
            except Exception as e:  # noqa: BLE001 — report and go on
                rec["error"] = f"{type(e).__name__}: {str(e)[:400]}"
                print(json.dumps(rec), flush=True)
                continue
            rec["median_ms"] = round(med * 1e3, 4)
            rec["min_ms"] = round(best * 1e3, 4)
            if ref is None:
                ref = jax.device_get(out)
                rec["counts"] = [int(c) for c in ref[1]]
            else:
                got = jax.device_get(out)
                rec["bit_exact_vs_xla"] = bool(
                    np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
                )
            print(json.dumps(rec), flush=True)
    if not sel or "histogram_k512" in sel:
        hist = {}
        for form, call in histogram_variants(WIDTH, n).items():
            fn = jax.jit(call)
            rec = {"config": "histogram_k512", "driver": f"xla-{form}", "n": n,
                   "card": card}
            t0 = time.perf_counter()
            fn.lower(tiles).compile()
            rec["compile_s"] = round(time.perf_counter() - t0, 3)
            out, med, best = timed(fn, tiles, args.reps)
            rec["median_ms"] = round(med * 1e3, 4)
            rec["min_ms"] = round(best * 1e3, 4)
            hist[form] = np.asarray(out)
            rec["equal_forms"] = bool(all(np.array_equal(h, hist[form])
                                          for h in hist.values()))
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
