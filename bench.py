"""Shared-scan benchmark on one GPU: 9-bit column, 8 consecutive keys.

    python bench.py

Times ``shared_scan_device`` (the public call: tier, counts and canonical
bitvectors) on a 512 MiB packed column with ``block_until_ready`` on the
host clock, verifies every count and bitvector word first, and measures a
plain-XLA copy of the same footprint in the same run.  Prints ONE JSON
line naming the device kind and its power limit:

  {"metric": ..., "value": bytes/s, "unit": ..., "device": {...},
   "power_limit": "...", "peak_bytes_per_s": N,
   "measured_copy_bytes_per_s": N, "vs_measured_copy": N}

value = packed column read + k bitvectors written, per second, on the
host clock (launch and sync included, so no roofline share is claimed).
``peak_bytes_per_s`` is the datasheet figure from bench.harness.HBM_PEAK
(an unknown device kind is an error).
Needs a GPU: it exits non-zero on any other platform.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from shared_simd_scan_tpu import layout
from shared_simd_scan_tpu.bench import harness
from shared_simd_scan_tpu.bench.timing import measure
from shared_simd_scan_tpu.ops import scan as scan_ops
from shared_simd_scan_tpu.ops import unpack as unpack_ops
from shared_simd_scan_tpu.utils.cache import enable_compile_cache

WIDTH = 9
K = 8
DATA_SIZE = 512 * 1024 * 1024  # packed payload bytes
METRIC = "shared_scan_9bit_k8_bytes_per_s"


def main() -> int:
    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        print(f"bench.py needs a GPU, JAX found {dev0.platform!r}", file=sys.stderr)
        return 2
    enable_compile_cache()
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    n = harness.values_for(DATA_SIZE, WIDTH)
    vals = harness.synth_modk(n, K, WIDTH)
    dev = unpack_ops.pack_device_kernel(vals, WIDTH)
    keys = jnp.arange(K, dtype=jnp.uint32)
    fn = jax.jit(lambda t: scan_ops.shared_scan_device(
        layout.DeviceColumn(WIDTH, n, t), np.arange(K, dtype=np.uint32)))
    if not harness.check_shared_scan(dev, keys, vals, *fn(dev.tiles)):
        print(json.dumps({"metric": METRIC, "value": 0, "error": "verification failed"}))
        return 1
    del vals
    traffic = layout.packed_nbytes(WIDTH, n) + K * layout.bitvector_words(n) * 4
    bps = traffic / measure(fn, dev.tiles, reps=10).seconds
    copy = harness.bench_memory(DATA_SIZE, 10)
    peak = harness.hbm_peak_bytes_per_s(dev0.device_kind)
    print(json.dumps({
        "metric": METRIC,
        "value": round(bps),
        "unit": "bytes/s/device",
        "device": {"platform": dev0.platform, "kind": dev0.device_kind,
                   "count": len(jax.devices())},
        "power_limit": power,
        "peak_bytes_per_s": peak,
        "measured_copy_bytes_per_s": round(copy.bytes_per_s),
        "vs_measured_copy": round(bps / copy.bytes_per_s, 4),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
