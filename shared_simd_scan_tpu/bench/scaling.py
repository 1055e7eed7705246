"""Multi-device weak-scaling benchmark of the sharded shared scan.

Runs ``parallel.dist.sharded_shared_scan`` over meshes of 1, 2, 4, ... up
to all available devices, holding the per-device shard size constant (the
production regime: more devices scan a bigger column in the same time).
For each mesh size prints aggregate bytes/s and the per-device
efficiency vs the 1-device run.  Under ``jax.distributed.initialize`` the
same code spans every process's devices.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from shared_simd_scan_tpu import layout
from shared_simd_scan_tpu.bench import harness
from shared_simd_scan_tpu.bench.timing import measure
from shared_simd_scan_tpu.ops import unpack as unpack_ops
from shared_simd_scan_tpu.parallel import dist


def bench_scaling(
    per_device_data_size: int = 64 * 1024 * 1024,
    reps: int = 3,
    k: int = 8,
    width: int = harness.DEFAULT_WIDTH,
):
    """-> [(devices, bytes/s, efficiency vs 1 device)] for traced keys
    (one compiled program per mesh, the query-stream shape)."""
    devices = jax.devices()
    roof = harness._roofline()
    sizes = []
    d = 1
    while d <= len(devices):
        sizes.append(d)
        d *= 2
    base_bps = None
    results = []
    for nd in sizes:
        mesh = dist.make_mesh(devices[:nd])
        n = harness.values_for(per_device_data_size * nd, width)
        dev = unpack_ops.pack_device_kernel(harness.synth_modk(n, k, width), width)
        sdev = dist.shard_column(dev, mesh)
        keys = jnp.arange(k, dtype=jnp.uint32)
        traffic = layout.packed_nbytes(width, n) + k * layout.bitvector_words(n) * 4
        fn = jax.jit(lambda kv, sdev=sdev, mesh=mesh: dist.sharded_shared_scan(
            sdev, kv, mesh))
        meas = measure(fn, keys, reps=reps)
        bps = traffic / meas.seconds
        base_bps = base_bps or bps
        eff = bps / (base_bps * nd)
        res = harness.BenchResult(
            f"sharded shared scan k={k} on {nd} device(s)", meas, traffic
        )
        harness.print_result(res, roof * nd if roof else None)
        print(f"    scaling efficiency vs 1 device: {100 * eff:.1f}%")
        results.append((nd, bps, eff))
    return results
