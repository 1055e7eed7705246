"""Column statistics from one histogram pass: quantiles, top-k, describe.

Capability extension (the reference stops at match bitvectors): since the
value domain of a width-w column is tiny (2^w <= 2^31, and <= 4096 for
the single-pass histogram kernel), ORDER-statistics over billions of rows
reduce to one histogram pass (ops.scan.histogram_dag_tiles — the
shared-AND-DAG counts kernel) plus O(domain) host/XLA post-processing —
no sort, no second pass over n.

For widths > 12 the histogram kernel caps at 4096 buckets per call; the
helpers below loop the domain in 4096-value windows (2^w / 4096 passes,
still O(1) memory and read-bound per pass).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from shared_simd_scan_tpu.layout import DeviceColumn
from shared_simd_scan_tpu.ops.scan import histogram_dag_tiles, histogram_tiles

_WINDOW = 4096


def histogram_full(dev: DeviceColumn, mesh=None) -> np.ndarray:
    """Exact counts over the FULL domain (2^width,) as host numpy —
    one counts-only pass per 4096-value window.  With ``mesh`` the column must
    be block-axis sharded (dist.shard_column) and each pass psum-reduces
    over the devices."""
    if dev.width > 20:
        raise ValueError(
            f"histogram statistics need 2^width buckets; width {dev.width} "
            "would take 2^(w-12) passes — supported up to width 20 "
            "(256 passes)"
        )
    dom = 1 << dev.width
    parts = []
    for lo in range(0, dom, _WINDOW):
        k = min(_WINDOW, dom - lo)
        if mesh is not None:
            from shared_simd_scan_tpu.parallel import dist

            # jax-scalar lo past one window: one mask-window program for
            # every window (same compile-count rule as the local branch)
            lo_arg = lo if dom <= _WINDOW else jnp.uint32(lo)
            counts = dist.sharded_histogram(dev, mesh, lo=lo_arg, k=k)
        elif dom <= _WINDOW:
            # single window: the shared-AND-DAG form at a bounded
            # program count
            counts = histogram_dag_tiles(dev.tiles, lo, k, dev.width, dev.n)
        else:
            # width > 12: every 4096-value window would specialize its
            # own static-key DAG program (up to 256 windows) — the
            # traced-lo mask-window form compiles ONCE and serves every
            # window
            counts = histogram_tiles(
                dev.tiles, jnp.uint32(lo), k, dev.width, dev.n
            )
        parts.append(np.asarray(jax.device_get(counts)))
    return np.concatenate(parts).astype(np.uint64)


def quantiles(dev: DeviceColumn, qs, mesh=None) -> np.ndarray:
    """Exact empirical quantiles (lower interpolation: the smallest value
    v with rank(v) >= ceil(q * n)) for q in ``qs``."""
    counts = histogram_full(dev, mesh=mesh)
    cum = np.cumsum(counts)
    n = int(cum[-1])
    out = []
    for q in np.atleast_1d(np.asarray(qs, np.float64)):
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile out of range: {q}")
        rank = max(1, int(np.ceil(q * n))) if n else 0
        out.append(int(np.searchsorted(cum, rank)))
    return np.asarray(out, np.uint32)


def topk_values(
    dev: DeviceColumn, k: int, mesh=None
) -> tuple[np.ndarray, np.ndarray]:
    """The k most frequent values -> (values uint32 (k,), counts uint64),
    ordered by descending count (ties: smaller value first)."""
    counts = histogram_full(dev, mesh=mesh)
    k = min(k, counts.shape[0])
    order = np.lexsort((np.arange(counts.shape[0]), -counts.astype(np.int64)))
    top = order[:k]
    return top.astype(np.uint32), counts[top]


def describe(dev: DeviceColumn, mesh=None) -> dict:
    """min / max / mean / median / distinct-count summary, one pass."""
    counts = histogram_full(dev, mesh=mesh)
    nz = np.nonzero(counts)[0]
    n = int(counts.sum())
    if not nz.size:
        return {"n": 0, "min": None, "max": None, "mean": None,
                "median": None, "distinct": 0}
    vals = nz.astype(np.uint64)
    total = int((vals * counts[nz]).sum())
    cum = np.cumsum(counts)
    median = int(np.searchsorted(cum, (n + 1) // 2))
    return {
        "n": n,
        "min": int(nz[0]),
        "max": int(nz[-1]),
        "mean": total / n,
        "median": median,
        "distinct": int(nz.size),
    }


__all__ = ["histogram_full", "quantiles", "topk_values", "describe"]
