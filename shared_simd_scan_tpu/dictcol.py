"""Order-preserving dictionary encoding over the bit-packed column.

Capability extension, sibling of forcol.py: values from an ARBITRARY
domain (any uint64 span, any sparsity) are mapped through a sorted
dictionary to dense codes packed at ``ceil(log2(#distinct))`` bits.
Because the dictionary is sorted, the encoding is order-preserving and
every predicate rewrites exactly:

    Eq(v)        -> Eq(code(v))            (or constant-false)
    Range(lo,hi) -> Range(code_lo, code_hi) via searchsorted
    In(keys)     -> In(codes present)

so all kernel tiers, the query planner, and the histogram statistics run
unchanged on the code column — usually at a far narrower width than the
raw values would need.  (SUM aggregates are NOT linear in codes; decode
through the dictionary or keep such measures FOR-encoded instead.)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from shared_simd_scan_tpu import layout, query as q, stats as _stats
from shared_simd_scan_tpu.layout import DeviceColumn


@dataclasses.dataclass(frozen=True)
class DictColumn:
    """values[code] = logical value; dev holds the packed codes."""

    values: np.ndarray  # sorted unique logical values (uint64)
    dev: DeviceColumn

    @property
    def n(self) -> int:
        return self.dev.n

    @property
    def width(self) -> int:
        return self.dev.width


def pack_dict(values: np.ndarray, width: int | None = None) -> DictColumn:
    """Dictionary-encode: sorted-unique mapping, codes packed at the
    minimal (or an explicit wider) width."""
    values = np.asarray(values, dtype=np.uint64)
    if values.size == 0:
        raise ValueError("cannot dictionary-encode an empty column")
    uniq, codes = np.unique(values, return_inverse=True)
    need = max(1, int(np.ceil(np.log2(uniq.size))) if uniq.size > 1 else 1)
    if width is None:
        width = need
    if width < need or width > 31:
        raise ValueError(f"width {width} cannot hold {uniq.size} codes")
    return DictColumn(
        values=uniq,
        dev=layout.to_device(layout.pack(codes.astype(np.uint32), width)),
    )


def unpack_dict(dc: DictColumn) -> np.ndarray:
    """Decode back to logical values (host numpy uint64)."""
    import jax

    from shared_simd_scan_tpu.ops import unpack as unpack_ops

    codes = unpack_ops.unpack_device(dc.dev)
    return dc.values[np.asarray(jax.device_get(codes))]


def normalize(expr):
    """Rewrite every DictColumn leaf onto its code DeviceColumn."""
    if isinstance(expr, q.Range):
        if not isinstance(expr.col, DictColumn):
            return expr
        dc = expr.col
        lo = int(np.searchsorted(dc.values, np.uint64(expr.lo), side="left"))
        hi = int(np.searchsorted(dc.values, np.uint64(expr.hi), side="left"))
        if hi <= lo:
            return q.In(dc.dev, [])
        return q.Range(dc.dev, lo, hi)
    if isinstance(expr, q.In):
        if not isinstance(expr.col, DictColumn):
            return expr
        dc = expr.col
        keys = np.asarray(sorted({int(k) for k in expr.keys}), np.uint64)
        if keys.size == 0:
            return q.In(dc.dev, [])
        pos = np.searchsorted(dc.values, keys, side="left")
        present = (pos < dc.values.size) & (
            dc.values[np.minimum(pos, dc.values.size - 1)] == keys
        )
        return q.In(dc.dev, pos[present].tolist())
    if isinstance(expr, q.Not):
        return q.Not(normalize(expr.term))
    if isinstance(expr, q.And):
        return q.And(*[normalize(t) for t in expr.terms])
    if isinstance(expr, q.Or):
        return q.Or(*[normalize(t) for t in expr.terms])
    raise TypeError(f"not a query expression: {expr!r}")


def evaluate(expr):
    """query.evaluate over a tree that may mix DictColumn / ForColumn /
    DeviceColumn leaves (ForColumn via forcol.normalize first)."""
    from shared_simd_scan_tpu import forcol

    return q.evaluate(forcol.normalize(normalize(expr)))


def topk_values(dc: DictColumn, k: int):
    """Most frequent LOGICAL values via the code histogram."""
    # cap at the dictionary size, not the histogram domain (2^width) —
    # zero-count codes past values.size are not valid dictionary entries
    k = min(k, dc.values.size)
    codes, counts = _stats.topk_values(dc.dev, k)
    keep = codes < dc.values.size
    codes, counts = codes[keep][:k], counts[keep][:k]
    return dc.values[codes], counts


def describe(dc: DictColumn) -> dict:
    """Summary in logical values (mean over the dictionary decode)."""
    counts = _stats.histogram_full(dc.dev)
    counts = counts[: dc.values.size]
    n = int(counts.sum())
    if n == 0:
        return {"n": 0, "min": None, "max": None, "mean": None,
                "median": None, "distinct": 0}
    nz = np.nonzero(counts)[0]
    cum = np.cumsum(counts)
    med_code = int(np.searchsorted(cum, (n + 1) // 2))
    # exact: uint64 elementwise products can overflow for 64-bit domains
    total = sum(int(dc.values[c]) * int(counts[c]) for c in nz)
    return {
        "n": n,
        "min": int(dc.values[nz[0]]),
        "max": int(dc.values[nz[-1]]),
        "mean": total / n,
        "median": int(dc.values[med_code]),
        "distinct": int(nz.size),
    }


__all__ = [
    "DictColumn",
    "pack_dict",
    "unpack_dict",
    "normalize",
    "evaluate",
    "topk_values",
    "describe",
]
