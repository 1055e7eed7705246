"""Fused filter + aggregate scan: per-key SUM/COUNT over a measure column.

Capability extension over the reference (which stops at match bitvectors):
the classic DB aggregate pushdown ``SELECT key, SUM(m), COUNT(*) FROM t
WHERE p IN keys GROUP BY p`` evaluated in ONE pass over two packed
columns — the predicate column is unpacked, compared against the key
table, and the matching measure values are accumulated per key without
ever materializing a bitvector or the decompressed columns.

Design notes:

- Device arithmetic is 32-bit (JAX runs without 64-bit types), so exact
  sums are built from **16-bit split parts in int32 accumulators** with
  statically provable headroom: each (block, lane) element accumulates
  <= 32 values of a part < 2^16 (< 2^21), the on-device reduction adds
  <= 256 block rows of those (< 2^29 < 2^31) into a (steps, k, 128)
  partial grid, and the final reduction runs in numpy uint64 on the host
  over that small grid (:func:`finalize_sums`) — bit-exact for any n and
  width, no emulated wide math on the device.
- Padding blocks are zero-filled; instead of masking every key's
  accumulator, invalid values' *predicate* is rewritten once per value
  slot to the unmatchable sentinel 0xFFFFFFFF, so every compare fails
  for them (values are < 2^width <= 2^31).
- k is a static jit specialization (k <= 32 unrolled).

Contract: ``aggregate_scan_device(pdev, mdev, keys)`` -> (sums uint64
numpy (k,), counts uint32 (k,)).  The sums are host-finalized (exact);
``aggregate_scan_tiles`` returns the device-side partials for callers
composing inside jit (e.g. the sharded path).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from shared_simd_scan_tpu.layout import BLOCK_VALUES, LANES, DeviceColumn
from shared_simd_scan_tpu.ops.driver import popcount_sum, valid_word, word_rows
from shared_simd_scan_tpu.ops.unpack import unpack_value_at

MAX_KEYS = 32

# Block rows per on-device partial: 256 rows of < 2^21 stay < 2^29.
_PARTIAL_ROWS = 256


def _row_partials(x: jax.Array) -> jax.Array:
    """(B1, 128) int32 -> (steps, 128) int32 sums over groups of at most
    256 block rows (B1 is a multiple of 8, so a power-of-two group
    divides it)."""
    b1 = x.shape[0]
    g = _PARTIAL_ROWS
    while b1 % g:
        g //= 2
    return jnp.sum(x.reshape(b1 // g, g, LANES), axis=1)


def _stack_partials(rows: list) -> jax.Array:
    """k (B1, 128) accumulators -> (steps, k, 128) partial grid."""
    return jnp.stack([_row_partials(r) for r in rows], axis=1)


def _check_keys(k: int) -> None:
    if not (1 <= k <= MAX_KEYS):
        raise ValueError(f"aggregate scan supports 1 <= k <= {MAX_KEYS}, got {k}")


def _masked_predicate(pwords, wp, valid, r):
    """Predicate value r, or the unmatchable sentinel for padding slots."""
    p = unpack_value_at(pwords, wp, r)
    vbit = (valid >> jnp.uint32(r)) & jnp.uint32(1)
    return jnp.where(vbit == jnp.uint32(1), p, jnp.uint32(0xFFFFFFFF))


@functools.partial(jax.jit, static_argnames=("wp", "wm", "n"))
def _agg_compare_impl(ptiles, mtiles, keys, block_offset, *, wp, wm, n):
    """Select-accumulate tier: per (value, key) one compare and two or
    three selected adds."""
    k = int(keys.shape[0])
    split = wm > 16
    pwords, mwords = word_rows(ptiles), word_rows(mtiles)
    valid = valid_word(0, ptiles.shape[1:], n, block_offset)
    ks = [keys[j] for j in range(k)]
    zero = jnp.int32(0)
    cacc = [zero] * k
    lacc = [zero] * k
    hacc = [zero] * k
    for r in range(BLOCK_VALUES):
        p = _masked_predicate(pwords, wp, valid, r)
        m = unpack_value_at(mwords, wm, r)
        mlo = (m & jnp.uint32(0xFFFF)).astype(jnp.int32) if split else m.astype(jnp.int32)
        mhi = (m >> jnp.uint32(16)).astype(jnp.int32)
        for j in range(k):
            match = p == ks[j]
            cacc[j] = cacc[j] + jnp.where(match, jnp.int32(1), zero)
            lacc[j] = lacc[j] + jnp.where(match, mlo, zero)
            if split:
                hacc[j] = hacc[j] + jnp.where(match, mhi, zero)
    shape = ptiles.shape[1:]
    counts = jnp.stack(
        [jnp.sum(jnp.broadcast_to(c, shape), dtype=jnp.uint32) for c in cacc]
    )
    slo = _stack_partials([jnp.broadcast_to(a, shape) for a in lacc])
    shi = _stack_partials([jnp.broadcast_to(a, shape) for a in hacc])
    return counts, slo, shi


def aggregate_scan_tiles(
    ptiles: jax.Array,
    mtiles: jax.Array,
    keys: jax.Array,
    wp: int,
    wm: int,
    n: int,
    block_offset: jax.Array | int = 0,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """-> (counts uint32 (k,), sum_lo partials, sum_hi partials).

    The partials are (steps, k, LANES) int32 (nonnegative; every element
    is < 2^29 by construction, see module docstring, so the device-side
    arithmetic never wraps).  Combine them exactly with
    :func:`finalize_sums` (host, uint64)."""
    assert mtiles.shape[1] == ptiles.shape[1], "predicate/measure columns must share n"
    keys = jnp.asarray(keys, jnp.uint32)
    _check_keys(int(keys.shape[0]))
    return _agg_compare_impl(ptiles, mtiles, keys, block_offset, wp=wp, wm=wm, n=n)


# ---------------------------------------------------------------------------
# Bit-plane aggregate tier: per-key SUM via per-plane popcounts
# ---------------------------------------------------------------------------
#
# SUM over matches decomposes across the measure column's bit planes:
#
#     SUM_j = sum_p 2^p * popcount(match_j & mplane_p)
#
# One pass pays a fixed unpack + SWAPMOVE bit-plane transpose of BOTH
# columns (amortized over every key) plus ~4 ops per (key, measure-plane)
# WORD of 32 values — O(k*wm/32) per value instead of the
# select-accumulate tier's O(k) per value.  Match words reuse the memoized
# AND-DAG of the static bit-sliced scan (scan._combo) for concrete keys and
# the XOR plane fold for traced keys; the crossover vs the select-
# accumulate tier is priced by counted static cost
# (:func:`pick_aggregate_tier`), the same convention as
# scan.pick_concrete_tier.  Headroom is provable like the select tier's:
# each popcount is <= 32, so a (row, lane) element is < 32 * (2^16 - 1)
# < 2^21 (planes 0..15 in the lo part, 16..30 re-based in hi).


def _bitplane_parts(match_words, mplanes, wm):
    """Per key: count (uint32 scalar) and (B1, 128) int32 lo/hi sum parts."""
    counts, los, his = [], [], []
    for mw in match_words:
        counts.append(popcount_sum(mw))
        lo = jnp.int32(0)
        hi = jnp.int32(0)
        for p in range(wm):
            pc = jax.lax.population_count(mw & mplanes[p]).astype(jnp.int32)
            if p < 16:
                lo = lo + (pc << p)
            else:
                hi = hi + (pc << (p - 16))
        los.append(lo)
        his.append(jnp.broadcast_to(hi, mw.shape))
    return jnp.stack(counts), _stack_partials(los), _stack_partials(his)


@functools.partial(jax.jit, static_argnames=("keys", "wp", "wm", "n"))
def _agg_bitplane_static_impl(ptiles, mtiles, block_offset, *, keys, wp, wm, n):
    from shared_simd_scan_tpu.ops.scan import _combo, bitplanes

    valid = valid_word(0, ptiles.shape[1:], n, block_offset)
    pplanes = bitplanes(word_rows(ptiles), wp)
    mplanes = bitplanes(word_rows(mtiles), wm)
    dom = 1 << wp
    zero = jnp.zeros(ptiles.shape[1:], jnp.uint32)
    memo: dict = {}
    match = [
        _combo(pplanes, 0, wp, key, memo) & valid if key < dom else zero
        for key in keys
    ]
    return _bitplane_parts(match, mplanes, wm)


@functools.partial(jax.jit, static_argnames=("wp", "wm", "n"))
def _agg_bitplane_impl(ptiles, mtiles, keys, block_offset, *, wp, wm, n):
    from shared_simd_scan_tpu.ops.scan import _plane_fold, bitplanes

    valid = valid_word(0, ptiles.shape[1:], n, block_offset)
    pplanes = bitplanes(word_rows(ptiles), wp)
    mplanes = bitplanes(word_rows(mtiles), wm)
    match = [
        _plane_fold(pplanes, keys[j], wp) & valid for j in range(keys.shape[0])
    ]
    return _bitplane_parts(match, mplanes, wm)


def aggregate_bitplane_tiles(
    ptiles: jax.Array,
    mtiles: jax.Array,
    keys: jax.Array,
    wp: int,
    wm: int,
    n: int,
    block_offset: jax.Array | int = 0,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Traced-keys bit-plane aggregate — same contract as
    :func:`aggregate_scan_tiles` (counts, sum_lo partials, sum_hi
    partials; finalize with :func:`finalize_sums`)."""
    assert mtiles.shape[1] == ptiles.shape[1], "predicate/measure columns must share n"
    keys = jnp.asarray(keys, jnp.uint32)
    _check_keys(int(keys.shape[0]))
    return _agg_bitplane_impl(ptiles, mtiles, keys, block_offset, wp=wp, wm=wm, n=n)


def aggregate_bitplane_static_tiles(
    ptiles: jax.Array,
    mtiles: jax.Array,
    keys,
    wp: int,
    wm: int,
    n: int,
    block_offset: jax.Array | int = 0,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Concrete-keys bit-plane aggregate (shared AND-DAG match words) —
    same contract as :func:`aggregate_scan_tiles`."""
    arr = np.asarray(keys, dtype=np.uint32)
    _check_keys(int(arr.shape[0]))
    return _agg_bitplane_static_impl(
        ptiles, mtiles, block_offset, keys=tuple(int(x) for x in arr),
        wp=wp, wm=wm, n=n,
    )


# Counted static costs in the dispatch's quarter-ops-per-value units
# (ops per 32-value word / 8), the same convention as scan.bitsliced_cost.
# Constants are per-32-value op counts of the tier bodies: unpack ~2.5
# ops/value/column, select-accumulate ~(1 cmp + 2 or 3 where+add pairs)
# per key per VALUE, bit-plane ~4 ops per key per measure-plane WORD plus
# the fixed SWAPMOVE transposes.


def _agg_compare_cost(wp: int, wm: int, k: int) -> int:
    nsel = 3 if wm > 16 else 2
    per_value = 7 + k * (1 + 2 * nsel)
    return -(-32 * per_value // 8)


@functools.lru_cache(maxsize=64)
def _transpose_ops(width: int) -> int:
    """Counted ops of the liveness-pruned SWAPMOVE transpose to ``width``
    planes (exact — runs scan._transpose_bitplanes on the counting
    stand-in, so pruning changes reprice the dispatch automatically)."""
    from shared_simd_scan_tpu.ops.scan import _CountVec, _transpose_bitplanes

    ctr = [0]
    _transpose_bitplanes([_CountVec(ctr) for _ in range(BLOCK_VALUES)], width)
    return ctr[0]


def aggregate_bitplane_cost(wp: int, wm: int, keys) -> int:
    """Counted cost of the bit-plane tier for THIS key set
    (quarter-ops-per-value).  ``keys`` concrete -> exact AND-DAG count;
    pass an int k for the traced XOR-fold variant."""
    from shared_simd_scan_tpu.ops.scan import _static_dag_ops

    unpack = 32 * 5  # both columns, ~2.5 ops/value each
    fixed = unpack + _transpose_ops(wp) + _transpose_ops(wm)
    if isinstance(keys, int):
        k = keys
        match_ops = k * 2 * wp
    else:
        arr = np.asarray(keys, dtype=np.uint32)
        k = int(arr.shape[0])
        match_ops = _static_dag_ops(wp, arr.tolist()) + k  # + valid ANDs
    per_key = 3 + 4 * min(wm, 16) + (4 * (wm - 16) if wm > 16 else 0)
    return -(-(fixed + match_ops + k * per_key) // 8)


def pick_aggregate_tier(wp: int, wm: int, keys) -> str:
    """Dispatch rule for the keyed aggregate: "bitplane" vs "compare" by
    counted static cost.  ``keys`` may be concrete (exact DAG pricing) or
    a Tracer (XOR-fold pricing by k alone)."""
    if isinstance(keys, jax.core.Tracer):
        k = int(keys.shape[0])
        cost_bp = aggregate_bitplane_cost(wp, wm, k)
    else:
        arr = np.asarray(keys, dtype=np.uint32)
        k = int(arr.shape[0])
        cost_bp = aggregate_bitplane_cost(wp, wm, arr)
    return "bitplane" if cost_bp < _agg_compare_cost(wp, wm, k) else "compare"


@functools.partial(jax.jit, static_argnames=("wp", "wm", "n"))
def _minmax_impl(ptiles, mtiles, keys, block_offset, *, wp, wm, n):
    """Per-key MIN/MAX of the measure column where the predicate matches.

    Non-matching slots contribute the identity (int32 max for MIN — at or
    above any in-domain value since wm <= 31 — and -1 for MAX); values
    are < 2^31 so int32 order equals unsigned order."""
    k = int(keys.shape[0])
    pwords, mwords = word_rows(ptiles), word_rows(mtiles)
    valid = valid_word(0, ptiles.shape[1:], n, block_offset)
    ks = [keys[j] for j in range(k)]
    min_id = jnp.int32(0x7FFFFFFF)
    max_id = jnp.int32(-1)
    cacc = [jnp.int32(0)] * k
    mins = [min_id] * k
    maxs = [max_id] * k
    for r in range(BLOCK_VALUES):
        p = _masked_predicate(pwords, wp, valid, r)
        m = unpack_value_at(mwords, wm, r).astype(jnp.int32)
        for j in range(k):
            match = p == ks[j]
            cacc[j] = cacc[j] + jnp.where(match, jnp.int32(1), jnp.int32(0))
            mins[j] = jnp.minimum(mins[j], jnp.where(match, m, min_id))
            maxs[j] = jnp.maximum(maxs[j], jnp.where(match, m, max_id))
    shape = ptiles.shape[1:]
    counts = jnp.stack(
        [jnp.sum(jnp.broadcast_to(c, shape), dtype=jnp.uint32) for c in cacc]
    )
    mn = jnp.stack([jnp.min(jnp.broadcast_to(x, shape), axis=0) for x in mins])
    mx = jnp.stack([jnp.max(jnp.broadcast_to(x, shape), axis=0) for x in maxs])
    return counts, mn[None], mx[None]


def minmax_scan_tiles(
    ptiles: jax.Array,
    mtiles: jax.Array,
    keys: jax.Array,
    wp: int,
    wm: int,
    n: int,
    block_offset: jax.Array | int = 0,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """-> (counts uint32 (k,), min partials, max partials), the partials
    (1, k, LANES) int32 — combine with :func:`finalize_minmax`."""
    assert mtiles.shape[1] == ptiles.shape[1], "predicate/measure columns must share n"
    keys = jnp.asarray(keys, jnp.uint32)
    _check_keys(int(keys.shape[0]))
    return _minmax_impl(ptiles, mtiles, keys, block_offset, wp=wp, wm=wm, n=n)


def finalize_minmax(mins, maxs, counts, wm: int):
    """-> (min uint32 (k,), max uint32 (k,)) from the device partials.

    Empty groups (count 0) report min = 2^wm (one above any in-domain
    value) and max = 0."""
    mn = np.asarray(mins).min(axis=(0, 2)).astype(np.int64)
    mx = np.asarray(maxs).max(axis=(0, 2)).astype(np.int64)
    cnt = np.asarray(counts)
    mn = np.where(cnt == 0, np.int64(1) << wm, mn).astype(np.uint32)
    mx = np.where(cnt == 0, 0, mx).astype(np.uint32)
    return mn, mx


def _check_same_n(pdev: DeviceColumn, mdev: DeviceColumn) -> None:
    if pdev.n != mdev.n:
        raise ValueError(
            f"column lengths differ: predicate n={pdev.n}, measure n={mdev.n}"
        )


def minmax_scan_device(pdev: DeviceColumn, mdev: DeviceColumn, keys):
    """Per-key MIN/MAX of the measure column in one fused pass ->
    (mins uint32 (k,), maxs uint32 (k,), counts uint32 (k,))."""
    _check_same_n(pdev, mdev)
    counts, mins, maxs = minmax_scan_tiles(
        pdev.tiles, mdev.tiles, keys, pdev.width, mdev.width, pdev.n
    )
    mn, mx = finalize_minmax(mins, maxs, counts, mdev.width)
    return mn, mx, counts


def finalize_sums(slo, shi) -> np.ndarray:
    """Exact per-key uint64 sums from the device partials (host numpy)."""
    lo = np.asarray(slo).astype(np.uint64).sum(axis=(0, 2))
    hi = np.asarray(shi).astype(np.uint64).sum(axis=(0, 2))
    return (hi << np.uint64(16)) + lo


def aggregate_scan_device(
    pdev: DeviceColumn, mdev: DeviceColumn, keys
) -> tuple[np.ndarray, jax.Array]:
    """GROUP-BY-key aggregate over two packed columns in one fused pass:
    -> (sums uint64 numpy (k,), counts uint32 (k,)).

    ``sums[j]`` = exact sum of the measure column over rows where the
    predicate column equals ``keys[j]``; ``counts[j]`` the row count.
    Columns must have the same length n.

    Dispatch (counted static cost, :func:`pick_aggregate_tier`): past the
    crossover the bit-plane tier replaces the select-accumulate tier —
    concrete key sets get exact AND-DAG pricing.  The key inspection
    happens BEFORE any jnp conversion (inside a jit trace jnp.asarray
    stages numpy constants into Tracers — the dispatch-demotion trap,
    see scan.shared_scan_device)."""
    _check_same_n(pdev, mdev)
    traced = isinstance(keys, jax.core.Tracer)
    tier = pick_aggregate_tier(pdev.width, mdev.width, keys)
    if tier == "bitplane" and not traced:
        fn = functools.partial(
            aggregate_bitplane_static_tiles, keys=np.asarray(keys, np.uint32)
        )
    elif tier == "bitplane":
        fn = functools.partial(aggregate_bitplane_tiles, keys=keys)
    else:
        fn = functools.partial(
            aggregate_scan_tiles,
            keys=keys if traced else jnp.asarray(np.asarray(keys, np.uint32)),
        )
    counts, slo, shi = fn(
        pdev.tiles, mdev.tiles, wp=pdev.width, wm=mdev.width, n=pdev.n
    )
    return finalize_sums(slo, shi), counts


# ---------------------------------------------------------------------------
# Masked aggregate: SUM/COUNT of the measure column over an arbitrary
# match bitvector (the terminal op for any query-layer predicate tree:
# SELECT SUM(m), COUNT(*) WHERE <expr>).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("wm",))
def _masked_agg_impl(mtiles, bits, *, wm):
    """Sum parts + count of measure values whose match bit is set.
    Relies on the library-wide tail invariant — bits at i >= n are zero
    in every tier/composition output — so no validity mask is
    recomputed here."""
    split = wm > 16
    mwords = word_rows(mtiles)
    one = jnp.uint32(1)
    zero = jnp.int32(0)
    lacc = jnp.int32(0)
    hacc = jnp.int32(0)
    for r in range(BLOCK_VALUES):
        m = unpack_value_at(mwords, wm, r)
        sel = ((bits >> jnp.uint32(r)) & one) == one
        if split:
            lacc = lacc + jnp.where(sel, (m & jnp.uint32(0xFFFF)).astype(jnp.int32), zero)
            hacc = hacc + jnp.where(sel, (m >> jnp.uint32(16)).astype(jnp.int32), zero)
        else:
            lacc = lacc + jnp.where(sel, m.astype(jnp.int32), zero)
    hacc = jnp.broadcast_to(hacc, bits.shape)
    return popcount_sum(bits), _stack_partials([lacc]), _stack_partials([hacc])


def masked_aggregate_tiles(
    mtiles: jax.Array, bits: jax.Array, wm: int
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """-> (count uint32, sum_lo partials, sum_hi partials) of the measure
    column over the set bits of a device-layout (B1, 128) bitvector row.
    Finalize the sums with :func:`finalize_sums` (they are (steps, 1,
    LANES) int32 partials with the same provable headroom as the keyed
    aggregate)."""
    b1 = mtiles.shape[1]
    assert bits.shape == (b1, LANES), (
        "bits must be the device-layout row matching the measure column"
    )
    return _masked_agg_impl(mtiles, bits, wm=wm)


def bits_from_canonical(words: jax.Array, b1: int) -> jax.Array:
    """Canonical uint32 bitvector words -> device-layout (b1, 128) row
    (the inverse of scan.bits_to_canonical; zero-padded)."""
    w = jnp.asarray(words).astype(jnp.uint32)
    pad = b1 * LANES - w.shape[0]
    if pad:
        w = jnp.concatenate([w, jnp.zeros(pad, jnp.uint32)])
    return w.reshape(b1, LANES)


def masked_aggregate_device(
    mdev: DeviceColumn, bits: jax.Array
) -> tuple[np.ndarray, jax.Array]:
    """SUM + COUNT of a measure column over an arbitrary match bitvector
    (canonical words, e.g. from ``query.evaluate``): -> (sum uint64
    scalar numpy, count uint32)."""
    row = bits_from_canonical(bits, mdev.tiles.shape[1])
    count, slo, shi = masked_aggregate_tiles(mdev.tiles, row, mdev.width)
    return finalize_sums(slo, shi)[0], count


__all__ = [
    "aggregate_scan_tiles",
    "aggregate_bitplane_tiles",
    "aggregate_bitplane_static_tiles",
    "aggregate_bitplane_cost",
    "pick_aggregate_tier",
    "aggregate_scan_device",
    "minmax_scan_tiles",
    "minmax_scan_device",
    "masked_aggregate_tiles",
    "masked_aggregate_device",
    "bits_from_canonical",
    "finalize_sums",
    "finalize_minmax",
    "MAX_KEYS",
]
