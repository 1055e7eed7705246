"""Conjunctive multi-column scan: AND of per-column range predicates.

Capability extension over the reference (whose scans read exactly one
column: src/simd_scan.cpp:103-158): the classic multi-predicate WHERE
clause ``lo_0 <= a < hi_0 AND lo_1 <= b < hi_1 AND ...`` over m packed
columns of the same table, evaluated in ONE fused pass — one bitvector
and one count, no per-column bitvector materialization and no second
pass over n.  Composing the same query from single-column kernels costs
m bitvector writes + (m-1) AND passes of n/8 bytes each; fusing removes
all of it, so the pass reads ``sum(width_c)/8`` bytes per value and
writes 1/8.

Design notes:

- Columns of the same n share the SAME block layout (layout.padded_blocks
  depends only on n), so block row b of every column holds the same
  values and no cross-column index arithmetic exists.
- Equality predicates are the degenerate range [key, key+1); a range is
  ONE unsigned compare per (value, column) via the subtract trick
  (``v - lo < hi - lo``), so the body is m*(unpack + ~3) ops per value —
  memory-bound for small m at common widths.
- Match bits accumulate per COLUMN in uint32 words and the conjunction
  is m-1 word ANDs per 32 values — noise.
- Per-column IN-list / arbitrary predicates compose on top: run the
  member/shared tiers per column and AND the (B1, 128) rows; this tier is
  the fast path for the dominant range/equality case.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from shared_simd_scan_tpu.layout import LANES, BLOCK_VALUES, DeviceColumn
from shared_simd_scan_tpu.ops.driver import popcount_sum, valid_word, word_rows
from shared_simd_scan_tpu.ops.scan import bits_to_canonical
from shared_simd_scan_tpu.ops.unpack import unpack_value_at

MAX_COLUMNS = 8


def _conj_range_row(cols_words, lows, highs, *, widths):
    """AND of per-column range matches -> one match row.  Inverted bounds
    (hi < lo) are an EMPTY range, not a wrapped one — a scalar clamp."""
    acc = None
    for c, (words, width) in enumerate(zip(cols_words, widths)):
        lo, hi = lows[c], highs[c]
        span = jnp.where(hi > lo, hi - lo, jnp.uint32(0))
        col = jnp.uint32(0)
        for r in range(BLOCK_VALUES):
            inside = (unpack_value_at(words, width, r) - lo) < span
            col = col | jnp.where(inside, jnp.uint32(1 << r), jnp.uint32(0))
        acc = col if acc is None else acc & col
    return acc


@functools.partial(jax.jit, static_argnames=("widths", "n"))
def _conj_impl(tiles, lows, highs, block_offset, *, widths, n):
    row = _conj_range_row(
        [word_rows(t) for t in tiles], lows, highs, widths=widths
    )
    row = row & valid_word(0, tiles[0].shape[1:], n, block_offset)
    return row, popcount_sum(row)


def conj_range_scan_tiles(
    tiles: tuple[jax.Array, ...],
    lows: jax.Array,
    highs: jax.Array,
    widths: tuple[int, ...],
    n: int,
    block_offset: jax.Array | int = 0,
) -> tuple[jax.Array, jax.Array]:
    """AND of m half-open ranges [lo_c, hi_c), one per column, fused.

    ``tiles`` is the tuple of m device tile arrays (uint32[width_c, B1,
    128], same B1); returns (bits uint32[B1, 128], count uint32) with the
    standard bitvector contract (LSB-first, padding masked)."""
    m = len(widths)
    if not (1 <= m <= MAX_COLUMNS):
        raise ValueError(f"conj scan supports 1..{MAX_COLUMNS} columns, got {m}")
    if len(tiles) != m:
        raise ValueError(f"{len(tiles)} tile arrays for {m} widths")
    b1 = tiles[0].shape[1]
    for t in tiles:
        assert t.shape[1] == b1 and t.shape[2] == LANES, (
            "conjunction columns must share n (same B1 block layout)"
        )
    return _conj_impl(
        tuple(tiles), jnp.asarray(lows, jnp.uint32),
        jnp.asarray(highs, jnp.uint32), block_offset,
        widths=tuple(widths), n=n,
    )


def conj_range_scan_device(devs, lows, highs) -> tuple[jax.Array, jax.Array]:
    """Conjunction of range predicates over same-table DeviceColumns ->
    ((W,) canonical bitvector words, scalar match count)."""
    devs = list(devs)
    n = devs[0].n
    for d in devs:
        if d.n != n:
            raise ValueError(
                f"conjunction columns must share n, got {d.n} != {n}"
            )
    bits, count = conj_range_scan_tiles(
        tuple(d.tiles for d in devs), lows, highs,
        tuple(d.width for d in devs), n,
    )
    return bits_to_canonical(bits, n), count


def conj_eq_scan_device(devs, keys) -> tuple[jax.Array, jax.Array]:
    """Conjunction of EQUALITY predicates (one key per column): the
    degenerate ranges [key_c, key_c + 1)."""
    keys = jnp.asarray(keys, jnp.uint32)
    return conj_range_scan_device(devs, keys, keys + jnp.uint32(1))


__all__ = [
    "conj_range_scan_tiles",
    "conj_range_scan_device",
    "conj_eq_scan_device",
]
