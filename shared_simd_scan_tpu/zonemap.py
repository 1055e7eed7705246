"""Zone maps: per-block-range min/max statistics + pruned scans.

The classic columnar scan-skipping optimization (Netezza zone maps,
Parquet column-chunk statistics; the reference has no analog — its scans
always touch every byte): record min/max per fixed range of rows at pack
time, then answer a range/equality predicate by scanning ONLY the
contiguous block span whose zones can contain matches.  On a sorted or
time-clustered column a point query touches O(1) zones instead of the
whole column.

Design constraints shape the API:

- **Static shapes.** XLA cannot scan a data-dependent span, so the
  pruned span is bucketed to a power-of-two number of device-block rows
  (min 8) — a bounded set of jit specializations — and the span START is
  a traced operand (``dynamic_slice`` + the tiers' ``block_offset``),
  so moving the span never recompiles.
- **Soundness before tightness.** The span covers every zone whose
  [zmin, zmax] intersects the predicate; interior zones that cannot
  match are still scanned (contiguity is what the hardware wants).
  Padding positions are validity-masked out of the zone stats (the scan
  kernels mask them out of results the same way), so all-padding zones
  report (0xFFFFFFFF, 0) and prune unconditionally.
- **Fallback.** When the span exceeds half the column the pruned path
  would pay the slice copy for little gain; the plain full-column range
  tier runs instead.  Unsorted columns therefore lose nothing.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from shared_simd_scan_tpu.layout import BLOCK_VALUES, LANES, DeviceColumn
from shared_simd_scan_tpu.ops import scan as scan_ops
from shared_simd_scan_tpu.ops.driver import popcount_sum, valid_for_blocks, word_rows
from shared_simd_scan_tpu.ops.unpack import unpack_tiles


@dataclasses.dataclass(frozen=True)
class ZoneMap:
    """Per-zone min/max over ``zone_b1`` device-block rows
    (= zone_b1 * 128 blocks = zone_b1 * 4096 values per zone)."""

    zone_b1: int
    b1: int
    zmin: np.ndarray  # (nz,) uint32; 0xFFFFFFFF for all-padding zones
    zmax: np.ndarray  # (nz,) uint32; 0 for all-padding zones

    @property
    def nzones(self) -> int:
        return self.zmin.shape[0]


def build_zonemap(
    dev: DeviceColumn,
    zone_b1: int = 64,
    chunk_zones: int = 64,
) -> ZoneMap:
    """One decompress pass -> ZoneMap.  Chunked over zones so the
    unpacked intermediate stays ~tens of MB (an eager full-column unpack
    materializes 4n bytes).  Invalid (padding) positions contribute
    0xFFFFFFFF to min and 0 to max, so all-padding zones prune away."""
    width, n = dev.width, dev.n
    _, b1, _ = dev.tiles.shape
    full, rem = n // BLOCK_VALUES, n % BLOCK_VALUES

    @functools.partial(jax.jit, static_argnames=("rows",))
    def zstats(sub, start_row, rows):
        vals = unpack_tiles(sub, width)
        r = jax.lax.broadcasted_iota(jnp.int32, vals.shape, 0)
        row = jax.lax.broadcasted_iota(jnp.int32, vals.shape, 1)
        lane = jax.lax.broadcasted_iota(jnp.int32, vals.shape, 2)
        blk = (start_row + row) * LANES + lane
        valid = (blk < full) | ((blk == full) & (r < rem))
        nzc = rows // zone_b1
        vmin = jnp.where(valid, vals, jnp.uint32(0xFFFFFFFF)).reshape(
            BLOCK_VALUES, nzc, zone_b1, LANES
        )
        vmax = jnp.where(valid, vals, jnp.uint32(0)).reshape(
            BLOCK_VALUES, nzc, zone_b1, LANES
        )
        return jnp.min(vmin, axis=(0, 2, 3)), jnp.max(vmax, axis=(0, 2, 3))

    if zone_b1 % 8 or b1 % zone_b1:
        raise ValueError(
            f"zone_b1={zone_b1} must be a multiple of 8 dividing the "
            f"padded block-row count {b1} (8/64 always work)"
        )
    mins, maxs = [], []
    step = chunk_zones * zone_b1
    for s in range(0, b1, step):
        rows = min(step, b1 - s)
        # start_row traced: every full chunk reuses ONE compiled program
        mn, mx = zstats(dev.tiles[:, s : s + rows, :], jnp.int32(s), rows)
        mins.append(np.asarray(jax.device_get(mn)))
        maxs.append(np.asarray(jax.device_get(mx)))
    return ZoneMap(
        zone_b1=zone_b1, b1=b1,
        zmin=np.concatenate(mins), zmax=np.concatenate(maxs),
    )


def build_zonemap_from_values(
    values: np.ndarray, b1: int, zone_b1: int = 64
) -> ZoneMap:
    """Ingest-time zone map: numpy min/max over the values BEFORE packing
    (free next to the pack itself — :func:`build_zonemap` exists for
    columns whose raw values are gone and costs a decompress pass).

    ``b1`` is the packed column's padded block-row count
    (``dev.tiles.shape[1]``); value index i lands in zone
    ``i // (zone_b1 * 4096)`` under the device layout, so plain
    contiguous reduction is exact."""
    if zone_b1 % 8 or b1 % zone_b1:
        raise ValueError(
            f"zone_b1={zone_b1} must be a multiple of 8 dividing the "
            f"padded block-row count {b1} (8/64 always work)"
        )
    values = np.asarray(values, dtype=np.uint32)
    per = zone_b1 * LANES * BLOCK_VALUES
    nz = b1 // zone_b1
    zmin = np.full(nz, 0xFFFFFFFF, np.uint32)
    zmax = np.zeros(nz, np.uint32)
    # padding positions never match any predicate (the kernels' validity
    # tail masks them), so zone stats cover REAL values only — identical
    # to build_zonemap's validity-masked reduction
    for z in range(0, (values.size + per - 1) // per):
        chunk = values[z * per : (z + 1) * per]
        zmin[z] = chunk.min()
        zmax[z] = chunk.max()
    return ZoneMap(zone_b1=zone_b1, b1=b1, zmin=zmin, zmax=zmax)


def prune_span(zmap: ZoneMap, lo: int, hi: int) -> tuple[int, int] | None:
    """Bucketed block-row span (start, span) covering every zone that can
    contain a value in [lo, hi); None when no zone can match.  start is
    8-aligned and span is a power of two >= 8 (clamped to the column)."""
    hit = (zmap.zmax.astype(np.uint64) >= lo) & (
        zmap.zmin.astype(np.uint64) < hi
    )
    if not bool(hit.any()):
        return None
    zf = int(np.argmax(hit))
    zl = int(len(hit) - 1 - np.argmax(hit[::-1]))
    s = (zf * zmap.zone_b1) // 8 * 8
    need = (zl + 1) * zmap.zone_b1 - s
    span = 8
    while span < need:
        span *= 2
    if span >= zmap.b1:
        return (0, zmap.b1)
    if s + span > zmap.b1:
        s = zmap.b1 - span
    return (s, span)


@functools.partial(jax.jit, static_argnames=("span", "width", "n"))
def _pruned_range_tiles(tiles, start, lows, highs, *, span, width, n):
    sub = jax.lax.dynamic_slice(
        tiles, (0, start, 0), (tiles.shape[0], span, LANES)
    )
    return scan_ops.range_scan_tiles(
        sub, lows, highs, width, n, block_offset=start * LANES
    )


@functools.partial(jax.jit, static_argnames=("span", "width", "n"))
def _pruned_range_full(tiles, start, lows, highs, *, span, width, n):
    """Pruned range tier + full-length canonical assembly under ONE jit,
    so the zeros / dynamic_update_slice / canonical reshape fuse instead
    of materializing one by one."""
    bits, cnt = _pruned_range_tiles(
        tiles, start, lows, highs, span=span, width=width, n=n
    )
    full = jax.lax.dynamic_update_slice(
        jnp.zeros((1, tiles.shape[1], LANES), jnp.uint32), bits,
        (0, start, 0),
    )
    return scan_ops.bits_to_canonical(full, n)[0], cnt[0]


@functools.partial(jax.jit, static_argnames=("width", "n"))
def _full_range_canonical(tiles, lows, highs, *, width, n):
    bits, cnt = scan_ops.range_scan_tiles(tiles, lows, highs, width, n)
    return scan_ops.bits_to_canonical(bits, n)[0], cnt[0]


def pruned_range_scan(
    dev: DeviceColumn,
    zmap: ZoneMap,
    lo: int,
    hi: int,
    full_bits: bool = True,
):
    """Range scan [lo, hi) touching only the pruned span ->
    (canonical bitvector words (W,) when full_bits else None,
    count uint32 scalar).

    Dispatch: no overlapping zone -> constant empty result (no scan runs
    at all); span > half the column -> the plain full-column range tier
    (the slice copy would outweigh the skipping)."""
    _, b1, _ = dev.tiles.shape
    W = (dev.n + 31) // 32
    sp = prune_span(zmap, lo, hi)
    lows = jnp.asarray([lo], jnp.uint32)
    highs = jnp.asarray([hi], jnp.uint32)
    if sp is None:
        bits = jnp.zeros((W,), jnp.uint32) if full_bits else None
        return bits, jnp.uint32(0)
    start, span = sp
    if span * 2 > b1:
        if full_bits:
            return _full_range_canonical(
                dev.tiles, lows, highs, width=dev.width, n=dev.n
            )
        _, cnt = scan_ops.range_scan_tiles(dev.tiles, lows, highs, dev.width, dev.n)
        return None, cnt[0]
    if full_bits:
        return _pruned_range_full(
            dev.tiles, jnp.int32(start), lows, highs,
            span=span, width=dev.width, n=dev.n,
        )
    _, cnt = _pruned_range_tiles(
        dev.tiles, jnp.int32(start), lows, highs,
        span=span, width=dev.width, n=dev.n,
    )
    return None, cnt[0]


# ---------------------------------------------------------------------------
# Per-zone gating: the gathered zoned scan
# ---------------------------------------------------------------------------
#
# prune_span covers ONE contiguous span, so a clustered-but-unsorted
# column (matching zones scattered through the file) degrades to a full
# scan.  Real zone maps prune per zone: the live tiles (``rows`` block rows
# each, one zone by default) are gathered by index, the range body runs on
# the gathered rows only, and the match bits are scattered back into a
# zeroed full-length bitvector.  The live count is bucketed to a power of
# two (padded with repeats of a live tile whose counts are masked off), so
# moving/varying zones reuses a handful of compiled programs — the same
# discipline as prune_span.


def zone_step_mask(zmap: ZoneMap, lo: int, hi: int, rows: int) -> np.ndarray:
    """Per-tile liveness: tile s (block rows [s*rows, (s+1)*rows)) is live
    iff any overlapping zone intersects [lo, hi)."""
    hit = (zmap.zmax.astype(np.uint64) >= lo) & (
        zmap.zmin.astype(np.uint64) < hi
    )
    if zmap.b1 % rows:
        # floor division would silently drop the tail block rows from the
        # mask and prune live data
        raise ValueError(f"rows={rows} must divide b1={zmap.b1}")
    steps = zmap.b1 // rows
    live = np.zeros(steps, bool)
    for s in range(steps):
        zf = (s * rows) // zmap.zone_b1
        zl = ((s + 1) * rows - 1) // zmap.zone_b1
        live[s] = bool(hit[zf : zl + 1].any())
    return live


@functools.partial(jax.jit, static_argnames=("rows", "width", "n"))
def _zoned_range_tiles(tiles, idx, flag, lows, highs, *, rows, width, n):
    """Gathered pruned range scan -> ((k, B1, 128) bits with pruned tiles
    zero, (k,) counts).  idx/flag are the (g,) live-tile routing arrays
    (padded with repeats of a live tile, flag 0)."""
    w, b1, _ = tiles.shape
    k = int(lows.shape[0])
    g = int(idx.shape[0])
    nt = b1 // rows
    sub = jnp.take(tiles.reshape(w, nt, rows, LANES), idx, axis=1)
    sub = sub.reshape(w, g * rows, LANES)
    blk_rows = (idx[:, None] * rows + jnp.arange(rows, dtype=jnp.int32)).reshape(-1)
    valid = valid_for_blocks(
        blk_rows[:, None] * LANES + jnp.arange(LANES, dtype=jnp.int32), n
    )
    live = jnp.repeat(flag == 1, rows)[:, None]
    found = scan_ops._range_rows(
        word_rows(sub), lows, highs, width=width, k=k
    )
    bits = jnp.stack([r & valid for r in found])  # (k, g*rows, 128)
    # padded tail entries revisit a live tile (same bits, idempotent
    # scatter) but must not double-count
    counts = jnp.stack([popcount_sum(jnp.where(live, r, 0)) for r in bits])
    full = jnp.zeros((k, nt, rows, LANES), jnp.uint32)
    full = full.at[:, idx].set(bits.reshape(k, g, rows, LANES))
    return full.reshape(k, b1, LANES), counts


@functools.partial(jax.jit, static_argnames=("rows", "width", "n"))
def _zoned_range_canonical(tiles, idx, flag, lows, highs, *, rows, width, n):
    bits, cnt = _zoned_range_tiles(
        tiles, idx, flag, lows, highs, rows=rows, width=width, n=n
    )
    return scan_ops.bits_to_canonical(bits, n)[0], cnt[0]


def zoned_range_scan(
    dev: DeviceColumn,
    zmap: ZoneMap,
    lo: int,
    hi: int,
    full_bits: bool = True,
):
    """Range scan [lo, hi) with PER-ZONE gating -> (canonical bitvector
    words (W,) when full_bits else None, count uint32 scalar).

    Unlike :func:`pruned_range_scan` (single contiguous span) this prunes
    every dead zone independently, so clustered-but-UNSORTED columns keep
    their skipping (matching zones at both file ends no longer force a
    full scan).  Falls back to the dense range tier when >= half the zones
    are live (the gather adds nothing there)."""
    W = (dev.n + 31) // 32
    rows = zmap.zone_b1
    live = zone_step_mask(zmap, lo, hi, rows)
    lows = jnp.asarray([lo], jnp.uint32)
    highs = jnp.asarray([hi], jnp.uint32)
    nlive = int(live.sum())
    if nlive == 0:
        bits = jnp.zeros((W,), jnp.uint32) if full_bits else None
        return bits, jnp.uint32(0)
    if 2 * nlive >= live.shape[0]:
        if full_bits:
            return _full_range_canonical(
                dev.tiles, lows, highs, width=dev.width, n=dev.n
            )
        _, cnt = scan_ops.range_scan_tiles(dev.tiles, lows, highs, dev.width, dev.n)
        return None, cnt[0]
    g = 1
    while g < nlive:
        g *= 2
    ids = np.nonzero(live)[0].astype(np.int32)
    idx = np.concatenate([ids, np.full(g - nlive, ids[-1], np.int32)])
    flag = np.concatenate(
        [np.ones(nlive, np.int32), np.zeros(g - nlive, np.int32)]
    )
    idxj, flagj = jnp.asarray(idx), jnp.asarray(flag)
    if full_bits:
        return _zoned_range_canonical(
            dev.tiles, idxj, flagj, lows, highs,
            rows=rows, width=dev.width, n=dev.n,
        )
    _, cnt = _zoned_range_tiles(
        dev.tiles, idxj, flagj, lows, highs, rows=rows, width=dev.width, n=dev.n
    )
    return None, cnt[0]


def zoned_eq_scan(
    dev: DeviceColumn, zmap: ZoneMap, key: int, full_bits: bool = True
):
    """Equality scan with per-zone gating: range [key, key+1)."""
    return zoned_range_scan(dev, zmap, int(key), int(key) + 1, full_bits=full_bits)


def pruned_eq_scan(
    dev: DeviceColumn, zmap: ZoneMap, key: int, full_bits: bool = True
):
    """Equality scan via the zone map: range [key, key+1)."""
    return pruned_range_scan(dev, zmap, int(key), int(key) + 1, full_bits=full_bits)


__all__ = [
    "ZoneMap",
    "build_zonemap",
    "build_zonemap_from_values",
    "prune_span",
    "zone_step_mask",
    "pruned_range_scan",
    "pruned_eq_scan",
    "zoned_range_scan",
    "zoned_eq_scan",
]
