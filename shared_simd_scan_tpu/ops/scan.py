"""Fused scan tiers: single-predicate and shared (k-predicate) scans.

Re-design of the reference's scan family:
  - ``scan_128`` / ``scan_256`` (src/simd_scan.cpp:102-307): unpack fused
    with one equality compare, LSB-first match bitvector + hit count.
  - ``shared_scan_128_standard`` and friends (src/simd_scan_shared.cpp):
    k predicates evaluated in ONE pass — decompress each block once, then
    an inner compare loop over the predicate table (the "horizontal" shared
    scan, simd_scan_shared.cpp:49-86).  The vertical/parallel, sequential,
    threaded, and unrolled reference variants are all expressions of the
    same semantics under different CPU resource constraints; here they
    collapse into tier bodies over whole word rows (SURVEY.md §2.4): values
    ride the (block row, lane) axes, the predicate loop is unrolled at
    trace time (k is a static jit specialization — the analog of the
    reference's ``shared_scan_128_linear_static<NUM>`` template,
    simd_scan.hpp:122-236).

Key layout win: one 32-value block contributes exactly one uint32 word of
the match bitvector, so a tier emits ``bits[k, B1, 128]`` with NO
cross-lane traffic — the movemask packing (simd_scan.cpp:132,145) becomes
``acc |= (v_r == key) << r`` per unrolled r.  Canonical LSB-first order is a
reshape, byte-identical to the reference.

Every tier is a *body* (ops/driver.py): a pure elementwise function of the
column's word rows that returns the k match words.  The drivers add the
validity mask, the counts and the stacked output; :data:`TRITON_TIERS`
names the tiers whose default driver is the Pallas Triton program instead
of XLA.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from shared_simd_scan_tpu.layout import (
    BLOCK_VALUES,
    DeviceColumn,
    bitvector_words,
    unpack_schedule,
)
from shared_simd_scan_tpu.ops import driver
from shared_simd_scan_tpu.ops.unpack import unpack_value_at, unpack_values

# Tiers whose default driver is the Pallas Triton program (driver.
# scan_triton), each up to a key count; every other tier, and these past
# their cap, run under XLA.  The choice is static and comes from
# measurement on the card (PERF.md, w=9, 512 MiB): Triton beat XLA end to
# end at every key count timed up to each cap — interval at k=8/24/32/33/
# 48/64, static AND-DAG at 8/20/32/33/48/64, traced bit-sliced at
# 8/20/32/33 (XLA won at 64), compare at 1/2/4/8 — and each tier compiled
# and matched XLA at its cap for widths 1, 8, 9, 17 and 31.
TRITON_TIERS: dict[str, int] = {
    "interval": 64,
    "bitsliced_static": 64,
    "bitsliced": 32,
    "compare": 8,
}


def _backend(tier: str, backend: str | None, k: int) -> str:
    """The driver a tier call runs under ("xla" or "triton"), resolved
    before its jit so the compile cache keys on it."""
    if backend is None:
        return "triton" if k <= TRITON_TIERS.get(tier, 0) else "xla"
    if backend not in ("xla", "triton"):
        raise ValueError(f"backend must be 'xla' or 'triton', got {backend!r}")
    return backend


def _drive(body, tiles, n, operands, block_offset, backend, k):
    """Run a tier body under the chosen driver -> (bits, counts)."""
    if backend == "triton":
        return driver.scan_triton(body, tiles, operands, block_offset, k=k, n=n)
    return driver.scan_xla(body, tiles, n, *operands, block_offset=block_offset)


# ---------------------------------------------------------------------------
# Compare tier: k equality predicates, any (traced) keys
# ---------------------------------------------------------------------------


def _compare_rows(words, keys, *, width, k):
    """k match words, one ``v == key`` compare per (value, key).

    Skip-normalization compare (the reference's core scan trick,
    scan_128 simd_scan.cpp:113-137 via the clean/predicate mask pair,
    simd_scan_commons.hpp:52-90): for values that do not straddle a word
    boundary, AND the word with the clean mask (value left IN PLACE at bit
    offset s) and compare against the key pre-shifted by s — one op
    instead of the shift+AND normalization.  Straddling values still take
    the normalized path.  Out-of-domain keys (>= 2^width) must match
    nothing: their shifted form could alias a cleaned value mod 2^32, so
    they are replaced by an unmatchable all-ones sentinel (a cleaned word
    always has zeros outside [s, s+width))."""
    dom = jnp.uint32(1 << width)
    vmask = (1 << width) - 1
    key = [keys[j] for j in range(k)]
    shifted: dict[int, list] = {}
    accs = [jnp.uint32(0)] * k
    for r, (kw, s, straddles) in enumerate(unpack_schedule(width)):
        bit = jnp.uint32(1 << r)
        if straddles:
            v = unpack_value_at(words, width, r)
            cmp = key
        else:
            v = words[kw] & jnp.uint32(vmask << s)
            if s not in shifted:
                shifted[s] = [
                    jnp.where(kj < dom, kj << jnp.uint32(s), jnp.uint32(0xFFFFFFFF))
                    for kj in key
                ]
            cmp = shifted[s]
        for j in range(k):
            accs[j] = accs[j] | jnp.where(v == cmp[j], bit, jnp.uint32(0))
    return accs


@functools.partial(jax.jit, static_argnames=("width", "n", "backend"))
def _compare_impl(tiles, keys, block_offset, *, width, n, backend):
    k = int(keys.shape[0])
    body = functools.partial(_compare_rows, width=width, k=k)
    return _drive(body, tiles, n, (keys.astype(jnp.uint32),), block_offset,
                  backend, k)


def shared_scan_tiles(
    tiles: jax.Array,
    keys: jax.Array,
    width: int,
    n: int,
    block_offset: jax.Array | int = 0,
    backend: str | None = None,
) -> tuple[jax.Array, jax.Array]:
    """tiles uint32[width, B1, 128], keys uint32[k] ->
    (bits uint32[k, B1, 128], counts uint32[k]).

    ``bits[j].reshape(-1)[:bitvector_words(n)]`` is the canonical LSB-first
    bitvector for predicate j (byte-parity with the reference).

    ``block_offset`` is the global index of this tile array's first block —
    nonzero only on the shard_map'd path (dist.py), where ``n`` is the
    GLOBAL value count and each shard masks its own tail region.
    ``backend`` forces a driver ("xla" or "triton"); None takes the
    dispatch default (:data:`TRITON_TIERS`)."""
    return _compare_impl(
        tiles, jnp.asarray(keys, jnp.uint32), block_offset, width=width, n=n,
        backend=_backend("compare", backend, int(jnp.shape(keys)[0])),
    )


def bits_to_canonical(bits: jax.Array, n: int) -> jax.Array:
    """Device bits layout [..., B1, 128] -> canonical uint32 words [..., W]."""
    lead = bits.shape[:-2]
    return bits.reshape(*lead, -1)[..., : bitvector_words(n)]


def _consecutive_lo(keys) -> int | None:
    """lo if keys are the concrete consecutive run lo..lo+k-1 (2 <= k <=
    1024); only the single-key scan stays on the compare tier."""
    if isinstance(keys, jax.core.Tracer):
        return None
    arr = np.asarray(keys)
    k = arr.shape[0]
    if not (2 <= k <= 1024):
        return None
    lo = int(arr[0])
    return lo if (arr == lo + np.arange(k, dtype=arr.dtype)).all() else None


def bitsliced_cost(width: int, k: int) -> int:
    """Static cost of the bit-sliced tier in the dispatch's
    quarter-ops-per-value units: ~48 fixed (unpack + SWAPMOVE transpose)
    plus width/4 per key (2*width ops per 32-value word)."""
    return 48 + width * k // 4


def _bitsliced_wins(width: int, k: int) -> bool:
    """Bit-sliced vs the compare tier (~12 per key + ~4 fixed in
    quarter-ops-per-value units); at width 9 this crosses at k=5."""
    return bitsliced_cost(width, k) < 4 + 12 * k


def pick_concrete_tier(width: int, keys) -> tuple[str, int | None]:
    """THE single home of the concrete-key shared-scan dispatch rule —
    both the single-device dispatcher (:func:`shared_scan_device`) and the
    sharded one (parallel.dist.sharded_shared_scan) call this, so
    retuning the cost constants cannot desynchronize them (same
    convention as member.member_dispatch_tier).

    Returns (tier, lo): tier in {"interval", "windowed",
    "bitsliced_static", "compare"}; lo is the interval base (None
    otherwise).  ``keys`` must be concrete."""
    keys = np.asarray(keys, dtype=np.uint32)
    k = int(keys.shape[0])
    lo = _consecutive_lo(keys)
    if lo is not None:
        return "interval", lo
    cost_cmp = 4 + 12 * k
    cost_dag = bitsliced_static_cost(width, keys)
    cost_win = windowed_cost(keys) if k >= 2 else 1 << 30
    if cost_win < min(cost_cmp, cost_dag):
        return "windowed", None
    if cost_dag < cost_cmp:
        return "bitsliced_static", None
    return "compare", None


def shared_scan_device(dev: DeviceColumn, keys) -> tuple[jax.Array, jax.Array]:
    """Shared scan on a DeviceColumn -> ((k, W) canonical bitvectors, (k,) counts).

    Dispatch (static, on the concrete key set when available):
    - consecutive run lo..lo+k-1 (the reference benchmark's own shape):
      the O(1)-in-k interval tier;
    - other concrete key sets: the cheapest of {windowed, static AND-DAG
      bit-sliced, general compare} by counted static cost — the AND-DAG
      tier prices the exact DAG its key set compiles to
      (:func:`bitsliced_static_cost`), so clustered sets that share
      subtree structure and spread sets are both handled;
    - traced keys past the cost crossover (k >= 5 at width 9): the
      bit-sliced tier (any k);
    - otherwise: the general compare tier.

    The key inspection happens BEFORE any jnp conversion: inside a jit
    trace ``jnp.asarray`` stages even a numpy constant into a Tracer,
    which would silently demote concrete keys to the traced-fallback
    compare tier."""
    traced = isinstance(keys, jax.core.Tracer)
    if not traced:
        keys = np.asarray(keys, dtype=np.uint32)
    k = int(keys.shape[0])
    w, n = dev.width, dev.n
    if not traced:
        tier, lo = pick_concrete_tier(w, keys)
        if tier == "interval":
            bits, counts = interval_scan_tiles(dev.tiles, lo, k, w, n)
        elif tier == "windowed":
            bits, counts = windowed_scan_tiles(dev.tiles, keys, w, n)
        elif tier == "bitsliced_static":
            bits, counts = shared_scan_bitsliced_static_tiles(dev.tiles, keys, w, n)
        else:
            bits, counts = shared_scan_tiles(dev.tiles, jnp.asarray(keys), w, n)
    elif _bitsliced_wins(w, k):
        bits, counts = shared_scan_bitsliced_tiles(dev.tiles, keys, w, n)
    else:
        bits, counts = shared_scan_tiles(dev.tiles, keys, w, n)
    return bits_to_canonical(bits, n), counts


def scan_device(dev: DeviceColumn, predicate_key) -> tuple[jax.Array, jax.Array]:
    """Single-predicate scan (counterpart of scan_128, simd_scan.cpp:103-158):
    -> ((W,) canonical bitvector words, scalar hit count)."""
    keys = jnp.asarray(predicate_key, jnp.uint32).reshape(1)
    bits, counts = shared_scan_device(dev, keys)
    return bits[0], counts[0]


# ---------------------------------------------------------------------------
# Linear (interleaved) export
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("nbytes",))
def interleave_linear(bits: jax.Array, nbytes: int) -> jax.Array:
    """(k, W) uint32 bitvectors -> uint8[nbytes * k] in ``out[group*k +
    key]`` byte order: byte ``group`` of every key's bitvector, key-minor.
    One byte transpose (bitvector bytes are little-endian words)."""
    k, w = bits.shape
    by = jax.lax.bitcast_convert_type(bits, jnp.uint8).reshape(k, 4 * w)
    return by[:, :nbytes].T.reshape(-1)


def shared_scan_linear_device(dev: DeviceColumn, keys) -> jax.Array:
    """Linear (interleaved) shared scan -> uint8[ceil(n/8) * k].

    Byte layout ``out[group*k + key_id]`` for 8-value groups — parity with
    shared_scan_128_linear_standard (simd_scan_shared_linear.cpp:57).  The
    (k, W) layout is the native one; the interleave is a byte transpose of
    the shared scan's output (the reference needed a separate kernel only
    because its outputs stream straight to DRAM)."""
    bits, _ = shared_scan_device(dev, keys)
    return interleave_linear(bits, (dev.n + 7) // 8)


def shared_scan_linear_words_device(dev: DeviceColumn, keys) -> jax.Array:
    """Linear shared scan -> uint32[nbytes * k / 4]: the SAME linear byte
    stream viewed 4 little-endian bytes at a time (host exports
    reinterpret it for free with np.view(np.uint8)).  Requires
    k % 4 == 0 (byte count divisible by 4)."""
    k = int(keys.shape[0] if hasattr(keys, "shape") else len(keys))
    if k % 4:
        raise ValueError("words view needs k % 4 == 0; use the uint8 form")
    out = shared_scan_linear_device(dev, keys)
    return jax.lax.bitcast_convert_type(out.reshape(-1, 4), jnp.uint32)


# ---------------------------------------------------------------------------
# Interval shared scan: k consecutive equality predicates lo, lo+1, .., lo+k-1
# ---------------------------------------------------------------------------
#
# The reference's shared-scan benchmark (predicates 0..k-1,
# src/benchmark.cpp:205-209) and the common DB decomposition of a range
# predicate both use consecutive keys.  For that case the per-value match
# mask against ALL keys of a 32-key window is ONE variable shift —
# ``1 << (v - lo)`` — instead of k compares (out-of-window values,
# including v < lo via unsigned wraparound, give a shift of 32 or more,
# which XLA defines as 0; see :func:`_onehot32`).  The per-key bitvectors
# then fall out of a cross-vector bit-slice transpose: masks of values
# {t, t+8, t+16, t+24} are packed into the four bytes of word X_t, and
# three SWAPMOVE stages (the classic bit-matrix transpose, 12 swaps of 6
# ops) turn X_0..X_7 directly into the eight per-key bitvector words — the
# movemask/distribute phase of the reference (simd_scan.cpp:132,145) has no
# analog left at all.  ~11 ops/value at k=8 (vs ~27 for the compare tier)
# and ~0.7 ops/value/key asymptotically.


def _swapmove(a, b, m, s):
    """Swap bits of ``a`` at positions p+s with bits of ``b`` at p (p in m)."""
    t = ((a >> jnp.uint32(s)) ^ b) & jnp.uint32(m)
    return a ^ (t << jnp.uint32(s)), b ^ t


def _transpose8x8_bytes(x):
    """Bit-slice 8x8 transpose over four independent byte channels.

    Input: 8 uint32 words; byte g, bit u of x[t] = M_g[t][u].
    Output: 8 uint32 words; byte g, bit t of y[j] = M_g[t][j].
    12 SWAPMOVEs = 72 ops, no cross-byte traffic."""
    x = list(x)
    for i in (0, 2, 4, 6):
        x[i], x[i + 1] = _swapmove(x[i], x[i + 1], 0x55555555, 1)
    for i in (0, 1, 4, 5):
        x[i], x[i + 2] = _swapmove(x[i], x[i + 2], 0x33333333, 2)
    for i in (0, 1, 2, 3):
        x[i], x[i + 4] = _swapmove(x[i], x[i + 4], 0x0F0F0F0F, 4)
    return x


def _onehot32(d, gateless: bool):
    """Match mask ``1 << d`` with bit j set iff d == j (0 for d >= 32).

    The gateless form relies on XLA's shift semantics: a logical shift by
    the bit width or more yields 0 (pinned by a test on the CPU and a
    check in chip_smoke.py on the card).  Inside a Triton program an
    oversized LLVM shift is poison, so the Triton driver uses the gated
    form (one extra compare+select per value)."""
    if gateless:
        return jnp.uint32(1) << d
    return jnp.where(
        d < jnp.uint32(32),
        jnp.uint32(1) << (d & jnp.uint32(31)),
        jnp.uint32(0),
    )


def _mask_byte(m, c8: int, g: int):
    """Byte ``c8`` of mask ``m``, placed at byte position ``g``."""
    sh = 8 * (c8 - g)
    if sh > 0:
        m = m >> jnp.uint32(sh)
    elif sh < 0:
        m = m << jnp.uint32(-sh)
    if abs(sh) == 24:  # the shift itself isolated the byte
        return m
    return m & jnp.uint32(0xFF << (8 * g))


def _interval_rows(words, lo, *, width, k, gateless):
    """k match words for keys lo..lo+k-1 (``lo`` is a 1-entry operand).

    32-key windows: one one-hot mask per (value, window); rounds of 8 keys
    take one mask byte per value into the 8x8 bit transpose.  At k <= 8 the
    masks are rebuilt where they are used (fewer live rows)."""
    lo = lo[0]
    stream = k <= 8
    if not stream:
        vs = unpack_values(words, width)
        ms = [
            [_onehot32(v - (lo + jnp.uint32(32 * w)), gateless) for v in vs]
            for w in range((k + 31) // 32)
        ]
    rows = []
    for c8 in range((k + 7) // 8):
        win, byte = divmod(c8, 4)
        x = []
        for t in range(8):
            acc = None
            for g in range(4):
                r = 8 * g + t
                if stream:
                    m = _onehot32(unpack_value_at(words, width, r) - lo, gateless)
                else:
                    m = ms[win][r]
                mb = _mask_byte(m, byte, g)
                acc = mb if acc is None else acc | mb
            x.append(acc)
        rows.extend(_transpose8x8_bytes(x)[: min(8, k - 8 * c8)])
    return rows


@functools.partial(jax.jit, static_argnames=("k", "width", "n", "backend"))
def _interval_impl(tiles, lo, block_offset, *, k, width, n, backend):
    body = functools.partial(
        _interval_rows, width=width, k=k, gateless=backend == "xla"
    )
    lo = jnp.asarray(lo, jnp.uint32).reshape(1)
    return _drive(body, tiles, n, (lo,), block_offset, backend, k)


def interval_scan_tiles(
    tiles: jax.Array,
    lo,
    k: int,
    width: int,
    n: int,
    block_offset: jax.Array | int = 0,
    backend: str | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Shared scan against the k consecutive keys lo..lo+k-1 (k <= 1024).

    Same output contract as :func:`shared_scan_tiles` with
    keys = [lo, lo+1, ..., lo+k-1]; ``lo`` may be traced."""
    if not (1 <= k <= 1024):
        raise ValueError(f"interval scan supports 1 <= k <= 1024, got {k}")
    return _interval_impl(
        tiles, lo, block_offset, k=k, width=width, n=n,
        backend=_backend("interval", backend, k),
    )


def interval_scan_device(dev: DeviceColumn, lo, k: int) -> tuple[jax.Array, jax.Array]:
    """Shared scan for consecutive keys lo..lo+k-1 -> ((k, W) bitvectors,
    (k,) counts) — the fast path for the reference benchmark's predicate
    set (0..k-1) and for range predicates decomposed per key."""
    bits, counts = interval_scan_tiles(dev.tiles, lo, k, dev.width, dev.n)
    return bits_to_canonical(bits, dev.n), counts


# ---------------------------------------------------------------------------
# Histogram: counts-only scans over the whole (or part of the) domain
# ---------------------------------------------------------------------------
#
# A full value histogram (counts for every key lo..lo+k-1, k up to 4096)
# cannot go through the bitvector tiers at large n*k — k=512 bitvectors of
# a 512 MiB column would be 30 GB of output.  Counts-only rows are reduced
# where they are made, so the pass is read-bound.


def _window_counts(tiles, lo_c, block_offset, *, width, n):
    """Counts of the 32 keys lo_c..lo_c+31 (interval body, no bits)."""
    body = functools.partial(_interval_rows, width=width, k=32, gateless=True)
    return driver.count_xla(
        body, tiles, n, jnp.reshape(lo_c, (1,)), block_offset=block_offset
    )


@functools.partial(jax.jit, static_argnames=("k", "width", "n"))
def _histogram_impl(tiles, lo, block_offset, *, k, width, n):
    nwin = (k + 31) // 32
    lo = jnp.asarray(lo, jnp.uint32)
    counts = jax.lax.map(
        lambda c: _window_counts(
            tiles, lo + jnp.uint32(32) * c, block_offset, width=width, n=n
        ),
        jnp.arange(nwin, dtype=jnp.uint32),
    )
    return counts.reshape(-1)[:k]


def histogram_tiles(
    tiles: jax.Array,
    lo,
    k: int,
    width: int,
    n: int,
    block_offset: jax.Array | int = 0,
) -> jax.Array:
    """Counts for the k consecutive keys lo..lo+k-1 WITHOUT materializing
    bitvectors -> uint32 (k,).  ``lo`` may be traced: one compiled 32-key
    window body is mapped over the ceil(k/32) windows (one pass over the
    packed column per window).  k up to 4096; a full domain histogram is
    k = 2^width."""
    if not (1 <= k <= 4096):
        raise ValueError(f"histogram supports 1 <= k <= 4096, got {k}")
    return _histogram_impl(tiles, lo, block_offset, k=k, width=width, n=n)


# One static AND-DAG over every key of the span; past this many keys the
# traced-lo window form runs instead (the straight-line body grows with k,
# and its compile time with it).
HISTOGRAM_DAG_MAX_KEYS = 512


@functools.partial(jax.jit, static_argnames=("lo", "k", "width", "n"))
def _histogram_dag_impl(tiles, block_offset, *, lo, k, width, n):
    body = functools.partial(
        _static_rows, width=width, keys=tuple(range(lo, lo + k))
    )
    return driver.count_xla(body, tiles, n, block_offset=block_offset)


def histogram_dag_tiles(
    tiles: jax.Array,
    lo: int,
    k: int,
    width: int,
    n: int,
    block_offset: jax.Array | int = 0,
) -> jax.Array:
    """Histogram via the shared AND-DAG (CONCRETE lo): counts for keys
    lo..lo+k-1 with the whole consecutive span sharing one memoized
    subtree; every row is popcounted where it is made.  Spans past
    :data:`HISTOGRAM_DAG_MAX_KEYS` keys run :func:`histogram_tiles`."""
    if not (1 <= k <= 4096):
        raise ValueError(f"histogram supports 1 <= k <= 4096, got {k}")
    if k > HISTOGRAM_DAG_MAX_KEYS:
        return histogram_tiles(tiles, jnp.uint32(lo), k, width, n, block_offset)
    return _histogram_dag_impl(
        tiles, block_offset, lo=int(lo), k=k, width=width, n=n
    )


def histogram_device(dev: DeviceColumn, lo=0, k: int | None = None) -> jax.Array:
    """Value histogram of a packed column -> uint32 counts (k,), default
    the full domain (k = 2^width, capped at 4096).  Read-bound: one pass
    over the packed bytes, no bitvector output exists.  Concrete
    (non-jax) lo dispatches to the shared-AND-DAG form
    (histogram_dag_tiles); a jax scalar / traced lo keeps the
    once-compiled mask-window form — pass lo that way when sweeping many
    windows (each concrete lo specializes its own DAG program)."""
    if k is None:
        k = min(1 << dev.width, 4096)
    if isinstance(lo, (jax.Array, jax.core.Tracer)):
        return histogram_tiles(dev.tiles, lo, k, dev.width, dev.n)
    return histogram_dag_tiles(dev.tiles, lo, k, dev.width, dev.n)


# ---------------------------------------------------------------------------
# Range-predicate shared scan: k predicates lo_j <= v < hi_j
# ---------------------------------------------------------------------------


def _range_rows(words, lows, highs, *, width, k):
    """Half-open interval via the unsigned subtract trick: one compare per
    (value, predicate) instead of two."""
    lo = [lows[j] for j in range(k)]
    span = [highs[j] - lows[j] for j in range(k)]
    accs = [jnp.uint32(0)] * k
    for r in range(BLOCK_VALUES):
        v = unpack_value_at(words, width, r)
        bit = jnp.uint32(1 << r)
        for j in range(k):
            accs[j] = accs[j] | jnp.where((v - lo[j]) < span[j], bit, jnp.uint32(0))
    return accs


@functools.partial(jax.jit, static_argnames=("width", "n"))
def _range_impl(tiles, lows, highs, block_offset, *, width, n):
    k = int(lows.shape[0])
    body = functools.partial(_range_rows, width=width, k=k)
    return driver.scan_xla(
        body, tiles, n, lows.astype(jnp.uint32), highs.astype(jnp.uint32),
        block_offset=block_offset,
    )


def range_scan_tiles(
    tiles: jax.Array,
    lows: jax.Array,
    highs: jax.Array,
    width: int,
    n: int,
    block_offset: jax.Array | int = 0,
) -> tuple[jax.Array, jax.Array]:
    """k half-open range predicates [lo_j, hi_j) in one fused pass.

    The capability extension over the reference (equality-only shared
    scans): one compare per predicate via the unsigned-subtract interval
    trick, same bitvector/count contract as shared_scan_tiles."""
    return _range_impl(
        tiles, jnp.asarray(lows, jnp.uint32), jnp.asarray(highs, jnp.uint32),
        block_offset, width=width, n=n,
    )


def range_scan_device(dev: DeviceColumn, lows, highs) -> tuple[jax.Array, jax.Array]:
    """k range predicates on a DeviceColumn -> ((k, W) bitvectors, counts)."""
    bits, counts = range_scan_tiles(dev.tiles, lows, highs, dev.width, dev.n)
    return bits_to_canonical(bits, dev.n), counts


# ---------------------------------------------------------------------------
# Bit-sliced shared scan: arbitrary keys at ~2*width ops per key per BLOCK
# ---------------------------------------------------------------------------
#
# The compare tier pays ~3 ops per value per key (cmp + select + or on 32
# unpacked values).  The bit-sliced formulation changes that bound:
# transpose each 32-value block into ``width`` bit-plane words (plane p,
# bit r = bit p of value r — the BitWeaving/V decomposition), after which
# ONE key costs ``width`` XORs + ``width`` ANDs on whole 32-value words:
#
#     match_word(key) = AND_p (plane_p XOR (bit_p(key) ? 0 : ~0))
#
# i.e. ~2*width/32 ops per value per key (0.56 at width 9) instead of 3.
# The transpose itself is the 5-stage SWAPMOVE butterfly over the 32
# unpacked value words, pruned to the live planes.  Keys may be traced —
# nothing inspects their values — and out-of-domain keys (>= 2^width) are
# killed by a per-key scalar mask since only ``width`` planes are compared.


def _transpose_stages():
    """(shift, mask) per SWAPMOVE butterfly stage, in forward order."""
    stages = []
    j, m = 16, 0x0000FFFF
    while j:
        stages.append((j, m))
        j >>= 1
        if j:
            m = m ^ ((m << j) & 0xFFFFFFFF)
    return stages


def _transpose_bitplanes(vs, nplanes: int = BLOCK_VALUES):
    """32 words of 32 values -> the first ``nplanes`` bit-plane words
    (plane p, bit r = bit p of vs[r]).  5-stage SWAPMOVE butterfly,
    orientation chosen so no bit reversal is needed.

    The butterfly is pruned to the live planes explicitly: liveness is
    propagated backward from the ``nplanes`` outputs, pairs with no live
    output are skipped, and pairs with one live output use a one-sided
    4-op merge instead of the 6-op SWAPMOVE
    (a' = (a & ~(m<<s)) | ((b & m) << s)).  At nplanes=9 this is 196 ops
    vs the full butterfly's 480."""
    stages = _transpose_stages()
    live = set(range(nplanes))
    live_after: list[set] = [set()] * len(stages)
    for si in range(len(stages) - 1, -1, -1):
        live_after[si] = live
        j = stages[si][0]
        live = {
            i
            for i in range(BLOCK_VALUES)
            if (i & ~j) in live or ((i & ~j) | j) in live
        }
    x = list(vs)
    for (j, m), out_live in zip(stages, live_after):
        ju = jnp.uint32(j)
        mu = jnp.uint32(m)
        for i in range(BLOCK_VALUES):
            if i & j:
                continue
            a_live, b_live = i in out_live, (i + j) in out_live
            if not (a_live or b_live):
                continue
            a, b = x[i], x[i + j]
            if a_live and b_live:
                x[i], x[i + j] = _swapmove(a, b, m, j)
            elif a_live:
                x[i] = (a & jnp.uint32(~(m << j) & 0xFFFFFFFF)) | ((b & mu) << ju)
            else:
                x[i + j] = (b & jnp.uint32(~m & 0xFFFFFFFF)) | ((a >> ju) & mu)
    return x[:nplanes]


def bitplanes(words, width: int) -> list:
    """The ``width`` bit-plane words of a block row set."""
    return _transpose_bitplanes(unpack_values(words, width), width)


def _plane_fold(planes, key, width: int):
    """Match word of one (possibly traced) scalar key: XOR+AND fold over
    the planes, zero for out-of-domain keys."""
    one = jnp.uint32(1)
    km = jnp.where(key < jnp.uint32(1 << width), jnp.uint32(0xFFFFFFFF), jnp.uint32(0))
    acc = None
    for p in range(width):
        term = planes[p] ^ (((key >> jnp.uint32(p)) & one) - one)
        acc = term if acc is None else acc & term
    return acc & km


def _bitsliced_rows(words, keys, *, width, k):
    planes = bitplanes(words, width)
    return [_plane_fold(planes, keys[j], width) for j in range(k)]


@functools.partial(jax.jit, static_argnames=("width", "n", "backend"))
def _bitsliced_impl(tiles, keys, block_offset, *, width, n, backend):
    k = int(keys.shape[0])
    body = functools.partial(_bitsliced_rows, width=width, k=k)
    return _drive(body, tiles, n, (keys.astype(jnp.uint32),), block_offset,
                  backend, k)


def shared_scan_bitsliced_tiles(
    tiles: jax.Array,
    keys: jax.Array,
    width: int,
    n: int,
    block_offset: jax.Array | int = 0,
    backend: str | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Same contract as shared_scan_tiles for any k; keys may be traced.
    The fast arbitrary-key tier (see the bit-sliced design note above)."""
    return _bitsliced_impl(
        tiles, jnp.asarray(keys, jnp.uint32), block_offset, width=width, n=n,
        backend=_backend("bitsliced", backend, int(jnp.shape(keys)[0])),
    )


# ---------------------------------------------------------------------------
# Static bit-sliced shared scan: CONCRETE keys via a shared AND-DAG
# ---------------------------------------------------------------------------
#
# When the key set is concrete its bits are known at trace time, so the
# per-key XOR+AND plane fold (2*width ops/key) collapses into a pure
# AND-DAG over the planes and their negations:
#
#     match(key) = AND_p (bit_p(key) ? plane_p : ~plane_p)
#
# built as a balanced binary tree over the bit span with every subtree
# memoized — keys sharing a bit-pattern prefix (or any aligned sub-span
# pattern) share the subtree, so the counted cost for k spread keys at
# width 9 is ~57 ops per 32 values at k=8 (vs 144 for the XOR form) and
# ~113 at k=32 (vs 576).  The same DAG serves the IN-list tier
# (ops/member.py) through :func:`_member_or_tree`, which additionally
# factors the OR across keys (Shannon-style) instead of materializing
# per-key rows.  Cost functions below COUNT the exact DAG ops on a
# stand-in operand, so the dispatch crossover is computed per key set
# rather than estimated.


def _combo(planes, lo, hi, pattern: int, memo: dict):
    """Word with bit r set iff bits [lo, hi) of value r equal ``pattern``.

    ``planes`` are the bit-plane words; subtrees are memoized in ``memo``
    (shared across every key of one body) so common sub-patterns cost one
    AND total."""
    if hi - lo == 1:
        if pattern:
            return planes[lo]
        key = ("~", lo)
        hit = memo.get(key)
        if hit is None:
            hit = memo[key] = ~planes[lo]
        return hit
    key = (lo, hi, pattern)
    hit = memo.get(key)
    if hit is None:
        mid = (lo + hi + 1) // 2
        lob = mid - lo
        a = _combo(planes, lo, mid, pattern & ((1 << lob) - 1), memo)
        b = _combo(planes, mid, hi, pattern >> lob, memo)
        hit = memo[key] = a & b
    return hit


def _member_or_tree(planes, lo, hi, patterns, memo: dict):
    """Word with bit r set iff bits [lo, hi) of value r are IN
    ``patterns`` — the OR across keys factored Shannon-style: patterns are
    grouped by their high-span projection, each group pays one high-span
    combo AND one recursive low-span OR-tree.  Returns None when every
    pattern of the span is present (all-match; callers drop the AND)."""
    span = hi - lo
    pats = sorted(set(patterns))
    if len(pats) == (1 << span):
        return None
    if len(pats) == 1:
        return _combo(planes, lo, hi, pats[0], memo)
    key = ("or", lo, hi, tuple(pats))
    hit = memo.get(key)
    if hit is not None:
        return hit
    mid = (lo + hi + 1) // 2
    lob = mid - lo
    groups: dict[int, list[int]] = {}
    for p in pats:
        groups.setdefault(p >> lob, []).append(p & ((1 << lob) - 1))
    acc = None
    for hp in sorted(groups):
        lo_t = _member_or_tree(planes, lo, mid, groups[hp], memo)
        hi_t = _combo(planes, mid, hi, hp, memo)
        term = hi_t if lo_t is None else hi_t & lo_t
        acc = term if acc is None else acc | term
    memo[key] = acc
    return acc


class _CountVec:
    """Stand-in DAG operand: every AND/OR/NOT bumps a shared counter, so
    dispatch can price the exact DAG a concrete key set would compile to
    without tracing anything."""

    __slots__ = ("ctr",)

    def __init__(self, ctr):
        self.ctr = ctr

    def _op(self, other=None):
        self.ctr[0] += 1
        return self

    __and__ = _op
    __or__ = _op
    __xor__ = _op
    __lshift__ = _op
    __rshift__ = _op

    def __invert__(self):
        return self._op()


def _static_dag_ops(width: int, keys, member: bool = False) -> int:
    """Counted ops of the match DAG for one body (one key group, or the
    whole set for the member OR-tree)."""
    ctr = [0]
    planes = [_CountVec(ctr) for _ in range(width)]
    memo: dict = {}
    dom = 1 << width
    in_dom = [int(k) for k in keys if int(k) < dom]
    if member:
        if in_dom:
            _member_or_tree(planes, 0, width, in_dom, memo)
    else:
        for key in in_dom:
            _combo(planes, 0, width, key, memo)
    return ctr[0]


class _LiveVec:
    """Stand-in DAG operand that records creation/last-use timestamps, so
    the dispatch can bound a DAG's peak number of simultaneously live
    words (memoized combo words stay live from first computation to last
    reuse)."""

    __slots__ = ("env", "id")

    def __init__(self, env):
        self.env = env
        self.id = env.create()

    def _op(self, other=None):
        self.env.use(self.id)
        if isinstance(other, _LiveVec):
            self.env.use(other.id)
        return _LiveVec(self.env)

    __and__ = _op
    __or__ = _op

    def __invert__(self):
        return self._op()


class _LiveEnv:
    __slots__ = ("t", "born", "last")

    def __init__(self):
        self.t = 0
        self.born: list[int] = []
        self.last: list[int] = []

    def create(self) -> int:
        self.t += 1
        self.born.append(self.t)
        self.last.append(self.t)
        return len(self.born) - 1

    def use(self, i: int) -> None:
        self.t += 1
        self.last[i] = self.t

    def peak(self) -> int:
        events = sorted(
            [(b, 1) for b in self.born] + [(e + 1, -1) for e in self.last]
        )
        cur = peak = 0
        for _, d in events:
            cur += d
            peak = max(peak, cur)
        return peak


def _static_dag_liveness(width: int, keys, member: bool = False) -> int:
    """Peak simultaneously-live words of the match DAG (planes included —
    they are read throughout)."""
    env = _LiveEnv()
    planes = [_LiveVec(env) for _ in range(width)]
    memo: dict = {}
    dom = 1 << width
    in_dom = [int(k) for k in keys if int(k) < dom]
    if member:
        if in_dom:
            _member_or_tree(planes, 0, width, in_dom, memo)
    else:
        for key in in_dom:
            _combo(planes, 0, width, key, memo)
    for p in planes:
        env.use(p.id)
    return env.peak()


# Fixed cost of the bit-sliced tiers in quarter-ops-per-value units:
# unpack (~80 ops/32 values) + pruned transpose (196 at width 9) + plane
# handling, /8 to convert ops-per-32-values to quarter-ops-per-value.
_BITSLICED_FIXED = 40


def _static_krows(k: int) -> int:
    """Keys per DAG group in the static tier's cost model: k <= 32 one
    group, 33..48 one group, beyond that groups of 32 (subtrees are shared
    within a group only)."""
    if k <= 32:
        return k
    if k <= 48:
        return ((k + 7) // 8) * 8
    return 32


def _static_group_sizes(k: int) -> list[int]:
    """Key-group sizes the static tier's cost model prices (groups of at
    most 256 keys, exact multiples of 32 where possible, the sub-49 tail
    as its own group)."""
    sizes = []
    rem = k
    while rem > 0:
        if rem >= 256:
            g = 256
        elif rem > 48 and rem % 32:
            g = 32 * (rem // 32)
        else:
            g = rem
        sizes.append(g)
        rem -= g
    return sizes


def bitsliced_static_cost(width: int, keys) -> int:
    """Static cost (quarter-ops-per-value) of the concrete-key bit-sliced
    tier for THIS key set: fixed unpack+transpose plus the exact counted
    AND/NOT ops of the shared match DAG, summed over its key groups."""
    arr = np.asarray(keys, dtype=np.uint32)
    k = int(arr.shape[0])
    ops = 0
    g0 = 0
    for g in _static_group_sizes(k):
        sub = arr[g0 : g0 + g]
        g0 += g
        ks = int(sub.shape[0])
        krows = _static_krows(ks)
        ops += sum(
            _static_dag_ops(width, sub[c0 : c0 + krows].tolist())
            for c0 in range(0, ks, krows)
        )
    return _BITSLICED_FIXED + -(-ops // 8)


def _static_rows(words, *, width, keys):
    """Match words of a CONCRETE key set via the shared AND-DAG over the
    bit planes; out-of-domain keys give constant-zero (None) rows."""
    planes = bitplanes(words, width)
    memo: dict = {}
    dom = 1 << width
    return [
        _combo(planes, 0, width, key, memo) if key < dom else None
        for key in keys
    ]


@functools.partial(jax.jit, static_argnames=("keys", "width", "n", "backend"))
def _static_impl(tiles, block_offset, *, keys, width, n, backend):
    body = functools.partial(_static_rows, width=width, keys=keys)
    return _drive(body, tiles, n, (), block_offset, backend, len(keys))


def shared_scan_bitsliced_static_tiles(
    tiles: jax.Array,
    keys,
    width: int,
    n: int,
    block_offset: jax.Array | int = 0,
    backend: str | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Same contract as shared_scan_tiles for any CONCRETE key set: the
    bit-sliced tier with the per-key plane fold replaced by the shared
    AND-DAG (see the design note above).  Raises on traced keys — use
    shared_scan_bitsliced_tiles for those."""
    if isinstance(keys, jax.core.Tracer):
        raise TypeError("shared_scan_bitsliced_static_tiles requires concrete keys")
    arr = np.asarray(keys, dtype=np.uint32)
    if arr.shape[0] < 1:
        raise ValueError(f"shared scan needs at least one key, got {arr.shape[0]}")
    return _static_impl(
        tiles, block_offset, keys=tuple(int(v) for v in arr), width=width,
        n=n, backend=_backend("bitsliced_static", backend, len(arr)),
    )


# ---------------------------------------------------------------------------
# Windowed shared scan: arbitrary concrete keys via 32-aligned mask windows
# ---------------------------------------------------------------------------
#
# Generalizes the interval tier's one-shot mask to ANY concrete key set:
# keys are grouped into 32-aligned windows of the value domain; one
# variable shift per (value, window) produces the 32-bit match mask for
# every key the window contains, and one SWAPMOVE transpose per populated
# 8-key sub-window yields the bitvector words, which land straight in each
# key's caller-order row (the plan is static — keys must be concrete).
# Cost is 2*windows + ~5*populated_subwindows + unpack per value,
# independent of k itself — cheaper than the compare tier's 3*k whenever
# keys cluster (>= ~2 keys per 8-aligned byte).  The library dispatches on
# exactly that static cost comparison (see pick_concrete_tier).


def _window_plan(arr):
    """keys (concrete, caller order) -> (bases, plan).

    bases: sorted unique 32-aligned window bases.
    plan: per base, tuple of (byte, ((j, out_row), ...)) — sub-window byte
    index, bit j within it, and the caller-order output row."""
    arr = np.asarray(arr, dtype=np.uint32)
    by_base: dict[int, dict[int, list[tuple[int, int]]]] = {}
    for row, key in enumerate(arr.tolist()):
        base = key // 32 * 32
        off = key - base
        by_base.setdefault(base, {}).setdefault(off // 8, []).append(
            (off % 8, row)
        )
    bases = sorted(by_base)
    plan = tuple(
        tuple(
            (byte, tuple(by_base[b][byte]))
            for byte in sorted(by_base[b])
        )
        for b in bases
    )
    return bases, plan


def _window_chunks(arr, krows: int = 32):
    """Caller-order key rows in chunks of ``krows`` -> (bases, plans, woffs):
    all chunks' window bases concatenated, per-chunk plans (rows relative
    to the chunk) and each chunk's first window index into bases."""
    arr = np.asarray(arr, dtype=np.uint32)
    bases_all: list[int] = []
    plans = []
    woffs = []
    for c0 in range(0, arr.shape[0], krows):
        bases, plan = _window_plan(arr[c0 : c0 + krows])
        woffs.append(len(bases_all))
        bases_all.extend(bases)
        plans.append(plan)
    return bases_all, tuple(plans), tuple(woffs)


def windowed_cost(arr) -> int:
    """Static op-cost estimate (per value, x4) of the windowed tier for
    this key set: 8*windows + 20*populated_subwindows, summed over 32-row
    key chunks past k=48 (a window shared between chunks is counted per
    chunk)."""
    arr = np.asarray(arr, dtype=np.uint32)
    if arr.shape[0] <= 48:
        chunks = [_window_plan(arr)]
    else:
        _, plans, _ = _window_chunks(arr)
        chunks = [(None, p) for p in plans]
    return sum(
        8 * len(plan) + 20 * sum(len(p) for p in plan) for _, plan in chunks
    )


def _windowed_rows(words, *, width, bases, plan):
    """Per-row bitvector words for a static window plan (bases are
    concrete ints)."""
    vs = unpack_values(words, width)
    outs: list = [None] * sum(len(j) for w in plan for _, j in w)
    for base, wplan in zip(bases, plan):
        ms = [_onehot32(v - jnp.uint32(base), True) for v in vs]
        for byte, jrows in wplan:
            x = []
            for t in range(8):
                acc = None
                for g in range(4):
                    mb = _mask_byte(ms[8 * g + t], byte, g)
                    acc = mb if acc is None else acc | mb
                x.append(acc)
            y = _transpose8x8_bytes(x)
            for j, row in jrows:
                outs[row] = y[j]
    return outs


@functools.partial(jax.jit, static_argnames=("bases", "plan", "width", "n"))
def _windowed_impl(tiles, block_offset, *, bases, plan, width, n):
    body = functools.partial(_windowed_rows, width=width, bases=bases, plan=plan)
    return driver.scan_xla(body, tiles, n, block_offset=block_offset)


def windowed_scan_tiles(
    tiles: jax.Array,
    keys,
    width: int,
    n: int,
    block_offset: jax.Array | int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Shared scan for an arbitrary CONCRETE key set, any k, via
    32-aligned mask windows; same output contract as shared_scan_tiles.
    Raises on traced keys (the store plan must be static)."""
    if isinstance(keys, jax.core.Tracer):
        raise TypeError("windowed_scan_tiles requires concrete keys")
    arr = np.asarray(keys, dtype=np.uint32)
    if arr.shape[0] < 1:
        raise ValueError(f"windowed scan needs at least one key, got {arr.shape[0]}")
    bases, plan = _window_plan(arr)
    return _windowed_impl(
        tiles, block_offset, bases=tuple(bases), plan=plan, width=width, n=n
    )


__all__ = [
    "TRITON_TIERS",
    "shared_scan_tiles",
    "shared_scan_bitsliced_tiles",
    "shared_scan_bitsliced_static_tiles",
    "windowed_scan_tiles",
    "interval_scan_tiles",
    "range_scan_tiles",
    "pick_concrete_tier",
    "shared_scan_device",
    "scan_device",
    "interval_scan_device",
    "range_scan_device",
    "shared_scan_linear_device",
    "shared_scan_linear_words_device",
    "interleave_linear",
    "histogram_tiles",
    "histogram_dag_tiles",
    "histogram_device",
    "bits_to_canonical",
]
