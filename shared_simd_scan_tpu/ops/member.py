"""Fused IN-list (membership) scan: ONE bitvector for a whole key set.

Capability extension over the reference (which only offers per-predicate
shared scans, src/simd_scan_shared.cpp): the common DB predicate
``value IN (k_0 .. k_{K-1})`` needs a single match bitvector, not K of
them.  Fusing the OR into the scan cuts the write traffic from K
bitvector rows to ONE — at K=8/width 9 that is 2.125 -> 1.25 bytes per
value of total memory traffic, and the gap grows linearly with K.

Tiers (static dispatch on the concrete key set, mirroring
:func:`shared_simd_scan_tpu.ops.scan.shared_scan_device`):

- consecutive run lo..lo+K-1: a single unsigned-subtract range compare per
  value (``(v - lo) < K``) — reuses the range tier
  (:func:`scan.range_scan_tiles` with one [lo, lo+K) predicate);
- clustered concrete keys: 32-aligned *window popmasks* — per window, one
  variable shift builds the value's one-hot mask (as in the interval /
  windowed tiers) and one AND against the window's 32-bit membership
  mask tests all its keys at once; cost ~5 ops per (value, window)
  regardless of how many keys the window holds;
- spread CONCRETE keys, any k: the *static OR-tree* — the whole key set
  collapses at trace time into a Shannon-factored AND/OR/NOT DAG over
  the block's bit planes (scan._member_or_tree), memoized so common
  sub-patterns are computed once (priced by member_ortree_cost);
- spread TRACED keys, small k: an OR of equality compares (~2 ops per
  (value, key)) or the bit-sliced XOR+AND plane fold (~0.6);
- spread TRACED keys, large k (>= ~40 at width 9, width <= 12): a
  *domain bitmap* — the whole key set as a 2^width-bit table, per value
  one table-word lookup + one-hot bit test, cost FLAT in k.

Every tier body returns the single member row; the XLA driver
(ops/driver.py) masks the tail and counts it.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from shared_simd_scan_tpu.layout import BLOCK_VALUES, DeviceColumn
from shared_simd_scan_tpu.ops import driver
from shared_simd_scan_tpu.ops.scan import (
    _member_or_tree,
    _onehot32,
    _plane_fold,
    _static_dag_liveness,
    _static_dag_ops,
    bitplanes,
    bits_to_canonical,
    range_scan_tiles,
)
from shared_simd_scan_tpu.ops.unpack import unpack_value_at


def member_window_plan(keys) -> tuple[list[int], list[int]]:
    """Concrete keys -> (window bases, window popmasks).

    Windows are the 32-aligned value-domain intervals the keys touch;
    ``popmask`` bit ``j`` is set iff ``base + j`` is in the key set.
    Duplicate keys merge."""
    arr = np.asarray(keys, dtype=np.uint32)
    pops: dict[int, int] = {}
    for key in arr.tolist():
        base = key // 32 * 32
        pops[base] = pops.get(base, 0) | (1 << (key - base))
    bases = sorted(pops)
    return bases, [pops[b] for b in bases]


def _or_values(words, width, hit):
    """One member row: bit r set iff ``hit(v_r)`` for value r."""
    acc = jnp.uint32(0)
    for r in range(BLOCK_VALUES):
        v = unpack_value_at(words, width, r)
        acc = acc | jnp.where(hit(v), jnp.uint32(1 << r), jnp.uint32(0))
    return acc


def _member_compare_row(words, keys, *, width, k):
    """OR of k equality compares; keys may be traced."""
    ks = [keys[j] for j in range(k)]

    def hit(v):
        m = v == ks[0]
        for kj in ks[1:]:
            m = m | (v == kj)
        return m

    return [_or_values(words, width, hit)]


def _member_window_row(words, bases, pops, *, width, nwin):
    """Per value, OR over windows of ``(1 << (v - base_w)) & popmask_w``."""
    bs = [bases[w] for w in range(nwin)]
    ps = [pops[w] for w in range(nwin)]

    def hit(v):
        m = jnp.uint32(0)
        for b, p in zip(bs, ps):
            m = m | (_onehot32(v - b, True) & p)
        return m != jnp.uint32(0)

    return [_or_values(words, width, hit)]


def _member_domain_row(words, table, *, width):
    """Domain-bitmap membership: word ``T[v >> 5]`` of the 2^width-bit
    table, bit ``v & 31`` tested with an always-in-range shift.  Cost is
    FLAT in k — the only member tier whose per-value cost does not grow
    with the key count."""
    table = table.reshape(-1)

    def hit(v):
        word = jnp.take(table, v >> jnp.uint32(5), mode="clip")
        return ((word >> (v & jnp.uint32(31))) & jnp.uint32(1)) != jnp.uint32(0)

    return [_or_values(words, width, hit)]


def _member_ortree_row(words, *, width, patterns):
    """Shannon-factored static OR-tree over the block's bit planes (see
    scan._member_or_tree); all-ones when the set is the whole domain."""
    row = _member_or_tree(bitplanes(words, width), 0, width, patterns, {})
    return [jnp.full_like(words[0], 0xFFFFFFFF) if row is None else row]


# Keys folded per unrolled body; larger traced sets loop over key chunks
# (one compiled chunk instead of a body that grows with k).
_FOLD_CHUNK = 32


def _member_bitsliced_row(words, keys, *, width, k):
    """OR of the k bit-sliced key matches (XOR+AND plane folds); keys may
    be traced, out-of-domain keys match nothing."""
    planes = bitplanes(words, width)

    def fold(ks, count):
        acc = None
        for j in range(count):
            m = _plane_fold(planes, ks[j], width)
            acc = m if acc is None else acc | m
        return acc

    if k <= _FOLD_CHUNK:
        return [fold(keys, k)]
    nchunks = -(-k // _FOLD_CHUNK)
    pad = nchunks * _FOLD_CHUNK - k
    # all-ones padding keys are out of domain and match nothing
    keys = jnp.concatenate([keys, jnp.full((pad,), 0xFFFFFFFF, jnp.uint32)])

    def body(c, acc):
        ks = jax.lax.dynamic_slice(keys, (c * _FOLD_CHUNK,), (_FOLD_CHUNK,))
        return acc | fold(ks, _FOLD_CHUNK)

    zero = jnp.zeros_like(planes[0])
    return [jax.lax.fori_loop(0, nchunks, body, zero)]


def _one_row(body, tiles, n, operands, block_offset):
    bits, counts = driver.scan_xla(
        body, tiles, n, *operands, block_offset=block_offset
    )
    return bits[0], counts[0]


@functools.partial(jax.jit, static_argnames=("width", "n"))
def _member_compare_tiles(tiles, keys, block_offset, *, width, n):
    body = functools.partial(_member_compare_row, width=width, k=keys.shape[0])
    return _one_row(body, tiles, n, (keys,), block_offset)


@functools.partial(jax.jit, static_argnames=("width", "n"))
def _member_window_tiles(tiles, bases, pops, block_offset, *, width, n):
    body = functools.partial(_member_window_row, width=width, nwin=bases.shape[0])
    return _one_row(body, tiles, n, (bases, pops), block_offset)


@functools.partial(jax.jit, static_argnames=("width", "n"))
def _member_domain_tiles(tiles, table, block_offset, *, width, n):
    body = functools.partial(_member_domain_row, width=width)
    return _one_row(body, tiles, n, (table,), block_offset)


@functools.partial(jax.jit, static_argnames=("width", "n", "patterns"))
def _member_ortree_tiles(tiles, block_offset, *, width, n, patterns):
    body = functools.partial(_member_ortree_row, width=width, patterns=patterns)
    return _one_row(body, tiles, n, (), block_offset)


@functools.partial(jax.jit, static_argnames=("width", "n"))
def _member_bitsliced_tiles(tiles, keys, block_offset, *, width, n):
    body = functools.partial(_member_bitsliced_row, width=width, k=keys.shape[0])
    return _one_row(body, tiles, n, (keys,), block_offset)


def domain_table(keys, width: int) -> jax.Array:
    """Key set -> (2^width/32, 1) uint32 membership bitmap (bit ``v & 31``
    of word ``v >> 5`` set iff v is in the set).  Works on traced keys:
    the OR-scatter is a tiny (nwords, k) compare + OR-reduce, so
    duplicates merge correctly either way."""
    nwords = max(1, (1 << width) // 32)
    keys = jnp.asarray(keys, jnp.uint32)
    hi = (keys >> jnp.uint32(5)).astype(jnp.uint32)
    bit = jnp.uint32(1) << (keys & jnp.uint32(31))
    t = jnp.arange(nwords, dtype=jnp.uint32)
    terms = jnp.where(hi[None, :] == t[:, None], bit[None, :], jnp.uint32(0))
    tab = jax.lax.reduce(
        terms, jnp.uint32(0), jax.lax.bitwise_or, (1,)
    )
    return tab.reshape(nwords, 1)


def _domain_member_cost(width: int) -> int:
    """Static cost (quarter-ops-per-value) of the domain-bitmap tier:
    unpack ~14, high-bit predicates 3*(width-5), table-word select
    nwords-1, low-bit test + accumulate ~5.  Flat in k.  Widths past 12
    are priced out entirely (the table outgrows what the other tiers
    need at the key counts where it would win)."""
    if width > 12:
        return 1 << 30
    nwords = max(1, (1 << width) // 32)
    return 14 + 4 * (3 * max(0, width - 5) + (nwords - 1) + 5)


# DAG caps for the OR-tree tier; sets past them fall through to the
# flat-cost domain bitmap / compare tiers by the dispatch rule.
# _ORTREE_MAX_OPS bounds body size (compile time); _ORTREE_MAX_LIVE bounds
# the DAG's peak number of simultaneously live words.
_ORTREE_MAX_OPS = 4096
_ORTREE_MAX_LIVE = 256


def member_ortree_cost(width: int, arr) -> int:
    """Static cost (quarter-ops-per-value) of the OR-tree member tier
    for THIS key set: fixed unpack + pruned transpose (~40) plus the
    exact counted AND/OR/NOT ops of the factored DAG.  Sets whose DAG
    exceeds the ops or liveness caps are priced out (1 << 30)."""
    pats = np.asarray(arr, np.uint32).tolist()
    ops = _static_dag_ops(width, pats, member=True)
    if ops > _ORTREE_MAX_OPS:
        return 1 << 30
    if _static_dag_liveness(width, pats, member=True) > _ORTREE_MAX_LIVE:
        return 1 << 30
    return 40 + -(-ops // 8)


def _bitsliced_member_wins(width: int, k: int) -> bool:
    """Static cost rule, quarter-ops-per-value units: bit-sliced fixed
    cost ~48 (unpack + SWAPMOVE transpose) plus (2*width+1)/8 per key, vs
    the compare tier's ~10 per key."""
    return 48 + (2 * width + 1) * k // 8 < 10 * k


def _consecutive_span(arr: np.ndarray) -> int | None:
    """lo if the concrete keys are exactly the run lo..lo+k-1."""
    if arr.size == 0:
        return None
    lo = int(arr[0])
    return lo if (arr == lo + np.arange(arr.size, dtype=arr.dtype)).all() else None


def member_dispatch_tier(arr: np.ndarray, width: int) -> str:
    """The tier member_scan_tiles dispatches for concrete keys:
    'interval' | 'ortree' | 'window' | 'bitsliced' | 'domain' |
    'compare'.  THE single home of the dispatch cost rule
    (quarter-ops-per-value units: OR-tree 40 fixed + counted-DAG-ops/8,
    window ~20 per touched window, compare ~10 per key, bit-sliced 48
    fixed + (2*width+1)/8 per key, domain bitmap flat) — query.explain
    names tiers from this same function, so retuning the constants cannot
    desynchronize them."""
    arr = np.asarray(arr, dtype=np.uint32)
    k = int(arr.shape[0])
    if _consecutive_span(arr) is not None:
        return "interval"
    costs = {
        "ortree": member_ortree_cost(width, arr),
        "compare": 10 * k,
        "bitsliced": 48 + (2 * width + 1) * k // 8,
        "domain": _domain_member_cost(width),
    }
    bases, _ = member_window_plan(arr)
    if 20 * len(bases) < min(costs.values()):
        return "window"
    return min(costs, key=costs.get)


def member_scan_tiles(
    tiles: jax.Array,
    keys,
    width: int,
    n: int,
    block_offset: jax.Array | int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Membership scan -> (bits uint32[B1, 128], total count uint32).

    ``bits.reshape(-1)[:bitvector_words(n)]`` is the canonical LSB-first
    bitvector of ``value in keys``; the count is the number of matching
    values (duplicate keys in the set count once).

    The static dispatch inspects ``keys`` BEFORE any jnp conversion:
    inside a jit trace ``jnp.asarray`` stages even a numpy constant into
    a Tracer, which would silently demote concrete keys to the traced
    fallback tier."""
    traced = isinstance(keys, jax.core.Tracer)
    k = int(keys.shape[0] if traced else np.asarray(keys).shape[0])
    if k < 1:
        raise ValueError(f"member scan needs at least one key, got {k}")
    if not traced:
        arr = np.asarray(keys, dtype=np.uint32)
        tier = member_dispatch_tier(arr, width)
        if tier == "interval":
            lo = _consecutive_span(arr)
            bits, cnt = range_scan_tiles(
                tiles,
                jnp.asarray([lo], jnp.uint32),
                jnp.asarray([lo + k], jnp.uint32),
                width, n, block_offset=block_offset,
            )
            return bits[0], cnt[0]
        if tier == "ortree":
            dom = 1 << width
            pats = tuple(sorted({int(v) for v in arr.tolist() if int(v) < dom}))
            if not pats:
                # every key out of domain: nothing can match
                return jnp.zeros(tiles.shape[1:], jnp.uint32), jnp.uint32(0)
            return _member_ortree_tiles(
                tiles, block_offset, width=width, n=n, patterns=pats
            )
        if tier == "window":
            bases, pops = member_window_plan(arr)
            return _member_window_tiles(
                tiles, jnp.asarray(np.asarray(bases, np.uint32)),
                jnp.asarray(np.asarray(pops, np.uint32)), block_offset,
                width=width, n=n,
            )
        if tier == "domain":
            return _member_domain_tiles(
                tiles, domain_table(arr, width), block_offset, width=width, n=n
            )
    keys = jnp.asarray(keys, jnp.uint32).reshape(k)
    if _domain_member_cost(width) < min(10 * k, 48 + (2 * width + 1) * k // 8):
        # flat-in-k domain bitmap; the table build works on traced keys too
        return _member_domain_tiles(
            tiles, domain_table(keys, width), block_offset, width=width, n=n
        )
    if _bitsliced_member_wins(width, k):
        return _member_bitsliced_tiles(tiles, keys, block_offset, width=width, n=n)
    return _member_compare_tiles(tiles, keys, block_offset, width=width, n=n)


def member_scan_device(dev: DeviceColumn, keys) -> tuple[jax.Array, jax.Array]:
    """IN-list scan on a DeviceColumn -> ((W,) canonical bitvector words,
    scalar match count)."""
    bits, count = member_scan_tiles(dev.tiles, keys, dev.width, dev.n)
    return bits_to_canonical(bits, dev.n), count


__all__ = [
    "member_scan_tiles",
    "member_scan_device",
    "member_window_plan",
    "domain_table",
]
