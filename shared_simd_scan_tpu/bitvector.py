"""LSB-first match bitvectors (scan outputs).

Counterpart of the reference's bitvector helpers
(src/util.cpp:51-58 ``get_bit`` uint8 overload — the correct one; we do not
replicate the buggy uint32 overload at util.cpp:60-67 — and the POPCNT
macro, src/util.hpp:17-25).

Contract: bit ``i`` of the match set (value i matched) lives at stream bit
``i``: stored in little-endian uint32 words, word ``i // 32`` bit ``i % 32``
== byte ``i // 8`` bit ``i % 8`` — byte-identical to the reference's
movemask packing order (src/simd_scan.cpp:132,145).  Bits at i >= n are
always zero (the reference's scalar oracle semantics, simd_scan.cpp:93-97;
its vectorized kernels write padding garbage instead, which its own tests
never read).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def get_bit(bits: jax.Array | np.ndarray, i) -> jax.Array:
    """Bit i of an LSB-first bitvector stored in uint32 words (bool)."""
    w = jnp.asarray(bits)
    assert w.dtype == jnp.uint32
    return ((w[i // 32] >> (jnp.uint32(i) % 32)) & 1).astype(jnp.bool_)


def to_bool(bits: jax.Array, n: int) -> jax.Array:
    """Expand uint32 bitvector words into a (n,) bool array."""
    w = jnp.asarray(bits).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    expanded = ((w[:, None] >> shifts[None, :]) & 1).astype(jnp.bool_)
    return expanded.reshape(-1)[:n]


def from_bool(mask: jax.Array) -> jax.Array:
    """Pack a (n,) bool array into LSB-first uint32 bitvector words."""
    m = jnp.asarray(mask).astype(jnp.uint32)
    n = m.shape[0]
    pad = (-n) % 32
    if pad:
        m = jnp.concatenate([m, jnp.zeros(pad, jnp.uint32)])
    m = m.reshape(-1, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(m << shifts[None, :], axis=1, dtype=jnp.uint32)


def logical_and(*bits: jax.Array) -> jax.Array:
    """AND of same-length bitvectors, word-wise (predicate composition:
    ``a AND b AND ...`` over match bitvectors from any kernel tier)."""
    out = jnp.asarray(bits[0]).astype(jnp.uint32)
    for b in bits[1:]:
        out = out & jnp.asarray(b).astype(jnp.uint32)
    return out


def logical_or(*bits: jax.Array) -> jax.Array:
    """OR of same-length bitvectors, word-wise."""
    out = jnp.asarray(bits[0]).astype(jnp.uint32)
    for b in bits[1:]:
        out = out | jnp.asarray(b).astype(jnp.uint32)
    return out


def logical_not(bits: jax.Array, n: int) -> jax.Array:
    """NOT of a bitvector over n values; bits at i >= n stay zero (the
    library-wide tail invariant — a plain word complement would set
    them)."""
    w = ~jnp.asarray(bits).astype(jnp.uint32)
    if n % 32:
        tail = jnp.uint32((1 << (n % 32)) - 1)
        w = w.at[-1].set(w[-1] & tail)
    return w


def logical_andnot(a: jax.Array, b: jax.Array) -> jax.Array:
    """``a AND NOT b`` word-wise.  No tail masking needed: a's tail bits
    are already zero by the library invariant."""
    return jnp.asarray(a).astype(jnp.uint32) & ~jnp.asarray(b).astype(jnp.uint32)


def popcount(bits: jax.Array) -> jax.Array:
    """Total set bits across the bitvector words (uint32; counts can
    exceed 2^31-1 for multi-billion-value columns at narrow widths)."""
    return jnp.sum(
        jax.lax.population_count(jnp.asarray(bits).astype(jnp.uint32)).astype(jnp.uint32)
    )


def rank(bits: jax.Array, i) -> jax.Array:
    """Number of set bits strictly below position i (uint32) — the
    classic rank query, e.g. the output offset of row i in a compacted
    materialization."""
    w = jnp.asarray(bits).astype(jnp.uint32)
    word = i // 32
    full = jnp.sum(
        jnp.where(
            jnp.arange(w.shape[0]) < word,
            jax.lax.population_count(w),
            jnp.uint32(0),
        ).astype(jnp.uint32)
    )
    part = jax.lax.population_count(
        w[jnp.minimum(word, w.shape[0] - 1)]
        & (jnp.uint32(1) << jnp.uint32(i % 32)) - jnp.uint32(1)
    ).astype(jnp.uint32)
    return full + jnp.where(jnp.asarray(word) < w.shape[0], part, 0)


def match_indices(
    bits: jax.Array, n: int, size: int, fill_value: int | None = None
) -> tuple[jax.Array, jax.Array]:
    """Materialize matching row indices from a match bitvector.

    Returns (indices int32[size], count): the positions of set bits in
    ascending order, padded with ``fill_value`` (default n).  ``size`` is
    the static output capacity (XLA needs static shapes); indices beyond
    ``count`` are padding.  This is the match-index materialization step
    the reference leaves to the caller (its outputs stop at bitvectors).
    """
    mask = to_bool(bits, n)
    fill = n if fill_value is None else fill_value
    (idx,) = jnp.nonzero(mask, size=size, fill_value=fill)
    return idx.astype(jnp.int32), jnp.sum(mask.astype(jnp.int32))


def to_bytes(bits: jax.Array, n: int) -> bytes:
    """Exact ceil(n/8) payload bytes — byte-parity with the reference."""
    raw = np.asarray(jax.device_get(bits)).astype("<u4").tobytes()
    return raw[: (n + 7) // 8]


def from_bytes(data: bytes, n: int) -> jax.Array:
    nwords = (n + 31) // 32
    buf = np.zeros(nwords, dtype="<u4")
    payload = np.frombuffer(data[: (n + 7) // 8], dtype=np.uint8)
    buf.view(np.uint8)[: payload.shape[0]] = payload
    if n % 32:
        buf[-1] &= np.uint32((1 << (n % 32)) - 1)
    return jnp.asarray(buf)
