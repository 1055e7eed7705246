"""Pure-jnp oracle implementations — the semantic ground truth.

Counterparts of the reference's scalar oracles:
``decompress_unvectorized`` (src/simd_scan_decompression.cpp:6-55) and
``scan_unvectorized`` (src/simd_scan.cpp:20-100).  Every tier in
``shared_simd_scan_tpu.ops`` is property-tested against these, mirroring the
reference's oracle test pattern (test/simd_scan_tests.cpp:20-43, 53-66).

These are vectorized jnp programs (per-value two-word gather + funnel
shift), not element loops — they run fine under jit on any backend and
double as a portable fallback path on any backend.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from shared_simd_scan_tpu import bitvector
from shared_simd_scan_tpu.layout import PackedColumn, bitvector_words


@functools.partial(jax.jit, static_argnames=("width", "n"))
def unpack_words(words: jax.Array, width: int, n: int) -> jax.Array:
    """Decompress canonical words -> (n,) uint32 values.

    Per value i: stream bits [i*width, i*width+width) via gather of word
    i*width//32 (and its successor when straddling) + funnel shift — the
    general-width form of the reference's shift/stitch loop
    (simd_scan_decompression.cpp:39-49), without its 2-phase mask-period
    bug for even widths (SURVEY.md §5 "do not replicate").
    """
    i = jnp.arange(n, dtype=jnp.uint32)
    start = i * jnp.uint32(width)
    k = (start >> 5).astype(jnp.int32)
    s = start & 31
    w0 = words[k]
    # w[k+1] is only read when it exists; clamp and zero the contribution
    # when s == 0 (no straddle possible since width <= 31).
    k1 = jnp.minimum(k + 1, words.shape[0] - 1)
    w1 = words[k1]
    hi = jnp.where(s == 0, jnp.uint32(0), w1 << ((32 - s) & 31))
    mask = jnp.uint32((1 << width) - 1)
    return ((w0 >> s) | hi) & mask


def unpack(col: PackedColumn) -> jax.Array:
    return unpack_words(col.words, col.width, col.n)


@functools.partial(jax.jit, static_argnames=("width", "n"))
def scan_words(
    words: jax.Array, predicate_key: jax.Array, width: int, n: int
) -> tuple[jax.Array, jax.Array]:
    """Single-predicate equality scan -> (bitvector uint32 words, hit count).

    Semantics of scan_unvectorized (simd_scan.cpp:20-100): LSB-first match
    bits, bits at i >= n zero, count = popcount of the bitvector.
    """
    vals = unpack_words(words, width, n)
    match = vals == jnp.asarray(predicate_key, jnp.uint32)
    bits = bitvector.from_bool(match)
    return bits, bitvector.popcount(bits)


def scan(col: PackedColumn, predicate_key) -> tuple[jax.Array, jax.Array]:
    return scan_words(col.words, predicate_key, col.width, col.n)


@functools.partial(jax.jit, static_argnames=("width", "n"))
def shared_scan_words(
    words: jax.Array, predicate_keys: jax.Array, width: int, n: int
) -> tuple[jax.Array, jax.Array]:
    """k-predicate shared scan -> ((k, words) bitvectors, (k,) hit counts).

    Semantics of shared_scan_128_sequential (simd_scan_shared.cpp:9-23):
    per-predicate bitvector outputs, identical bit layout to single scan.
    """
    vals = unpack_words(words, width, n)  # (n,)
    keys = jnp.asarray(predicate_keys, jnp.uint32)  # (k,)
    match = vals[None, :] == keys[:, None]  # (k, n)
    bits = jax.vmap(bitvector.from_bool)(match)  # (k, nwords)
    # uint32 accumulation: a per-key count can exceed 2^31-1 at narrow
    # widths (e.g. >2^31 matches in a 512 MiB width-1 column)
    counts = jnp.sum(
        jax.lax.population_count(bits).astype(jnp.uint32), axis=1
    )
    return bits, counts


def shared_scan(col: PackedColumn, predicate_keys) -> tuple[jax.Array, jax.Array]:
    return shared_scan_words(col.words, jnp.asarray(predicate_keys), col.width, col.n)


@functools.partial(jax.jit, static_argnames=("width", "n"))
def member_scan_words(
    words: jax.Array, predicate_keys: jax.Array, width: int, n: int
) -> tuple[jax.Array, jax.Array]:
    """IN-list membership scan -> (single bitvector words, total hit count).

    Ground truth for ops.member: bit i set iff value i is in the key set
    (duplicate keys count once — the bitvector is an OR).
    """
    vals = unpack_words(words, width, n)  # (n,)
    keys = jnp.asarray(predicate_keys, jnp.uint32)  # (k,)
    match = jnp.any(vals[None, :] == keys[:, None], axis=0)  # (n,)
    bits = bitvector.from_bool(match)
    return bits, jnp.sum(
        jax.lax.population_count(bits).astype(jnp.uint32)
    )


def member_scan(col: PackedColumn, predicate_keys) -> tuple[jax.Array, jax.Array]:
    return member_scan_words(
        col.words, jnp.asarray(predicate_keys), col.width, col.n
    )


def aggregate_scan(
    pcol: PackedColumn, mcol: PackedColumn, predicate_keys
) -> tuple["np.ndarray", "np.ndarray"]:
    """Ground truth for ops.aggregate: per-key exact SUM/COUNT of the
    measure column where the predicate column matches (host numpy)."""
    import numpy as np

    p = np.asarray(unpack(pcol))
    m = np.asarray(unpack(mcol)).astype(np.uint64)
    keys = np.asarray(predicate_keys, np.uint32)
    sums = np.array([m[p == k].sum() for k in keys], np.uint64)
    counts = np.array([(p == k).sum() for k in keys], np.uint32)
    return sums, counts


def shared_scan_linear(col: PackedColumn, predicate_keys) -> jax.Array:
    """Linear (interleaved) shared scan: one uint8 vector, byte layout
    ``out[group*k + key_id]`` for 8-value groups — byte-parity with
    shared_scan_128_linear_standard (simd_scan_shared_linear.cpp:57).
    """
    bits, _ = shared_scan(col, predicate_keys)  # (k, nwords) uint32
    k = bits.shape[0]
    nbytes = (col.n + 7) // 8
    # uint32 words -> little-endian bytes: (k, nwords*4) then interleave.
    b = jax.lax.shift_right_logical(
        bits[:, :, None], jnp.uint32(8) * jnp.arange(4, dtype=jnp.uint32)[None, None, :]
    ).astype(jnp.uint8)
    b = b.reshape(k, -1)[:, :nbytes]  # (k, nbytes)
    return b.T.reshape(-1)  # group-major, predicate minor
