"""Drivers: run a tier body over a packed column.

Every scan tier is a *body*, a pure function

    body(words, *operands) -> rows

``words`` is the list of the column's ``width`` word rows (row ``r`` holds
word ``r`` of every 32-value block, each row shaped ``(B, 128)`` for ``B``
block rows); ``operands`` are the tier's small runtime inputs (keys,
bounds), indexed by static position; ``rows`` is the list of k match
words (bit ``r`` of a word set iff value ``r`` of that block matches), or
``None`` for a constant-zero row.  Bodies use elementwise ``jnp``/``lax``
only, so one body runs under either driver:

- :func:`scan_xla` (every tier): the body on the whole ``(B1, 128)`` rows,
  compiled and fused by XLA; validity masking, counts and the stacked
  ``(k, B1, 128)`` output are plain ``jnp``.
- :func:`scan_triton`: one Pallas program (through Triton) per tile of
  ``TB`` block rows.  Each of the ``width`` word rows is its own
  ``(TB, 128)`` operand block, the body runs in registers, the k rows are
  stored once and each program writes its per-key count partials, so the
  bitvectors are never re-read for counting.

Padding and tail: blocks past the column's last value are zero-filled;
every driver ANDs each row with the validity word, so bits at value
index >= n are zero whatever the body returns (a key of 0 would
otherwise match padding).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from shared_simd_scan_tpu.layout import BLOCK_VALUES, LANES


def valid_for_blocks(g, n: int) -> jax.Array:
    """uint32 validity word of each global block id in ``g``: bit ``r``
    set iff value ``r`` of that block is a real element (index < n)."""
    full, rem = n // BLOCK_VALUES, n % BLOCK_VALUES
    return jnp.where(
        g < full,
        jnp.uint32(0xFFFFFFFF),
        jnp.where(
            g == full, jnp.uint32((1 << rem) - 1 if rem else 0), jnp.uint32(0)
        ),
    )


def valid_word(row0, shape, n: int, block_offset=0) -> jax.Array:
    """Validity words for block rows ``row0 .. row0 + shape[0]`` (global
    block id = ``block_offset + row * 128 + lane``; sharded callers pass
    the shard's first global block as ``block_offset``)."""
    row = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    lane = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    return valid_for_blocks(block_offset + (row0 + row) * LANES + lane, n)


def word_rows(tiles: jax.Array) -> list[jax.Array]:
    """Device tiles uint32[width, B1, 128] -> the body's word-row list."""
    return [tiles[r] for r in range(tiles.shape[0])]


def masked_rows(body, tiles, n, operands, block_offset):
    """Run ``body`` on the whole column; rows ANDed with the validity word
    (None rows become zeros)."""
    rows = body(word_rows(tiles), *operands)
    valid = valid_word(0, tiles.shape[1:], n, block_offset)
    zero = jnp.zeros(tiles.shape[1:], jnp.uint32)
    return [zero if r is None else r & valid for r in rows]


def popcount_sum(word: jax.Array) -> jax.Array:
    """Exact uint32 count of set bits (n < 2^32 by layout.MAX_VALUES)."""
    return jnp.sum(jax.lax.population_count(word), dtype=jnp.uint32)


def scan_xla(body, tiles, n, *operands, block_offset=0):
    """-> (bits uint32[k, B1, 128], counts uint32[k]) through XLA."""
    rows = masked_rows(body, tiles, n, operands, block_offset)
    bits = jnp.stack(rows)
    counts = jnp.sum(
        jax.lax.population_count(bits), axis=(1, 2), dtype=jnp.uint32
    )
    return bits, counts


def count_xla(body, tiles, n, *operands, block_offset=0):
    """Counts-only form of :func:`scan_xla` -> uint32[k]: no bitvector is
    materialized, each row is reduced where it is made."""
    rows = masked_rows(body, tiles, n, operands, block_offset)
    return jnp.stack([popcount_sum(r) for r in rows])


# ---------------------------------------------------------------------------
# Triton driver
# ---------------------------------------------------------------------------

# Block rows per program and warps per program.  A (TB, 128) uint32 word
# row costs TB registers per thread at 4 warps; the bodies keep up to ~32
# rows live (the bit-plane transpose), so TB stays small.  Other settings
# (TB 2-8, 4-8 warps) moved the k=8 tiers by < 10 % on the card (PERF.md).
TRITON_TB = 4
TRITON_WARPS = 4


def triton_interpret() -> bool:
    """THE interpret switch of the library, for the Triton driver alone:
    interpreted on the CPU backend (tests), compiled on ``gpu``."""
    platform = jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(
        f"the Triton scan driver runs on 'gpu' (compiled) or 'cpu' "
        f"(interpreted), not on {platform!r}"
    )


def _popcount32(x):
    """SWAR population count of uint32 words (Triton does not lower
    ``population_count``)."""
    x = x - ((x >> jnp.uint32(1)) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> jnp.uint32(2)) & jnp.uint32(0x33333333))
    x = (x + (x >> jnp.uint32(4))) & jnp.uint32(0x0F0F0F0F)
    x = x + (x >> jnp.uint32(8))
    x = x + (x >> jnp.uint32(16))
    return x & jnp.uint32(0x3F)


def _tile_rows(b1: int, tb: int) -> int:
    """Largest power of two <= tb dividing b1 (b1 is a multiple of 8)."""
    while b1 % tb:
        tb //= 2
    return tb


def scan_triton(body, tiles, operands, block_offset, *, k, n):
    """-> (bits uint32[k, B1, 128], counts uint32[k]) through one Pallas
    Triton program per tile of :data:`TRITON_TB` block rows (call it
    inside the tier's jit).  ``operands`` is a tuple of small 1-D arrays,
    each loaded whole by every program and read one scalar at a time.
    Each program stores its k rows straight into the ``(k, B1, 128)``
    output (one ``(TB, 128)`` store per key) and its k count partials."""
    from jax.experimental.pallas import triton as pl_triton

    width, b1, lanes = tiles.shape
    assert lanes == LANES
    tb = _tile_rows(b1, TRITON_TB)
    nops = len(operands)
    off = jnp.asarray(block_offset, jnp.int32).reshape(1)

    def kernel(off_ref, *refs):
        op_refs = refs[:nops]
        words = [r[...] for r in refs[nops:nops + width]]
        bits_ref, cnt_ref = refs[nops + width:]
        rows = body(words, *op_refs)
        assert len(rows) == k
        valid = valid_word(pl.program_id(0) * tb, (tb, LANES), n, off_ref[0])
        zero = jnp.zeros((tb, LANES), jnp.uint32)
        for j, row in enumerate(rows):
            w = zero if row is None else row & valid
            bits_ref[j] = w
            cnt_ref[j] = jnp.sum(_popcount32(w).astype(jnp.int32))

    row_specs = [
        pl.BlockSpec((None, tb, LANES), functools.partial(lambda r, i: (r, i, 0), r))
        for r in range(width)
    ]
    bits, cnt = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((k, b1, LANES), jnp.uint32),
            jax.ShapeDtypeStruct((b1 // tb, k), jnp.int32),
        ),
        grid=(b1 // tb,),
        in_specs=[pl.BlockSpec((1,), lambda i: (0,))]
        + [pl.BlockSpec(op.shape, lambda i: (0,)) for op in operands]
        + row_specs,
        out_specs=(
            pl.BlockSpec((k, tb, LANES), lambda i: (0, i, 0)),
            pl.BlockSpec((None, k), lambda i: (i, 0)),
        ),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=TRITON_WARPS, num_stages=1),
        interpret=triton_interpret(),
        name="scan_triton",
    )(off, *operands, *([tiles] * width))
    return bits, jnp.sum(cnt.astype(jnp.uint32), axis=0)
