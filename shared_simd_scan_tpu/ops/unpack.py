"""Unpack (decompress) and pack (compress) of device-layout columns.

Re-design of the reference's SSE/AVX unpack kernels
(src/simd_scan_decompression.cpp:57-471, ``decompress_128*`` /
``decompress_256*``) and the scalar compressor
(src/simd_scan_compression.cpp:53-104 ``compress_9bit_input``).

Instead of the reference's ``_mm_shuffle_epi8`` + per-lane multiply trick
we exploit the device tile layout ``tiles[width, B1, 128]`` (see
layout.DeviceColumn): one 32-value block <-> ``width`` uint32 words placed
along a *static* leading axis.  For output value ``r`` of every block, the
source word indices and shift amounts are compile-time constants
(layout.unpack_schedule), so unpack is a fully unrolled sequence of 32
elementwise ops

    v_r = ((w[k_r] >> s_r) | (w[k_r+1] << (32 - s_r))) & mask

over whole ``(B1, 128)`` word rows — the same right-shift+AND formulation
as the reference's AVX2 variant (``decompress_256_avx2``,
simd_scan_decompression.cpp:427-470), which SURVEY.md §2.1/C5 identifies
as the form closest to a wide vector machine.  No gathers, no shuffles,
no multiplies; XLA fuses the whole schedule.

The value output layout is ``vals[32, B1, 128]`` ("device value layout"):
``vals[r, b1, lane]`` = value ``r`` of block ``b1*128 + lane``.  Flat (n,)
order is one transpose away (:func:`values_to_flat`).  Scans fuse their
own unpack (:func:`unpack_value_at` inside each tier body), so these
entry points are off the query hot path.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from shared_simd_scan_tpu.layout import (
    BLOCK_VALUES,
    LANES,
    DeviceColumn,
    pack_schedule,
    unpack_schedule,
)


def unpack_value_at(words, width: int, r: int):
    """Value r (0..31) of every block: ``words`` is the list (or array) of
    the ``width`` word rows; returns one row of uint32 values."""
    k, s, straddles = unpack_schedule(width)[r]
    v = words[k] >> jnp.uint32(s)
    if straddles:
        v = v | (words[k + 1] << jnp.uint32(32 - s))
    return v & jnp.uint32((1 << width) - 1)


def unpack_values(words, width: int) -> list:
    """All 32 value rows of a block row set, in value-slot order."""
    return [unpack_value_at(words, width, r) for r in range(BLOCK_VALUES)]


@functools.partial(jax.jit, static_argnames=("width",))
def unpack_tiles(tiles: jax.Array, width: int) -> jax.Array:
    """tiles uint32[width, B1, 128] -> values uint32[32, B1, 128]
    (counterpart of decompress_128/256*, simd_scan_decompression.cpp:237-470)."""
    assert tiles.shape[2] == LANES
    return jnp.stack(unpack_values(tiles, width))


def values_to_flat(vals: jax.Array, n: int) -> jax.Array:
    """Device value layout [32, B1, 128] -> flat (n,) canonical order."""
    return vals.transpose(1, 2, 0).reshape(-1)[:n]


def flat_to_values(flat: jax.Array, b1: int) -> jax.Array:
    """Flat values (zero-padded to b1*128*32) -> device value layout."""
    return flat.reshape(b1, LANES, BLOCK_VALUES).transpose(2, 0, 1)


def unpack_device(dev: DeviceColumn) -> jax.Array:
    """Decompress a DeviceColumn -> (n,) uint32 values in canonical order."""
    return values_to_flat(unpack_tiles(dev.tiles, dev.width), dev.n)


def pack_words(vals, width: int) -> list:
    """The ``width`` packed word rows of 32 value rows (values masked to
    ``width`` bits; straddling values split across two words)."""
    mask = jnp.uint32((1 << width) - 1)
    out = []
    for contribs in pack_schedule(width):
        w = None
        for r, shift, right in contribs:
            v = vals[r] & mask
            part = (v >> jnp.uint32(shift)) if right else (v << jnp.uint32(shift))
            w = part if w is None else (w | part)
        out.append(w)
    return out


@functools.partial(jax.jit, static_argnames=("width",))
def pack_tiles(vals: jax.Array, width: int) -> jax.Array:
    """values uint32[32, B1, 128] -> tiles uint32[width, B1, 128].

    Device-side compressor (counterpart of compress_9bit_input,
    simd_scan_compression.cpp:53-104, generalized to widths 1..31 with
    explicit shifts — no shift-count UB, SURVEY.md §5)."""
    assert vals.shape[2] == LANES
    return jnp.stack(pack_words(vals, width))


@functools.partial(jax.jit, static_argnames=("width", "bp"))
def _pack_flat(values: jax.Array, width: int, bp: int) -> jax.Array:
    flat = jnp.zeros(bp * BLOCK_VALUES, jnp.uint32)
    flat = jax.lax.dynamic_update_slice(flat, values.astype(jnp.uint32), (0,))
    return jnp.stack(pack_words(flat_to_values(flat, bp // LANES), width))


def pack_device_kernel(values: jax.Array, width: int) -> DeviceColumn:
    """Compress flat (n,) values on the device into a DeviceColumn in one
    compiled program — the scalable path for large columns
    (layout.pack_device's jnp path materializes (B, 32) temporaries)."""
    from shared_simd_scan_tpu.layout import padded_blocks  # local: avoid cycle

    n = int(values.shape[0])
    tiles = _pack_flat(values, width, padded_blocks(n))
    return DeviceColumn(width=width, n=n, tiles=tiles)
