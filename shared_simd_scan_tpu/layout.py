"""Bit-packed column layout: buffer contracts, packing, and device tiling.

This module owns the storage format of the library and is the
re-design of the reference's buffer-size contract and compressor
(reference: src/simd_scan.hpp:20-40 ``compressed_buffer_size`` /
``decompression_output_buffer_size`` / ``scan_output_buffer_size``;
src/simd_scan_compression.cpp:53-104 ``compress_9bit_input``).

Canonical format (byte-parity with the reference)
-------------------------------------------------
A column of ``n`` unsigned integers, each ``width`` bits (1..31), is a flat
LSB-first bitstream: value ``i`` occupies stream bits ``[i*width, (i+1)*width)``
with its own LSB first.  The stream is stored in little-endian ``uint32``
words, so stream bit ``j`` lives at byte ``j // 8``, bit ``j % 8`` — exactly
the byte layout the reference produces with little-endian ``uint64`` words
(the straddle-split at simd_scan_compression.cpp:82-99 is equivalent to this
flat-bitstream definition; we do *not* replicate its shift-count UB, see
SURVEY.md §5 "do not replicate").

Device format (tile layout)
--------------------------
The key identity: **32 values at width c occupy exactly c uint32 words**
(32*c bits).  A "block" is 32 consecutive values <-> c consecutive words,
and every block starts word-aligned.  The device layout transposes blocks
into the lane dimension:

    device[c, B1, 128]   where block b = b1*128 + lane holds words
                         canonical[b*c : (b+1)*c] along axis 0.

With this layout the scan tiers need **no gathers and no byte
shuffles** (the reference's ``_mm_shuffle_epi8`` heart, SURVEY.md §7 "hard
parts"): for output value r in 0..31 the source words are *static* rows
``device[k_r]`` / ``device[k_r+1]`` and the shifts are scalar constants —
each row op processes 128 blocks per block row at once.

All sizes here are element counts / shapes, not raw bytes; the only byte
quantities are in :func:`packed_nbytes` (used for bytes/s accounting and
parity checks).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

# Blocks per device row; the block axis is tiled by this (storage format,
# shared with csrc/sss_host.cpp and io.py).
LANES = 128
# Row granularity: the device block axis (B1) is padded to a multiple of
# this, so every shard and every Triton tile covers whole 8-row groups.
SUBLANES = 8
# Values per block. Fixed by the uint32 word size: 32 values * c bits = c words.
BLOCK_VALUES = 32

MIN_WIDTH = 1
MAX_WIDTH = 31


# Hit counts are uint32 end-to-end (device arithmetic is 32-bit: JAX runs
# without 64-bit types).  A single key can match
# at most n rows, so capping the column at 2^32 - 1 values makes count
# overflow impossible rather than silent.  At width 1 that is a 512 MiB
# packed column; wider columns hit memory limits long before this cap.
MAX_VALUES = (1 << 32) - 1


def _check_width(width: int) -> None:
    if not (MIN_WIDTH <= int(width) <= MAX_WIDTH):
        raise ValueError(f"width must be in [{MIN_WIDTH}, {MAX_WIDTH}], got {width}")


def _check_n(n: int) -> None:
    if not (0 <= int(n) <= MAX_VALUES):
        raise ValueError(
            f"column length {n} exceeds MAX_VALUES={MAX_VALUES}: hit counts "
            "are uint32 and a key matching >= 2^32 rows would wrap; split "
            "the data into per-shard columns below the limit (e.g. one "
            "io.load_table column per host/device) and combine counts "
            "downstream"
        )


def packed_nbytes(width: int, n: int) -> int:
    """Exact payload bytes of a packed column (no padding).

    Mirrors the un-padded part of the reference's buffer-size contract
    (simd_scan.hpp:20-26): ceil(n*width/8).
    """
    _check_width(width)
    return (n * width + 7) // 8


def packed_words(width: int, n: int) -> int:
    """Number of canonical uint32 words covering the payload."""
    return (n * width + 31) // 32


def num_blocks(n: int) -> int:
    """Blocks of 32 values covering n values (last block may be partial)."""
    return (n + BLOCK_VALUES - 1) // BLOCK_VALUES


def padded_blocks(n: int, lanes: int = LANES) -> int:
    """Blocks padded up to a multiple of the (8-row, 128-lane) device tile.

    B1 = padded_blocks(n) // LANES is padded to a power-of-two-friendly
    multiple so power-of-two row tiles (up to 512) divide it:
    small columns pad B1 to a multiple of 8, mid-size to 64, large to 512.
    Worst-case padding overhead stays under ~12% and vanishes for large
    columns; padding blocks are zero and masked by the kernels' validity
    word, so only footprint is affected, never results.
    """
    b = max(num_blocks(n), 1)
    b1 = (b + lanes - 1) // lanes
    if b1 >= 4096:
        mult = 512
    elif b1 >= 256:
        mult = 64
    else:
        mult = SUBLANES
    b1 = ((b1 + mult - 1) // mult) * mult
    return b1 * lanes


def bitvector_words(n: int) -> int:
    """uint32 words in a match bitvector for n values (scan output contract).

    Analog of scan_output_buffer_size (simd_scan.hpp:35-40) minus padding:
    we size exactly and mask the tail instead of over-writing padded bytes.
    """
    return (n + 31) // 32


def unpack_schedule(width: int) -> list[tuple[int, int, bool]]:
    """Static per-value unpack schedule for one 32-value block.

    For value r in 0..31: returns (word_index k, shift s, straddles) where
    the value is ``(w[k] >> s) | (w[k+1] << (32-s))`` masked to ``width``
    bits; ``straddles`` is False when w[k+1] is not needed.

    This is the portable spec of the reference's mask math: the shuffle /
    shift / clean mask generators (simd_scan_commons.hpp:5-90, M1-M5 in
    SURVEY.md §2.2) and the prototype tables in
    scripts/decompression_masks*.py collapse to this single table because
    the device layout makes word indices static rows.

    Note k+1 <= width-1 always: value 31 ends exactly at bit 32*width, so a
    block never reads its neighbour's words.
    """
    _check_width(width)
    sched = []
    for r in range(BLOCK_VALUES):
        p = r * width
        k, s = p // 32, p % 32
        straddles = s + width > 32
        assert (not straddles) or (k + 1 <= width - 1)
        sched.append((k, s, straddles))
    return sched


# ---------------------------------------------------------------------------
# Packing (compression)
# ---------------------------------------------------------------------------


def pack_schedule(width: int) -> list[list[tuple[int, int, bool]]]:
    """Inverse schedule: for each word j in 0..width-1 of a block, the list of
    (value_index r, shift, is_right_shift) contributions.

    ``is_right_shift`` True means the contribution is ``value >> shift``
    (the high part of a straddling value), else ``value << shift``.
    """
    _check_width(width)
    contribs: list[list[tuple[int, int, bool]]] = [[] for _ in range(width)]
    for r, (k, s, straddles) in enumerate(unpack_schedule(width)):
        contribs[k].append((r, s, False))
        if straddles:
            contribs[k + 1].append((r, 32 - s, True))
    return contribs


@functools.partial(jax.jit, static_argnames=("width", "n_padded_blocks"))
def _pack_blocks(values32: jax.Array, width: int, n_padded_blocks: int) -> jax.Array:
    """values32: (B, 32) uint32 -> (B, width) uint32 block words. Traceable."""
    del n_padded_blocks  # only part of the jit key
    _check_width(width)
    mask = jnp.uint32((1 << width) - 1)
    vals = values32 & mask
    words = []
    for contribs in pack_schedule(width):
        w = jnp.zeros(vals.shape[0], jnp.uint32)
        for r, shift, right in contribs:
            v = vals[:, r]
            w = w | ((v >> shift) if right else (v << shift))
        words.append(w)
    return jnp.stack(words, axis=1)


def _to_block_values(values: jax.Array | np.ndarray, n: int) -> jax.Array:
    v = jnp.asarray(values).astype(jnp.uint32)
    if v.ndim != 1 or v.shape[0] != n:
        raise ValueError(f"expected 1-D values of length {n}")
    b = num_blocks(n)
    pad = b * BLOCK_VALUES - n
    if pad:
        v = jnp.concatenate([v, jnp.zeros(pad, jnp.uint32)])
    return v.reshape(b, BLOCK_VALUES)


@dataclasses.dataclass(frozen=True)
class PackedColumn:
    """A bit-packed column in canonical flat-word form.

    ``words``: uint32[packed_words_padded] — the canonical LSB-first stream,
    zero-padded to whole blocks (num_blocks(n) * width words).
    """

    width: int
    n: int
    words: jax.Array  # uint32[num_blocks(n) * width]

    def __post_init__(self):
        _check_width(self.width)
        _check_n(self.n)

    @property
    def nbytes_payload(self) -> int:
        return packed_nbytes(self.width, self.n)

    def to_bytes(self) -> bytes:
        """Exact payload bytes — byte-for-byte the reference's buffer."""
        raw = np.asarray(jax.device_get(self.words)).astype("<u4").tobytes()
        return raw[: self.nbytes_payload]

    @classmethod
    def from_bytes(cls, data: bytes, width: int, n: int) -> "PackedColumn":
        _check_width(width)
        need_words = num_blocks(n) * width
        buf = np.zeros(need_words, dtype="<u4")
        payload = np.frombuffer(data[: packed_nbytes(width, n)], dtype=np.uint8)
        byte_view = buf.view(np.uint8)
        byte_view[: payload.shape[0]] = payload
        # zero any bits beyond n*width inside the last payload byte
        used_bits = n * width
        if used_bits % 8:
            byte_view[used_bits // 8] &= (1 << (used_bits % 8)) - 1
        return cls(width=width, n=n, words=jnp.asarray(buf))


def pack(values, width: int) -> PackedColumn:
    """Compress values (1-D, uint) into a canonical PackedColumn.

    Counterpart of compress_9bit_input
    (simd_scan_compression.cpp:53-104) generalized to widths 1..31;
    fully vectorized (32 static lane-wise OR steps), no per-element loop.
    """
    n = int(np.asarray(values).shape[0]) if not hasattr(values, "shape") else int(values.shape[0])
    blocks = _to_block_values(values, n)
    words = _pack_blocks(blocks, width, blocks.shape[0])
    return PackedColumn(width=width, n=n, words=words.reshape(-1))


# ---------------------------------------------------------------------------
# Device tiling
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceColumn:
    """A packed column in device tile layout: uint32[width, B1, 128].

    Block b = b1*128 + lane; axis 0 is the word-within-block axis. ``n`` is
    the true value count; blocks past num_blocks(n) are zero padding.
    """

    width: int
    n: int
    tiles: jax.Array  # uint32[width, B1, LANES]

    def __post_init__(self):
        _check_width(self.width)
        _check_n(self.n)

    @property
    def padded_values(self) -> int:
        return self.tiles.shape[1] * LANES * BLOCK_VALUES


@functools.partial(jax.jit, static_argnames=("width", "bp"))
def _relayout_to_device(words: jax.Array, width: int, bp: int) -> jax.Array:
    b = words.shape[0] // width
    blocks = words.reshape(b, width)
    if bp != b:
        blocks = jnp.concatenate(
            [blocks, jnp.zeros((bp - b, width), jnp.uint32)], axis=0
        )
    return blocks.T.reshape(width, bp // LANES, LANES)


@functools.partial(jax.jit, static_argnames=("width", "b"))
def _relayout_to_canonical(tiles: jax.Array, width: int, b: int) -> jax.Array:
    bp = tiles.shape[1] * LANES
    return tiles.reshape(width, bp).T[:b].reshape(b * width)


def to_device(col: PackedColumn) -> DeviceColumn:
    """One-time relayout canonical -> device tile layout (single XLA transpose)."""
    bp = padded_blocks(col.n)
    return DeviceColumn(
        width=col.width, n=col.n, tiles=_relayout_to_device(col.words, col.width, bp)
    )


def to_canonical(dev: DeviceColumn) -> PackedColumn:
    b = num_blocks(dev.n)
    return PackedColumn(
        width=dev.width,
        n=dev.n,
        words=_relayout_to_canonical(dev.tiles, dev.width, b),
    )


def pack_device(values, width: int) -> DeviceColumn:
    """Compress straight into device layout (no canonical materialization)."""
    n = int(values.shape[0])
    blocks = _to_block_values(values, n)
    words = _pack_blocks(blocks, width, blocks.shape[0])  # (B, width)
    bp = padded_blocks(n)
    if bp != words.shape[0]:
        words = jnp.concatenate(
            [words, jnp.zeros((bp - words.shape[0], width), jnp.uint32)], axis=0
        )
    tiles = words.T.reshape(width, bp // LANES, LANES)
    return DeviceColumn(width=width, n=n, tiles=tiles)
