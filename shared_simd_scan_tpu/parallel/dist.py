"""Data-parallel column sharding across a device mesh.

The reference tops out at OpenMP threads over the *predicate* axis on one
CPU (src/simd_scan_shared.cpp:27-32; SURVEY.md §2.4 "Distributed (absent)").
Here multi-device scale is a first-class component: the packed column is
sharded **along the block axis** over a 1-D ``('data',)`` mesh, the
predicate table is replicated, every device runs the same tier on its
local shard, and per-shard hit counts are reduced with ``jax.lax.psum``
(NCCL on NVLinked GPUs).  Bitvector outputs stay sharded (gather only on
demand).  Every device reaches every other at the same rate, so the mesh
follows the algorithm alone: one axis.

Sharding safety: the reference's packed stream cannot be cut at arbitrary
points because values straddle word boundaries
(simd_scan_compression.cpp:82-99 — SURVEY.md §7 "sharding the packed
stream").  Our device layout dissolves the problem: one block = 32 values =
``width`` whole uint32 words, so ANY block-aligned cut is self-contained.
We shard at (8 block rows × 128 lanes)-aligned block boundaries, padding
with zero blocks that the tiers' validity mask ignores.

Multi-process: under ``jax.distributed.initialize`` the same code runs
unchanged — ``make_mesh()`` spans all processes' devices.  Tested on a
forced multi-device CPU platform (tests/conftest.py) and on CPU process
groups (scripts/run_multiproc_demo.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from shared_simd_scan_tpu.layout import (
    BLOCK_VALUES,
    LANES,
    SUBLANES,
    DeviceColumn,
)
from shared_simd_scan_tpu.ops import scan as scan_ops
from shared_simd_scan_tpu.ops import unpack as unpack_ops

DATA_AXIS = "data"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-process group setup (wraps jax.distributed.initialize).

    Call once per process before any device use; afterwards
    ``make_mesh()`` spans every process's devices and the sharded scans
    run unchanged.  Pass the coordinator address (``host:port``), the
    process count and this process's id explicitly."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(devices=None) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def fetch_global(x) -> np.ndarray:
    """Host numpy view of a jax.Array that may span other processes.

    Shard-local partials (sum limbs, min/max grids) keep a
    P(DATA_AXIS, ...) sharding; on a multi-process mesh the remote shards
    are not addressable and a plain ``np.asarray`` raises.  The partial
    grids are tiny (steps x k x LANES), so an allgather is the right
    tool — every process finalizes identically (collective: every
    process must call this)."""
    if all(
        d.process_index == jax.process_index() for d in x.sharding.device_set
    ):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _pad_b1(tiles: jax.Array, multiple: int) -> jax.Array:
    b1 = tiles.shape[1]
    target = ((b1 + multiple - 1) // multiple) * multiple
    if target == b1:
        return tiles
    pad = [(0, 0), (0, target - b1), (0, 0)]
    return jnp.pad(tiles, pad)


def shard_column(dev: DeviceColumn, mesh: Mesh) -> DeviceColumn:
    """Place a DeviceColumn's tiles data-parallel along the block axis.

    Pads B1 to a multiple of (mesh size × SUBLANES) so every shard keeps
    the layout's 8-row granularity, then applies NamedSharding
    (None, 'data', None).

    On a multi-process mesh (``dist.initialize`` across hosts) the host
    array cannot be device_put to non-addressable devices; every process
    is assumed to hold the same host copy (replicated build, the demo /
    test path — production loads per-shard from io.load_table) and only
    the locally-addressable shards are materialized.
    """
    nd = mesh.devices.size
    tiles = _pad_b1(dev.tiles, nd * SUBLANES)
    sharding = NamedSharding(mesh, P(None, DATA_AXIS, None))
    if all(
        d.process_index == jax.process_index() for d in mesh.devices.flat
    ):
        tiles = jax.device_put(tiles, sharding)
    else:
        host = np.asarray(tiles)
        tiles = jax.make_array_from_callback(
            host.shape, sharding, lambda idx: host[idx]
        )
    return DeviceColumn(width=dev.width, n=dev.n, tiles=tiles)


def _traced_scan(tiles, keys, width, n, off):
    """Shard-local scan of traced keys: the single-device rule (bit-sliced
    tier past the cost crossover, else compare)."""
    fn = (
        scan_ops.shared_scan_bitsliced_tiles
        if scan_ops._bitsliced_wins(width, int(keys.shape[0]))
        else scan_ops.shared_scan_tiles
    )
    return fn(tiles, keys, width, n, block_offset=off)


def _concrete_scan(tiles, keys_tuple, width, n, off):
    """Shard-local scan of a concrete key set through the single-device
    dispatch rule (scan_ops.pick_concrete_tier, its one home)."""
    keys = np.asarray(keys_tuple, np.uint32)
    tier, lo = scan_ops.pick_concrete_tier(width, keys)
    if tier == "interval":
        return scan_ops.interval_scan_tiles(
            tiles, lo, len(keys_tuple), width, n, block_offset=off
        )
    if tier == "windowed":
        return scan_ops.windowed_scan_tiles(tiles, keys, width, n, block_offset=off)
    if tier == "bitsliced_static":
        return scan_ops.shared_scan_bitsliced_static_tiles(
            tiles, keys, width, n, block_offset=off
        )
    return scan_ops.shared_scan_tiles(
        tiles, jnp.asarray(keys), width, n, block_offset=off
    )


@functools.partial(jax.jit, static_argnames=("mesh", "width", "n"))
def _sharded_shared_scan_tiles(tiles, keys, *, mesh, width, n):
    local_b1 = tiles.shape[1] // mesh.devices.size

    def local(tiles_l, keys_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        bits, cnt = _traced_scan(tiles_l, keys_l, width, n, off)
        return bits, jax.lax.psum(cnt, DATA_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None), P()),
        out_specs=(P(None, DATA_AXIS, None), P()),
        check_vma=False,
    )(tiles, keys)


@functools.partial(
    jax.jit, static_argnames=("mesh", "keys_tuple", "width", "n")
)
def _sharded_concrete_scan_tiles(tiles, *, mesh, keys_tuple, width, n):
    local_b1 = tiles.shape[1] // mesh.devices.size

    def local(tiles_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        bits, cnt = _concrete_scan(tiles_l, keys_tuple, width, n, off)
        return bits, jax.lax.psum(cnt, DATA_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P(None, DATA_AXIS, None),
        out_specs=(P(None, DATA_AXIS, None), P()),
        check_vma=False,
    )(tiles)


def sharded_shared_scan(
    dev: DeviceColumn, keys, mesh: Mesh
) -> tuple[jax.Array, jax.Array]:
    """k-predicate shared scan over a sharded column.

    Returns (bits uint32[k, B1, 128] sharded along B1, counts uint32[k]
    replicated via psum).  Use :func:`scan_ops.bits_to_canonical` to gather
    a canonical bitvector when needed.

    Same static dispatch as the single-device :func:`scan_ops.
    shared_scan_device`: concrete keys go through
    scan_ops.pick_concrete_tier shard-locally, traced keys take the
    bit-sliced or compare tier.

    Keys are inspected BEFORE any jnp conversion — inside a jit trace
    ``jnp.asarray`` stages even numpy constants into Tracers, which would
    demote concrete keys to the traced compare tier.
    """
    if not isinstance(keys, jax.core.Tracer):
        return _sharded_concrete_scan_tiles(
            dev.tiles, mesh=mesh,
            keys_tuple=tuple(int(x) for x in np.asarray(keys, np.uint32)),
            width=dev.width, n=dev.n,
        )
    return _sharded_shared_scan_tiles(
        dev.tiles, keys, mesh=mesh, width=dev.width, n=dev.n
    )


def sharded_scan(
    dev: DeviceColumn, predicate_key, mesh: Mesh,
) -> tuple[jax.Array, jax.Array]:
    """Single-predicate sharded scan -> (bits[1, B1, 128] sharded, count)."""
    keys = jnp.asarray(predicate_key, jnp.uint32).reshape(1)
    bits, counts = sharded_shared_scan(dev, keys, mesh)
    return bits[0], counts[0]


@functools.partial(jax.jit, static_argnames=("mesh", "width"))
def _sharded_unpack_tiles(tiles, *, mesh, width):
    def local(tiles_l):
        return unpack_ops.unpack_tiles(tiles_l, width)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P(None, DATA_AXIS, None),
        out_specs=P(None, DATA_AXIS, None),
        check_vma=False,
    )(tiles)


def sharded_unpack(
    dev: DeviceColumn, mesh: Mesh
) -> jax.Array:
    """Decompress a sharded column -> values uint32[32, B1, 128], sharded
    along the block axis (no collective needed — embarrassingly parallel)."""
    return _sharded_unpack_tiles(
        dev.tiles, mesh=mesh, width=dev.width
    )


@functools.partial(
    jax.jit, static_argnames=("mesh", "k", "width", "n")
)
def _sharded_interval_scan_tiles(tiles, lo, *, mesh, k, width, n):
    local_b1 = tiles.shape[1] // mesh.devices.size

    def local(tiles_l, lo_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        bits, cnt = scan_ops.interval_scan_tiles(
            tiles_l, lo_l, k, width, n,
            block_offset=off,
        )
        return bits, jax.lax.psum(cnt, DATA_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None), P()),
        out_specs=(P(None, DATA_AXIS, None), P()),
        check_vma=False,
    )(tiles, lo)


def sharded_interval_scan(
    dev: DeviceColumn, lo, k: int, mesh: Mesh,
) -> tuple[jax.Array, jax.Array]:
    """Sharded shared scan for consecutive keys lo..lo+k-1 (see
    scan_ops.interval_scan_tiles): bits sharded along the block axis,
    counts psum-reduced."""
    lo = jnp.asarray(lo, jnp.uint32)
    return _sharded_interval_scan_tiles(
        dev.tiles, lo, mesh=mesh, k=k, width=dev.width, n=dev.n,
    )


def _local_linear_words(bits):
    """Shard-local (k, lb1, 128) bits -> the shard's linear word stream:
    its blocks are a contiguous span of the global stream, so per-shard
    outputs concatenate into the global one with no collective."""
    from shared_simd_scan_tpu.ops.scan import interleave_linear

    k = bits.shape[0]
    words = bits.reshape(k, -1)
    out = interleave_linear(words, words.shape[1] * 4)
    return jax.lax.bitcast_convert_type(out.reshape(-1, 4), jnp.uint32)


def _linear_out(out, counts, n: int, k: int):
    nwords = ((n + 7) // 8) * k // 4
    return out.reshape(-1)[:nwords], counts


def _check_linear_k(k: int) -> None:
    if k % 4:
        raise ValueError("the linear words view needs k % 4 == 0")


@functools.partial(jax.jit, static_argnames=("mesh", "k", "width", "n"))
def _sharded_linear_scan_tiles(tiles, lo, *, mesh, k, width, n):
    local_b1 = tiles.shape[1] // mesh.devices.size

    def local(tiles_l, lo_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        bits, cnt = scan_ops.interval_scan_tiles(
            tiles_l, lo_l, k, width, n, block_offset=off
        )
        return _local_linear_words(bits), jax.lax.psum(cnt, DATA_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None), P()),
        out_specs=(P(DATA_AXIS), P()),
        check_vma=False,
    )(tiles, lo)


def sharded_linear_scan(
    dev: DeviceColumn, lo, k: int, mesh: Mesh
) -> tuple[jax.Array, jax.Array]:
    """Sharded linear export (interval keys lo..lo+k-1): each shard runs
    the interval tier on its block range and interleaves its own bits,
    so the linear word stream comes out block-sharded — shard s holds a
    CONTIGUOUS span of the global linear stream and per-shard host export
    needs no collective at all.  Counts are psum-reduced.
    Returns (uint32[nbytes*k/4] linear words, (k,) uint32 counts)."""
    _check_linear_k(k)
    out, counts = _sharded_linear_scan_tiles(
        dev.tiles, jnp.asarray(lo, jnp.uint32), mesh=mesh, k=k,
        width=dev.width, n=dev.n,
    )
    return _linear_out(out, counts, dev.n, k)


@functools.partial(
    jax.jit, static_argnames=("mesh", "keys_tuple", "width", "n")
)
def _sharded_static_linear_scan_tiles(tiles, *, mesh, keys_tuple, width, n):
    local_b1 = tiles.shape[1] // mesh.devices.size

    def local(tiles_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        bits, cnt = _concrete_scan(tiles_l, keys_tuple, width, n, off)
        return _local_linear_words(bits), jax.lax.psum(cnt, DATA_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None),),
        out_specs=(P(DATA_AXIS), P()),
        check_vma=False,
    )(tiles)


def sharded_static_linear_scan(
    dev: DeviceColumn, keys, mesh: Mesh
) -> tuple[jax.Array, jax.Array]:
    """Sharded linear export for ANY concrete key set (the shard-local
    scan takes the single-device dispatch, scan_ops.pick_concrete_tier).
    Same block-sharded contiguous output contract; counts psum-reduced."""
    arr = np.asarray(keys, dtype=np.uint32)
    _check_linear_k(arr.shape[0])
    out, counts = _sharded_static_linear_scan_tiles(
        dev.tiles, mesh=mesh, keys_tuple=tuple(int(v) for v in arr),
        width=dev.width, n=dev.n,
    )
    return _linear_out(out, counts, dev.n, arr.shape[0])


@functools.partial(jax.jit, static_argnames=("mesh", "width", "n"))
def _sharded_traced_linear_scan_tiles(tiles, keys, *, mesh, width, n):
    local_b1 = tiles.shape[1] // mesh.devices.size

    def local(tiles_l, keys_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        bits, cnt = _traced_scan(tiles_l, keys_l, width, n, off)
        return _local_linear_words(bits), jax.lax.psum(cnt, DATA_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None), P()),
        out_specs=(P(DATA_AXIS), P()),
        check_vma=False,
    )(tiles, keys)


def sharded_traced_linear_scan(
    dev: DeviceColumn, keys, mesh: Mesh
) -> tuple[jax.Array, jax.Array]:
    """Sharded linear export for TRACED (runtime) keys — one compiled
    program per (k, width, n, mesh) for any key values, keys replicated to
    every shard.  Same block-sharded contiguous output contract; counts
    psum-reduced."""
    keys = jnp.asarray(keys, jnp.uint32)
    _check_linear_k(int(keys.shape[0]))
    out, counts = _sharded_traced_linear_scan_tiles(
        dev.tiles, keys, mesh=mesh, width=dev.width, n=dev.n
    )
    return _linear_out(out, counts, dev.n, int(keys.shape[0]))


@functools.partial(
    jax.jit, static_argnames=("mesh", "width", "n")
)
def _sharded_range_scan_tiles(tiles, lows, highs, *, mesh, width, n):
    local_b1 = tiles.shape[1] // mesh.devices.size

    def local(tiles_l, lows_l, highs_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        bits, cnt = scan_ops.range_scan_tiles(
            tiles_l, lows_l, highs_l, width, n,
            block_offset=off,
        )
        return bits, jax.lax.psum(cnt, DATA_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None), P(), P()),
        out_specs=(P(None, DATA_AXIS, None), P()),
        check_vma=False,
    )(tiles, lows, highs)


def sharded_range_scan(
    dev: DeviceColumn, lows, highs, mesh: Mesh,
) -> tuple[jax.Array, jax.Array]:
    """Sharded k-range-predicate scan (see scan_ops.range_scan_tiles)."""
    lows = jnp.asarray(lows, jnp.uint32)
    highs = jnp.asarray(highs, jnp.uint32)
    return _sharded_range_scan_tiles(
        dev.tiles, lows, highs, mesh=mesh, width=dev.width, n=dev.n,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "wp", "wm", "n", "bitplane"),
)
def _sharded_aggregate_scan_tiles(
    ptiles, mtiles, keys, *, mesh, wp, wm, n,
    bitplane: bool = False,
):
    from shared_simd_scan_tpu.ops import aggregate as agg_ops

    local_b1 = ptiles.shape[1] // mesh.devices.size
    fn = (
        agg_ops.aggregate_bitplane_tiles
        if bitplane
        else agg_ops.aggregate_scan_tiles
    )

    def local(ptiles_l, mtiles_l, keys_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        counts, slo, shi = fn(
            ptiles_l, mtiles_l, keys_l, wp, wm, n, block_offset=off,
        )
        return jax.lax.psum(counts, DATA_AXIS), slo, shi

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None), P(None, DATA_AXIS, None), P()),
        out_specs=(P(), P(DATA_AXIS, None, None), P(DATA_AXIS, None, None)),
        check_vma=False,
    )(ptiles, mtiles, keys)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "keys_tuple", "wp", "wm", "n"),
)
def _sharded_aggregate_bitplane_tiles(
    ptiles, mtiles, *, mesh, keys_tuple, wp, wm, n
):
    from shared_simd_scan_tpu.ops import aggregate as agg_ops

    local_b1 = ptiles.shape[1] // mesh.devices.size
    keys = np.asarray(keys_tuple, np.uint32)

    def local(ptiles_l, mtiles_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        counts, slo, shi = agg_ops.aggregate_bitplane_static_tiles(
            ptiles_l, mtiles_l, keys, wp, wm, n, block_offset=off,
        )
        return jax.lax.psum(counts, DATA_AXIS), slo, shi

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None), P(None, DATA_AXIS, None)),
        out_specs=(P(), P(DATA_AXIS, None, None), P(DATA_AXIS, None, None)),
        check_vma=False,
    )(ptiles, mtiles)


def sharded_aggregate_scan(
    pdev: DeviceColumn, mdev: DeviceColumn, keys, mesh: Mesh,
):
    """Fused filter+aggregate over sharded columns -> (sums uint64 numpy
    (k,), counts uint32 (k,) psum-reduced).

    Per-shard sum partials stay sharded along the step axis; the exact
    uint64 finalization gathers only the small partial grid to the host
    (see ops.aggregate for the overflow-headroom argument).  Same tier
    dispatch as the single-device aggregate_scan_device (concrete keys past
    the counted-cost crossover run the bit-plane tier); keys are
    inspected BEFORE any jnp conversion (the Tracer-demotion trap)."""
    from shared_simd_scan_tpu.ops import aggregate as agg_ops

    if pdev.n != mdev.n:
        raise ValueError(
            f"column lengths differ: predicate n={pdev.n}, measure n={mdev.n}"
        )
    traced = isinstance(keys, jax.core.Tracer)
    tier = agg_ops.pick_aggregate_tier(pdev.width, mdev.width, keys)
    if tier == "bitplane" and not traced:
        counts, slo, shi = _sharded_aggregate_bitplane_tiles(
            pdev.tiles, mdev.tiles, mesh=mesh,
            keys_tuple=tuple(int(x) for x in np.asarray(keys, np.uint32)),
            wp=pdev.width, wm=mdev.width, n=pdev.n,
        )
    else:
        keys = keys if traced else jnp.asarray(np.asarray(keys, np.uint32))
        counts, slo, shi = _sharded_aggregate_scan_tiles(
            pdev.tiles, mdev.tiles, keys, mesh=mesh, wp=pdev.width,
            wm=mdev.width, n=pdev.n,
            bitplane=tier == "bitplane",
        )
    return agg_ops.finalize_sums(fetch_global(slo), fetch_global(shi)), counts


@functools.partial(
    jax.jit, static_argnames=("mesh", "wp", "wm", "n")
)
def _sharded_minmax_scan_tiles(
    ptiles, mtiles, keys, *, mesh, wp, wm, n
):
    from shared_simd_scan_tpu.ops import aggregate as agg_ops

    local_b1 = ptiles.shape[1] // mesh.devices.size

    def local(ptiles_l, mtiles_l, keys_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        counts, mins, maxs = agg_ops.minmax_scan_tiles(
            ptiles_l, mtiles_l, keys_l, wp, wm, n, block_offset=off,
        )
        return jax.lax.psum(counts, DATA_AXIS), mins, maxs

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None), P(None, DATA_AXIS, None), P()),
        out_specs=(P(), P(DATA_AXIS, None, None), P(DATA_AXIS, None, None)),
        check_vma=False,
    )(ptiles, mtiles, keys)


def sharded_minmax_scan(
    pdev: DeviceColumn, mdev: DeviceColumn, keys, mesh: Mesh,
):
    """Fused per-key MIN/MAX over sharded columns -> (mins, maxs, counts)
    (host-finalized, empty groups report 2^wm / 0)."""
    from shared_simd_scan_tpu.ops import aggregate as agg_ops

    if pdev.n != mdev.n:
        raise ValueError(
            f"column lengths differ: predicate n={pdev.n}, measure n={mdev.n}"
        )
    keys = jnp.asarray(keys, jnp.uint32)
    counts, mins, maxs = _sharded_minmax_scan_tiles(
        pdev.tiles, mdev.tiles, keys, mesh=mesh, wp=pdev.width,
        wm=mdev.width, n=pdev.n,
    )
    mn, mx = agg_ops.finalize_minmax(
        fetch_global(mins), fetch_global(maxs), counts, mdev.width
    )
    return mn, mx, counts


@functools.partial(
    jax.jit, static_argnames=("mesh", "k", "width", "n")
)
def _sharded_histogram_tiles(tiles, lo, *, mesh, k, width, n):
    local_b1 = tiles.shape[1] // mesh.devices.size

    def local(tiles_l, lo_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        counts = scan_ops.histogram_tiles(
            tiles_l, lo_l, k, width, n,
            block_offset=off,
        )
        return jax.lax.psum(counts, DATA_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None), P()),
        out_specs=P(),
        check_vma=False,
    )(tiles, lo)


def sharded_histogram(
    dev: DeviceColumn, mesh: Mesh, lo=0, k: int | None = None,
) -> jax.Array:
    """Counts-only value histogram over a sharded column -> uint32 (k,)
    psum-reduced across the mesh (default the full domain, capped at 4096;
    see :func:`scan_ops.histogram_device`).  Concrete (non-jax) lo
    dispatches to the shared-AND-DAG form, like the single-device path;
    pass a jax scalar to force the once-compiled mask-window form."""
    if k is None:
        k = min(1 << dev.width, 4096)
    if not isinstance(lo, (jax.Array, jax.core.Tracer)):
        return _sharded_histogram_dag_tiles(
            dev.tiles, mesh=mesh, lo=int(lo), k=k, width=dev.width,
            n=dev.n,
        )
    lo = jnp.asarray(lo, jnp.uint32)
    return _sharded_histogram_tiles(
        dev.tiles, lo, mesh=mesh, k=k, width=dev.width, n=dev.n,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "lo", "k", "width", "n"),
)
def _sharded_histogram_dag_tiles(
    tiles, *, mesh, lo, k, width, n
):
    local_b1 = tiles.shape[1] // mesh.devices.size

    def local(tiles_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        counts = scan_ops.histogram_dag_tiles(
            tiles_l, lo, k, width, n,
            block_offset=off,
        )
        return jax.lax.psum(counts, DATA_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P(None, DATA_AXIS, None),
        out_specs=P(),
        check_vma=False,
    )(tiles)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "keys_tuple", "width", "n"),
)
def _sharded_member_scan_tiles(
    tiles, keys, *, mesh, keys_tuple, width, n
):
    from shared_simd_scan_tpu.ops import member as member_ops

    local_b1 = tiles.shape[1] // mesh.devices.size
    # concrete keys (needed for the interval/window tiers) travel as a
    # static tuple; traced keys as the ``keys`` operand (compare tiers)
    keys_static = (
        np.asarray(keys_tuple, np.uint32) if keys_tuple is not None else None
    )

    def local(tiles_l, keys_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        bits, cnt = member_ops.member_scan_tiles(
            tiles_l,
            keys_static if keys_static is not None else keys_l,
            width, n, block_offset=off,
        )
        return bits, jax.lax.psum(cnt, DATA_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None), P()),
        out_specs=(P(DATA_AXIS, None), P()),
        check_vma=False,
    )(tiles, keys)


def sharded_member_scan(
    dev: DeviceColumn, keys, mesh: Mesh,
) -> tuple[jax.Array, jax.Array]:
    """IN-list membership scan over a sharded column -> (bits uint32[B1, 128]
    sharded along the block axis, total count psum-reduced).

    Same tiering as the single-device :func:`member_ops.member_scan_device`:
    concrete keys dispatch statically (interval / window popmask tiers);
    traced keys fall back to the compare tiers.  Keys are inspected
    BEFORE any jnp conversion (see :func:`sharded_shared_scan`)."""
    if isinstance(keys, jax.core.Tracer):
        keys_tuple = None
    else:
        keys_tuple = tuple(int(x) for x in np.asarray(keys))
        keys = jnp.asarray(np.asarray(keys, dtype=np.uint32))
    return _sharded_member_scan_tiles(
        dev.tiles, keys, mesh=mesh, keys_tuple=keys_tuple, width=dev.width,
        n=dev.n,
    )


@functools.partial(
    jax.jit, static_argnames=("mesh", "widths", "n")
)
def _sharded_conj_range_scan_tiles(
    tiles, lows, highs, *, mesh, widths, n
):
    from shared_simd_scan_tpu.ops import conj as conj_ops

    local_b1 = tiles[0].shape[1] // mesh.devices.size

    def local(lows_l, highs_l, *tiles_l):
        off = jax.lax.axis_index(DATA_AXIS) * (local_b1 * LANES)
        bits, cnt = conj_ops.conj_range_scan_tiles(
            tiles_l, lows_l, highs_l, widths, n,
            block_offset=off,
        )
        return bits, jax.lax.psum(cnt, DATA_AXIS)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P()) + (P(None, DATA_AXIS, None),) * len(tiles),
        out_specs=(P(DATA_AXIS, None), P()),
        check_vma=False,
    )(lows, highs, *tiles)


@functools.partial(
    jax.jit, static_argnames=("mesh", "wm", "n")
)
def _sharded_masked_aggregate_tiles(
    mtiles, bits, *, mesh, wm, n
):
    from shared_simd_scan_tpu.ops import aggregate as agg_ops

    def local(mtiles_l, bits_l):
        count, slo, shi = agg_ops.masked_aggregate_tiles(mtiles_l, bits_l, wm)
        return jax.lax.psum(count, DATA_AXIS), slo, shi

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, DATA_AXIS, None), P(DATA_AXIS, None)),
        out_specs=(P(), P(DATA_AXIS, None, None), P(DATA_AXIS, None, None)),
        check_vma=False,
    )(mtiles, bits)


def sharded_masked_aggregate(
    mdev: DeviceColumn, bits, mesh: Mesh,
):
    """SUM + COUNT of a sharded measure column over a sharded device-layout
    match bitvector (e.g. from ``query.evaluate_sharded``): -> (sum uint64
    scalar numpy, count uint32).  Sum partials stay sharded until the
    exact host finalize."""
    from shared_simd_scan_tpu.ops import aggregate as agg_ops

    count, slo, shi = _sharded_masked_aggregate_tiles(
        mdev.tiles, bits, mesh=mesh, wm=mdev.width, n=mdev.n,
    )
    return (
        agg_ops.finalize_sums(fetch_global(slo), fetch_global(shi))[0],
        count,
    )


def sharded_conj_range_scan(
    devs, lows, highs, mesh: Mesh,
) -> tuple[jax.Array, jax.Array]:
    """Fused AND of per-column range predicates over identically sharded
    same-table columns -> (bits uint32[B1, 128] sharded along the block
    axis, total count psum-reduced).  See ops.conj for the body."""
    devs = list(devs)
    n = devs[0].n
    for d in devs:
        if d.n != n:
            raise ValueError(
                f"conjunction columns must share n, got {d.n} != {n}"
            )
    return _sharded_conj_range_scan_tiles(
        tuple(d.tiles for d in devs),
        jnp.asarray(lows, jnp.uint32),
        jnp.asarray(highs, jnp.uint32),
        mesh=mesh, widths=tuple(d.width for d in devs), n=n,
    )
