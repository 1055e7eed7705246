"""GPU lowering legality for every public entry point.

The rest of the suite checks SEMANTICS on the CPU (XLA tiers compiled for
the CPU, Triton programs interpreted), which never runs the GPU lowering.
``jax.export`` with ``platforms=["cuda"]`` runs it host-side (no card
needed): plain-XLA tiers lower to StableHLO for CUDA and the Triton
driver's programs lower through Pallas' Triton path into their
``__gpu$xla.gpu.triton`` custom calls.  A tier that cannot lower for the
GPU fails here instead of on the card.  Lowering is necessary, not
sufficient: PTX compilation happens only on the card (chip_smoke.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import export

from shared_simd_scan_tpu import layout
from shared_simd_scan_tpu.ops import aggregate as agg_ops
from shared_simd_scan_tpu.ops import conj as conj_ops
from shared_simd_scan_tpu.ops import member as member_ops
from shared_simd_scan_tpu.ops import scan as scan_ops
from shared_simd_scan_tpu.ops import unpack as unpack_ops

WIDTH = 9
N = 5000


@pytest.fixture(scope="module")
def dev():
    vals = (np.arange(N, dtype=np.uint32) * 7 + 3) & 0x1FF
    return layout.pack_device(vals, WIDTH)


TRITON_CALL = export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")


@pytest.fixture(autouse=True)
def compiled_triton(monkeypatch):
    """Lower the Triton driver's programs as the card compiles them (the
    CPU backend would otherwise pick the interpreter).  The tier jits
    decide at trace time, so their cached traces are dropped on both
    sides of the switch."""
    from shared_simd_scan_tpu.ops import driver

    jax.clear_caches()
    monkeypatch.setattr(driver, "triton_interpret", lambda: False)
    yield
    jax.clear_caches()


def export_gpu(fn, *avals):
    """Trace + lower ``fn`` for the CUDA platform (no execution)."""
    return export.export(
        jax.jit(fn), platforms=["cuda"], disabled_checks=[TRITON_CALL]
    )(*avals)


def tiles_aval(d):
    return jax.ShapeDtypeStruct(d.tiles.shape, d.tiles.dtype)


def scan_fn(d, keys):
    def f(tiles):
        dd = layout.DeviceColumn(tiles=tiles, width=d.width, n=d.n)
        return scan_ops.shared_scan_device(dd, keys)

    return f


def spread_keys(k):
    return ((np.arange(k, dtype=np.uint32) * 97 + 5) % (1 << WIDTH)).astype(
        np.uint32
    )


# --- shared_scan_device dispatch tiers --------------------------------


def test_lower_scan_single_key(dev):
    export_gpu(scan_fn(dev, np.array([3], np.uint32)), tiles_aval(dev))


def test_lower_interval_k8(dev):
    keys = np.arange(4, 12, dtype=np.uint32)
    assert scan_ops._consecutive_lo(keys) is not None
    export_gpu(scan_fn(dev, keys), tiles_aval(dev))


def test_lower_interval_k40_two_windows(dev):
    # two 32-key mask windows in one Triton program
    export_gpu(
        lambda tiles: scan_ops.interval_scan_tiles(
            tiles, 7, 40, WIDTH, N
        ),
        tiles_aval(dev),
    )


def test_lower_interval_k1024(dev):
    export_gpu(
        lambda tiles: scan_ops.interval_scan_tiles(
            tiles, 0, 1024, WIDTH, N
        ),
        tiles_aval(dev),
    )


def test_lower_general_static_k3(dev):
    keys = np.array([3, 100, 317], np.uint32)
    assert not scan_ops._bitsliced_wins(WIDTH, 3)
    export_gpu(scan_fn(dev, keys), tiles_aval(dev))


def test_lower_bitsliced_static_k8_dispatch(dev):
    # concrete spread k=8 dispatches to the static AND-DAG bit-sliced tier
    keys = spread_keys(8)
    assert scan_ops.bitsliced_static_cost(WIDTH, keys) < 4 + 12 * 8
    export_gpu(scan_fn(dev, keys), tiles_aval(dev))


def test_lower_bitsliced_static_k100(dev):
    export_gpu(
        lambda tiles: scan_ops.shared_scan_bitsliced_static_tiles(
            tiles, spread_keys(100), WIDTH, N
        ),
        tiles_aval(dev),
    )


def test_lower_bitsliced_static_k300(dev):
    export_gpu(
        lambda tiles: scan_ops.shared_scan_bitsliced_static_tiles(
            tiles, spread_keys(300), WIDTH, N
        ),
        tiles_aval(dev),
    )


def test_lower_bitsliced_k100(dev):
    export_gpu(
        lambda tiles: scan_ops.shared_scan_bitsliced_tiles(
            tiles, jnp.asarray(spread_keys(100)), WIDTH, N
        ),
        tiles_aval(dev),
    )


def test_lower_windowed_k16_clusters(dev):
    keys = np.concatenate(
        [np.arange(8, dtype=np.uint32), 256 + np.arange(8, dtype=np.uint32)]
    )
    assert scan_ops.windowed_cost(keys) < min(
        12 * 16, scan_ops.bitsliced_cost(WIDTH, 16)
    )
    export_gpu(scan_fn(dev, keys), tiles_aval(dev))


def test_lower_windowed_k64(dev):
    keys = (
        64 * np.repeat(np.arange(8, dtype=np.uint32), 8)
        + np.tile(np.arange(8, dtype=np.uint32), 8)
    )
    export_gpu(
        lambda tiles: scan_ops.windowed_scan_tiles(tiles, keys, WIDTH, N),
        tiles_aval(dev),
    )


def test_lower_compare_k100(dev):
    export_gpu(
        lambda tiles: scan_ops.shared_scan_tiles(
            tiles, jnp.asarray(spread_keys(100)), WIDTH, N
        ),
        tiles_aval(dev),
    )


@pytest.mark.parametrize("tier", ["compare", "bitsliced", "static", "interval"])
def test_lower_triton_driver(dev, tier):
    # each tier the Triton driver serves, forced onto it at k=8
    keys = spread_keys(8)

    def f(tiles):
        if tier == "compare":
            return scan_ops.shared_scan_tiles(
                tiles, jnp.asarray(keys), WIDTH, N, backend="triton")
        if tier == "bitsliced":
            return scan_ops.shared_scan_bitsliced_tiles(
                tiles, jnp.asarray(keys), WIDTH, N, backend="triton")
        if tier == "static":
            return scan_ops.shared_scan_bitsliced_static_tiles(
                tiles, keys, WIDTH, N, backend="triton")
        return scan_ops.interval_scan_tiles(tiles, 3, 8, WIDTH, N, backend="triton")

    exp = export_gpu(f, tiles_aval(dev))
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()


def test_lower_traced_keys_k8(dev):
    # Traced keys must reach a traced-capable tier (bit-sliced here).
    def f(tiles, keys):
        dd = layout.DeviceColumn(tiles=tiles, width=WIDTH, n=N)
        return scan_ops.shared_scan_device(dd, keys)

    export_gpu(
        f, tiles_aval(dev), jax.ShapeDtypeStruct((8,), jnp.uint32)
    )


def test_lower_range_scan(dev):
    def f(tiles):
        dd = layout.DeviceColumn(tiles=tiles, width=WIDTH, n=N)
        return scan_ops.range_scan_device(
            dd, np.array([0, 9, 100, 500], np.uint32),
            np.array([4, 64, 101, 512], np.uint32),
        )

    export_gpu(f, tiles_aval(dev))


def test_lower_histogram_full_domain(dev):
    def f(tiles):
        dd = layout.DeviceColumn(tiles=tiles, width=WIDTH, n=N)
        return scan_ops.histogram_device(dd)

    export_gpu(f, tiles_aval(dev))


def test_lower_histogram_k16(dev):
    def f(tiles):
        dd = layout.DeviceColumn(tiles=tiles, width=WIDTH, n=N)
        return scan_ops.histogram_device(dd, lo=3, k=16)

    export_gpu(f, tiles_aval(dev))


# --- member tiers ------------------------------------------------------


def member_fn(d, keys):
    def f(tiles):
        dd = layout.DeviceColumn(tiles=tiles, width=d.width, n=d.n)
        return member_ops.member_scan_device(dd, keys)

    return f


@pytest.mark.parametrize(
    "name,keys",
    [
        ("interval", np.arange(10, 26, dtype=np.uint32)),
        (
            "window",
            np.concatenate(
                [
                    np.arange(3, 7, dtype=np.uint32),
                    np.arange(100, 104, dtype=np.uint32),
                ]
            ),
        ),
        ("compare", np.array([3, 100, 317], np.uint32)),
        ("ortree", spread_keys(8)),
        ("ortree", spread_keys(100)),
        ("ortree", spread_keys(300)),
    ],
)
def test_lower_member_tiers(dev, name, keys):
    tier = member_ops.member_dispatch_tier(keys, WIDTH)
    assert tier.startswith(name.split("-multichunk")[0]), (name, tier)
    export_gpu(member_fn(dev, keys), tiles_aval(dev))


def test_lower_member_bitsliced_multichunk(dev):
    # direct tile call: dispatch routes k=100 spread at width 9 to the
    # domain tier, but the bit-sliced member tier must keep lowering (it
    # is the dispatch winner at widths > 12)
    keys = jnp.asarray(spread_keys(100))
    export_gpu(
        lambda tiles: member_ops._member_bitsliced_tiles(
            tiles, keys, 0, width=WIDTH, n=N
        ),
        tiles_aval(dev),
    )


@pytest.mark.parametrize("w", [7, 9, 12])
def test_lower_member_domain(w):
    vals = (np.arange(N, dtype=np.uint32) * 7 + 3) & ((1 << w) - 1)
    d = layout.pack_device(vals, w)

    def f(tiles):
        return member_ops._member_domain_tiles(
            tiles,
            member_ops.domain_table(np.arange(5, 100, 3, np.uint32) % (1 << w), w),
            0, width=w, n=N,
        )

    export_gpu(f, tiles_aval(d))


def test_lower_member_chunked_compare(dev):
    keys = jnp.asarray(spread_keys(64))
    export_gpu(
        lambda tiles: member_ops._member_compare_tiles(
            tiles, keys, 0, width=WIDTH, n=N
        ),
        tiles_aval(dev),
    )


def test_lower_member_traced_keys(dev):
    def f(tiles, keys):
        dd = layout.DeviceColumn(tiles=tiles, width=WIDTH, n=N)
        return member_ops.member_scan_device(dd, keys)

    export_gpu(
        f, tiles_aval(dev), jax.ShapeDtypeStruct((12,), jnp.uint32)
    )


# --- conjunction, aggregates, codec ------------------------------------


@pytest.mark.parametrize("m", [2, 8])
def test_lower_conj_range(dev, m):
    def f(tiles):
        devs = [
            layout.DeviceColumn(tiles=tiles, width=WIDTH, n=N)
            for _ in range(m)
        ]
        return conj_ops.conj_range_scan_device(
            devs,
            np.full(m, 10, np.uint32),
            np.full(m, 400, np.uint32),
        )

    export_gpu(f, tiles_aval(dev))


def test_lower_aggregate_scan(dev):
    def f(tiles):
        dd = layout.DeviceColumn(tiles=tiles, width=WIDTH, n=N)
        return agg_ops.aggregate_scan_tiles(
            tiles, tiles, jnp.arange(4, dtype=jnp.uint32), WIDTH, WIDTH, N
        )

    export_gpu(f, tiles_aval(dev))


def test_lower_minmax_scan(dev):
    def f(tiles):
        return agg_ops.minmax_scan_tiles(
            tiles, tiles, jnp.arange(4, dtype=jnp.uint32), WIDTH, WIDTH, N
        )

    export_gpu(f, tiles_aval(dev))


@pytest.mark.parametrize("wm", [9, 17])
def test_lower_masked_aggregate(wm):
    vals = (np.arange(N, dtype=np.uint32) * 11 + 1) & ((1 << wm) - 1)
    mdev = layout.pack_device(vals, wm)

    def f(tiles, bits):
        # tiles-level call: masked_aggregate_device finalizes sums on host
        row = agg_ops.bits_from_canonical(bits, tiles.shape[1])
        return agg_ops.masked_aggregate_tiles(tiles, row, wm)

    export_gpu(
        f,
        tiles_aval(mdev),
        jax.ShapeDtypeStruct((layout.bitvector_words(N),), jnp.uint32),
    )


@pytest.mark.parametrize("w", [1, 9, 17, 31])
def test_lower_unpack_pack(w):
    vals = (np.arange(N, dtype=np.uint32) * 13 + 5) & ((1 << w) - 1)
    d = layout.pack_device(vals, w)

    def f(tiles):
        dd = layout.DeviceColumn(tiles=tiles, width=w, n=N)
        flat = unpack_ops.unpack_device(dd)
        return unpack_ops.pack_device_kernel(flat, w).tiles

    export_gpu(f, tiles_aval(d))


@pytest.mark.parametrize("k", [4, 8, 32])
def test_lower_linear_interleave(dev, k):
    """Full linear path (shared scan + plain byte interleave)."""
    keys = np.arange(k, dtype=np.uint32)

    def f(tiles):
        dd = layout.DeviceColumn(tiles=tiles, width=WIDTH, n=N)
        return scan_ops.shared_scan_linear_device(dd, keys)

    export_gpu(f, tiles_aval(dev))


@pytest.mark.parametrize("k", [32, 512])
def test_lower_histogram_dag(dev, k):
    """Counts-only shared-AND-DAG histogram (concrete lo)."""
    def f(tiles):
        return scan_ops.histogram_dag_tiles(tiles, 0, k, WIDTH, N)

    export_gpu(f, tiles_aval(dev))


def test_lower_zonemap_pruned_scan(dev):
    """Pruned range scan: dynamic_slice + range kernel at a bucketed span."""
    from shared_simd_scan_tpu import zonemap as zm

    def f(tiles, start):
        return zm._pruned_range_tiles(
            tiles, start,
            jnp.asarray([5], jnp.uint32), jnp.asarray([9], jnp.uint32),
            span=8, width=WIDTH, n=N,
        )

    export_gpu(
        f, tiles_aval(dev), jax.ShapeDtypeStruct((), jnp.int32)
    )


@pytest.mark.parametrize("k", [4, 8, 12, 16, 20, 24, 32, 64])
def test_lower_linear_words(dev, k):
    """Linear words export for spread keys: scan dispatch + interleave."""
    keys = spread_keys(k)

    def f(tiles):
        dd = layout.DeviceColumn(tiles=tiles, width=WIDTH, n=N)
        return scan_ops.shared_scan_linear_words_device(dd, keys)

    export_gpu(f, tiles_aval(dev))


@pytest.mark.parametrize("wm", [9, 16, 31])
def test_lower_aggregate_bitplane_static(dev, wm):
    vals = (np.arange(N, dtype=np.uint32) * 11 + 1) & ((1 << wm) - 1)
    mdev = layout.pack_device(vals, wm)
    keys = tuple(int(x) for x in spread_keys(12))

    def f(ptiles, mtiles):
        return agg_ops.aggregate_bitplane_static_tiles(
            ptiles, mtiles, keys, WIDTH, wm, N
        )

    export_gpu(f, tiles_aval(dev), tiles_aval(mdev))


def test_lower_aggregate_bitplane_traced(dev):
    def f(ptiles, mtiles, keys):
        return agg_ops.aggregate_bitplane_tiles(
            ptiles, mtiles, keys, WIDTH, WIDTH, N
        )

    export_gpu(
        f, tiles_aval(dev), tiles_aval(dev),
        jax.ShapeDtypeStruct((12,), jnp.uint32),
    )


def test_lower_zoned_range_scan(dev):
    """Zoned scan: gather of the live tiles, range body, scatter."""
    from shared_simd_scan_tpu import zonemap as zm

    g = 4

    def f(tiles, idx, flag):
        return zm._zoned_range_tiles(
            tiles, idx, flag,
            jnp.asarray([5], jnp.uint32), jnp.asarray([9], jnp.uint32),
            rows=8, width=WIDTH, n=N,
        )

    export_gpu(
        f, tiles_aval(dev),
        jax.ShapeDtypeStruct((g,), jnp.int32),
        jax.ShapeDtypeStruct((g,), jnp.int32),
    )
