"""Interval (consecutive-key) and range-predicate scan kernel tests."""
import numpy as np
import pytest

from shared_simd_scan_tpu import bitvector, layout
from shared_simd_scan_tpu.ops import oracle, scan as scan_ops


def _col(width, n, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    return vals, layout.pack(vals, width)


@pytest.mark.parametrize("k", [1, 2, 5, 8, 9, 16, 32])
def test_interval_scan_matches_shared_scan(k):
    width, n = 9, 40_000
    vals, col = _col(width, n, seed=k)
    dev = layout.to_device(col)
    lo = 100
    bits, counts = scan_ops.interval_scan_device(dev, lo, k)
    keys = np.arange(lo, lo + k, dtype=np.uint32)
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(obits))


def test_interval_scan_wraparound_guard():
    # lo near the top of the domain: v < lo must not match (unsigned wrap)
    width, n, k = 9, 10_000, 8
    vals, col = _col(width, n, seed=77)
    dev = layout.to_device(col)
    lo = (1 << width) - 3  # only keys 509,510,511 are in-domain
    bits, counts = scan_ops.interval_scan_device(dev, lo, k)
    for j in range(k):
        assert int(counts[j]) == int((vals == lo + j).sum())


@pytest.mark.parametrize("k", [1, 3, 8])
def test_range_scan_parity_vs_numpy(k):
    width, n = 11, 30_000
    vals, col = _col(width, n, seed=k + 7)
    dev = layout.to_device(col)
    rng = np.random.default_rng(k)
    lows = rng.integers(0, 1 << width, k).astype(np.uint32)
    highs = (lows + rng.integers(0, 200, k)).astype(np.uint32)
    bits, counts = scan_ops.range_scan_device(dev, lows, highs)
    for j in range(k):
        expect = (vals >= lows[j]) & (vals < highs[j])
        assert int(counts[j]) == int(expect.sum()), j
        assert bitvector.to_bytes(bits[j], n) == np.packbits(
            expect, bitorder="little"
        ).tobytes(), j


def test_range_scan_empty_and_full_ranges():
    width, n = 9, 5_000
    vals, col = _col(width, n, seed=5)
    dev = layout.to_device(col)
    lows = np.array([0, 7, 500], np.uint32)
    highs = np.array([512, 7, 2], np.uint32)  # full, empty, inverted(empty)
    bits, counts = scan_ops.range_scan_device(dev, lows, highs)
    assert int(counts[0]) == n
    assert int(counts[1]) == 0
    # inverted range hi < lo: hi-lo wraps huge -> matches v >= lo (documented
    # half-open unsigned semantics); just check it equals the numpy model
    expect2 = (vals - np.uint32(500)) < np.uint32((2 - 500) & 0xFFFFFFFF)
    assert int(counts[2]) == int(expect2.sum())


@pytest.mark.parametrize("k", [36, 48, 64, 100])
def test_interval_scan_large_k_chunked(k):
    width, n = 9, 6_000  # several 32-key mask windows (k > 32)
    vals, col = _col(width, n, seed=13)
    dev = layout.to_device(col)
    lo = 50
    bits, counts = scan_ops.interval_scan_device(dev, lo, k)
    keys = np.arange(lo, lo + k, dtype=np.uint32)
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(obits))


@pytest.mark.parametrize("width,k", [(25, 8), (31, 32), (9, 100), (31, 64)])
def test_interval_scan_wide_columns(width, k):
    # wide widths (straddling unpack schedule) at one- and multi-window k
    n = 5_000
    vals, col = _col(width, n, seed=width + k)
    lo = int(vals[11]) - 3 if int(vals[11]) >= 3 else 0
    vals[: 3 * k] = lo + np.arange(3 * k, dtype=np.uint32) % k  # hits
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    _, counts = scan_ops.interval_scan_device(dev, lo, k)
    expect = [int((vals == lo + j).sum()) for j in range(k)]
    assert [int(c) for c in np.asarray(counts)] == expect


def test_shift_saturation_canary_on_cpu():
    # the interval/windowed bodies rely on XLA's shift semantics: a
    # logical shift left by 32 or more gives 0 (chip_smoke.py checks the
    # same on the card)
    import jax
    import jax.numpy as jnp

    amounts = jnp.asarray(
        [32, 33, 63, 64, 255, 1 << 20, (1 << 32) - 32, (1 << 32) - 1], jnp.uint32)
    out = jax.jit(lambda a: jnp.uint32(1) << a)(amounts)
    assert not np.asarray(out).any()
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda a: jnp.uint32(1) << a)(jnp.arange(32, dtype=jnp.uint32))),
        (1 << np.arange(32, dtype=np.uint64)).astype(np.uint32),
    )


@pytest.mark.parametrize("k", [5, 8, 40])
def test_interval_gated_fallback_matches_gateless(k):
    # the gated mask (the Triton driver's form: an oversized LLVM shift
    # is poison) must be bit-identical to the gateless XLA form
    import functools

    import jax.numpy as jnp

    from shared_simd_scan_tpu.ops import driver

    width, n = 9, 20_000
    vals, col = _col(width, n, seed=k + 3)
    dev = layout.to_device(col)
    lo = jnp.asarray([30], jnp.uint32)
    out = [
        driver.scan_xla(
            functools.partial(scan_ops._interval_rows, width=width, k=k,
                              gateless=g),
            dev.tiles, n, lo,
        )
        for g in (True, False)
    ]
    np.testing.assert_array_equal(np.asarray(out[0][0]), np.asarray(out[1][0]))
    np.testing.assert_array_equal(np.asarray(out[0][1]), np.asarray(out[1][1]))


def test_interval_counts_are_uint32():
    # per-key counts can exceed int32 at narrow widths; the public dtype
    # is uint32 (wrap-correct to 2^32-1)
    width, n, k = 9, 4_096, 8
    vals, col = _col(width, n, seed=1)
    dev = layout.to_device(col)
    _, counts = scan_ops.interval_scan_device(dev, 0, k)
    assert np.asarray(counts).dtype == np.uint32
    _, counts2 = scan_ops.shared_scan_device(
        dev, np.arange(k, dtype=np.uint32) * 3 % 512
    )
    assert np.asarray(counts2).dtype == np.uint32
