"""Histogram (counts-only interval scan) tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shared_simd_scan_tpu import layout
from shared_simd_scan_tpu.ops import scan as scan_ops


def _col(width, n, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    return vals, layout.pack(vals, width)


@pytest.mark.parametrize("width", [5, 9, 12])
def test_full_domain_histogram(width):
    n = 40_000
    vals, col = _col(width, n, seed=width)
    dev = layout.to_device(col)
    counts = scan_ops.histogram_device(dev)
    expect = np.bincount(vals, minlength=1 << width).astype(np.uint32)
    np.testing.assert_array_equal(np.asarray(counts), expect)
    assert int(np.asarray(counts).sum()) == n


def test_histogram_subrange_and_offset():
    width, n = 9, 25_000
    vals, col = _col(width, n, seed=3)
    dev = layout.to_device(col)
    counts = scan_ops.histogram_device(dev, lo=100, k=40)
    expect = np.array([(vals == 100 + j).sum() for j in range(40)], np.uint32)
    np.testing.assert_array_equal(np.asarray(counts), expect)


def test_histogram_single_chunk_small_k():
    width, n = 9, 10_000
    vals, col = _col(width, n, seed=4)
    dev = layout.to_device(col)
    counts = scan_ops.histogram_device(dev, lo=0, k=5)
    expect = np.array([(vals == j).sum() for j in range(5)], np.uint32)
    np.testing.assert_array_equal(np.asarray(counts), expect)


def test_histogram_padding_and_tail():
    # ragged n: padding zero-blocks must not count toward key 0
    width, n = 9, 4_101
    vals, col = _col(width, n, seed=5)
    dev = layout.to_device(col)
    counts = scan_ops.histogram_device(dev)
    assert int(counts[0]) == int((vals == 0).sum())
    assert int(np.asarray(counts).sum()) == n


def test_histogram_wide_domain_capped():
    width, n = 16, 8_000
    vals, col = _col(width, n, seed=6)
    dev = layout.to_device(col)
    # default caps at 4096 keys
    counts = scan_ops.histogram_device(dev)
    assert counts.shape[0] == 4096
    expect = np.bincount(vals[vals < 4096], minlength=4096).astype(np.uint32)
    np.testing.assert_array_equal(np.asarray(counts), expect)
    with pytest.raises(ValueError, match="histogram supports"):
        scan_ops.histogram_device(dev, k=5000)


def test_histogram_matches_interval_counts():
    width, n = 9, 15_000
    vals, col = _col(width, n, seed=7)
    dev = layout.to_device(col)
    counts = scan_ops.histogram_device(dev, lo=50, k=64)
    _, icounts = scan_ops.interval_scan_device(dev, 50, 64)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(icounts))


@pytest.mark.parametrize("lo,k", [(0, 512), (5, 100), (500, 30)])
def test_histogram_dag_parity(lo, k):
    # concrete-lo dispatch: the shared-AND-DAG counts kernel vs numpy
    width, n = 9, 33_000
    rng = np.random.default_rng(lo + k)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    dev = layout.pack_device(jnp.asarray(vals), width)
    got = np.asarray(
        scan_ops.histogram_dag_tiles(dev.tiles, lo, k, width, n)
    )
    exp = np.array([(vals == lo + j).sum() for j in range(k)], np.uint32)
    np.testing.assert_array_equal(got, exp)
    got2 = np.asarray(scan_ops.histogram_device(dev, lo, k))
    np.testing.assert_array_equal(got2, exp)


def test_histogram_traced_lo_keeps_mask_path():
    width, n = 9, 9_000
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    dev = layout.pack_device(jnp.asarray(vals), width)
    f = jax.jit(lambda lo: scan_ops.histogram_device(dev, lo, 64))
    got = np.asarray(f(jnp.uint32(3)))
    exp = np.array([(vals == 3 + j).sum() for j in range(64)], np.uint32)
    np.testing.assert_array_equal(got, exp)
