"""Histogram-derived column statistics vs direct numpy."""
import numpy as np
import pytest

from shared_simd_scan_tpu import layout, stats


def _col(width, n, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    return vals, layout.to_device(layout.pack(vals, width))


def test_histogram_full_matches_bincount():
    vals, dev = _col(9, 30_000, seed=1)
    counts = stats.histogram_full(dev)
    np.testing.assert_array_equal(
        counts, np.bincount(vals, minlength=512).astype(np.uint64)
    )


def test_histogram_full_multiwindow_width13():
    # 2^13 domain -> two 4096-value kernel windows
    vals, dev = _col(13, 50_000, seed=2)
    counts = stats.histogram_full(dev)
    np.testing.assert_array_equal(
        counts, np.bincount(vals, minlength=1 << 13).astype(np.uint64)
    )


def test_quantiles_exact():
    vals, dev = _col(9, 20_000, seed=3)
    qs = [0.0, 0.25, 0.5, 0.9, 1.0]
    got = stats.quantiles(dev, qs)
    svals = np.sort(vals)
    for q, g in zip(qs, got):
        rank = max(1, int(np.ceil(q * vals.size)))
        assert int(g) == int(svals[rank - 1]), q


def test_topk_values():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 128, 10_000, dtype=np.uint32)
    vals[:3000] = 7   # clear winner
    vals[3000:4500] = 99
    dev = layout.to_device(layout.pack(vals, 9))
    top, counts = stats.topk_values(dev, 2)
    assert list(top) == [7, 99]
    exp = np.bincount(vals, minlength=512)
    assert list(counts) == [exp[7], exp[99]]


def test_describe():
    vals, dev = _col(9, 15_000, seed=5)
    d = stats.describe(dev)
    assert d["n"] == vals.size
    assert d["min"] == int(vals.min())
    assert d["max"] == int(vals.max())
    assert d["distinct"] == int(np.unique(vals).size)
    assert abs(d["mean"] - vals.astype(np.float64).mean()) < 1e-9
    svals = np.sort(vals)
    assert d["median"] == int(svals[(vals.size + 1) // 2 - 1])


def test_width_guard():
    _, dev = _col(9, 100, seed=6)
    object.__setattr__(dev, "width", 31)
    with pytest.raises(ValueError, match="width 31"):
        stats.histogram_full(dev)


def test_histogram_full_sharded_matches():
    from shared_simd_scan_tpu.parallel import dist

    mesh = dist.make_mesh()
    vals, dev = _col(9, 8 * 32 * 128 * 8 + 7, seed=7)
    sdev = dist.shard_column(dev, mesh)
    counts = stats.histogram_full(sdev, mesh=mesh)
    np.testing.assert_array_equal(
        counts, np.bincount(vals, minlength=512).astype(np.uint64)
    )
    d = stats.describe(sdev, mesh=mesh)
    assert d["n"] == vals.size and d["min"] == int(vals.min())
