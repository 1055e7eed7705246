"""FOR-encoding tests: width reduction, predicate rewriting, aggregates."""
import numpy as np
import pytest

from shared_simd_scan_tpu import bitvector, forcol, layout, query as q


def _band_col(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=n, dtype=np.uint32)


def test_pack_for_minimal_width_and_roundtrip():
    vals = _band_col(20_000, 1_000_000, 1_000_000 + 300, seed=1)
    fc = forcol.pack_for(vals)
    assert fc.width <= 9  # 300-value band fits in 9 bits
    assert fc.base == int(vals.min())
    np.testing.assert_array_equal(forcol.unpack_for(fc), vals.astype(np.uint64))


def test_for_query_rewrite_eq_range_in():
    vals = _band_col(15_000, 50_000, 50_000 + 400, seed=2)
    fc = forcol.pack_for(vals)
    expr = q.Or(
        q.Eq(fc, 50_123),
        q.Range(fc, 50_010, 50_050),
        q.In(fc, [50_200, 50_201, 49_000]),  # 49_000 out of band: dropped
    )
    bits, count = forcol.evaluate(expr)
    expect = (
        (vals == 50_123)
        | ((vals >= 50_010) & (vals < 50_050))
        | np.isin(vals, [50_200, 50_201])
    )
    assert int(count) == int(expect.sum())
    np.testing.assert_array_equal(
        np.asarray(bitvector.to_bool(bits, vals.size)), expect
    )


def test_for_out_of_band_predicates_are_constants():
    vals = _band_col(5_000, 100, 200, seed=3)
    fc = forcol.pack_for(vals)
    bits, count = forcol.evaluate(q.Range(fc, 500, 900))
    assert int(count) == 0
    bits, count = forcol.evaluate(
        q.Not(q.Range(fc, 0, 1_000_000))
    )
    assert int(count) == 0  # full-band range matches everything


def test_for_mixed_with_plain_columns():
    n = 8_000
    vals = _band_col(n, 7_000, 7_256, seed=4)
    fc = forcol.pack_for(vals)
    plain_vals = _band_col(n, 0, 512, seed=5)
    plain = layout.to_device(layout.pack(plain_vals, 9))
    bits, count = forcol.evaluate(
        q.And(q.Range(fc, 7_100, 7_200), q.Range(plain, 0, 256)),
    )
    expect = (vals >= 7_100) & (vals < 7_200) & (plain_vals < 256)
    assert int(count) == int(expect.sum())


def test_for_masked_aggregate_exact():
    n = 10_000
    mvals = _band_col(n, 3_000_000, 3_000_000 + 60_000, seed=6)
    fm = forcol.pack_for(mvals)
    mask = _band_col(n, 0, 2, seed=7).astype(bool)
    import jax.numpy as jnp

    bits = bitvector.from_bool(jnp.asarray(mask))
    s, c = forcol.masked_aggregate(fm, bits)
    assert int(c) == int(mask.sum())
    assert int(s) == int(mvals[mask].astype(np.uint64).sum())


def test_for_stats_shifted():
    vals = _band_col(12_000, 90_000, 90_000 + 500, seed=8)
    fc = forcol.pack_for(vals)
    d = forcol.describe(fc)
    assert d["min"] == int(vals.min()) and d["max"] == int(vals.max())
    qs = forcol.quantiles(fc, [0.5])
    sv = np.sort(vals)
    assert int(qs[0]) == int(sv[max(1, int(np.ceil(0.5 * vals.size))) - 1])


def test_pack_for_width_validation():
    vals = np.arange(100, dtype=np.uint32)
    with pytest.raises(ValueError, match="cannot hold"):
        forcol.pack_for(vals, width=5)


def test_for_sharded_query():
    from shared_simd_scan_tpu.parallel import dist

    mesh = dist.make_mesh()
    n = 8 * 32 * 128 * 8 + 11
    vals = _band_col(n, 40_000, 40_000 + 400, seed=9)
    fc = forcol.pack_for(vals)
    sfc = forcol.ForColumn(base=fc.base, dev=dist.shard_column(fc.dev, mesh))
    expr = forcol.normalize(q.Range(sfc, 40_050, 40_300))
    bits, count = q.evaluate_sharded(expr, mesh)
    expect = (vals >= 40_050) & (vals < 40_300)
    assert int(count) == int(expect.sum())
