"""Dictionary-encoding tests: arbitrary domains, predicate rewriting."""
import numpy as np
import pytest

from shared_simd_scan_tpu import bitvector, dictcol, forcol, query as q


def _sparse_col(n, seed=0):
    # ~200 distinct values scattered over a huge 64-bit-ish domain
    rng = np.random.default_rng(seed)
    domain = np.sort(
        rng.choice(np.uint64(1) << np.uint64(40), size=200, replace=False)
    )
    return domain[rng.integers(0, domain.size, n)], domain


def test_pack_dict_width_and_roundtrip():
    vals, domain = _sparse_col(20_000, seed=1)
    dc = dictcol.pack_dict(vals)
    assert dc.width == 8  # 200 distinct -> 8 bits
    np.testing.assert_array_equal(dictcol.unpack_dict(dc), vals)


def test_dict_query_rewrite():
    vals, domain = _sparse_col(15_000, seed=2)
    dc = dictcol.pack_dict(vals)
    lo, hi = int(domain[40]), int(domain[120])
    absent = int(domain[0]) + 1  # value between dictionary entries
    expr = q.Or(
        q.Range(dc, lo, hi),
        q.Eq(dc, int(domain[150])),
        q.In(dc, [int(domain[5]), absent]),
    )
    bits, count = dictcol.evaluate(expr)
    expect = (
        ((vals >= lo) & (vals < hi))
        | (vals == domain[150])
        | (vals == domain[5])
    )
    assert int(count) == int(expect.sum())
    np.testing.assert_array_equal(
        np.asarray(bitvector.to_bool(bits, vals.size)), expect
    )


def test_dict_absent_eq_is_constant_false():
    vals, domain = _sparse_col(5_000, seed=3)
    dc = dictcol.pack_dict(vals)
    bits, count = dictcol.evaluate(q.Eq(dc, int(domain[0]) + 1))
    assert int(count) == 0


def test_dict_range_boundaries_are_order_preserving():
    vals = np.array([10, 10, 500, 500, 70_000], np.uint64)
    dc = dictcol.pack_dict(vals)
    # half-open [500, 70_000) must match only the 500s
    bits, count = dictcol.evaluate(q.Range(dc, 500, 70_000))
    assert int(count) == 2
    # [10, 70_001) matches everything
    _, count = dictcol.evaluate(q.Range(dc, 10, 70_001))
    assert int(count) == 5


def test_dict_mixed_with_for_column():
    n = 8_000
    vals, domain = _sparse_col(n, seed=4)
    dc = dictcol.pack_dict(vals)
    band = np.random.default_rng(5).integers(
        9_000, 9_500, size=n, dtype=np.uint32
    )
    fc = forcol.pack_for(band)
    expr = q.And(
        q.Range(dc, int(domain[20]), int(domain[180])),
        q.Range(fc, 9_100, 9_300),
    )
    bits, count = dictcol.evaluate(expr)
    expect = (
        (vals >= domain[20]) & (vals < domain[180])
        & (band >= 9_100) & (band < 9_300)
    )
    assert int(count) == int(expect.sum())


def test_dict_stats():
    vals, domain = _sparse_col(12_000, seed=6)
    dc = dictcol.pack_dict(vals)
    d = dictcol.describe(dc)
    assert d["n"] == vals.size
    assert d["min"] == int(vals.min()) and d["max"] == int(vals.max())
    assert d["distinct"] == int(np.unique(vals).size)
    top, counts = dictcol.topk_values(dc, 1)
    exp_val, exp_cnt = np.unique(vals, return_counts=True)
    assert int(counts[0]) == int(exp_cnt.max())
    assert int(top[0]) in set(exp_val[exp_cnt == exp_cnt.max()].tolist())


def test_pack_dict_width_validation():
    vals = np.arange(100, dtype=np.uint64)
    with pytest.raises(ValueError, match="cannot hold"):
        dictcol.pack_dict(vals, width=5)


def test_topk_caps_at_dictionary_size():
    vals = np.array([10, 10, 500, 70_000], np.uint64)  # 3 distinct
    dc = dictcol.pack_dict(vals)
    top, counts = dictcol.topk_values(dc, 10)
    assert top.shape[0] == 3 and int(counts[0]) == 2 and int(top[0]) == 10


def test_describe_mean_exact_for_64bit_domain():
    big = np.uint64(1) << np.uint64(62)
    vals = np.array([big, big, big + np.uint64(6)], np.uint64)
    dc = dictcol.pack_dict(vals)
    d = dictcol.describe(dc)
    assert d["mean"] == (int(big) * 3 + 6) / 3
