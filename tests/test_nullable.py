"""Nullable columns: SQL three-valued logic vs a numpy Kleene oracle."""
import numpy as np
import pytest

from shared_simd_scan_tpu import bitvector, layout, nullable, query as q

T, U, F = 1, 0, -1  # Kleene truth values for the oracle


def _tri_leaf(match, null):
    out = np.where(match, T, F)
    out[null] = U
    return out


def _tri_and(*xs):
    return np.minimum.reduce(xs)


def _tri_or(*xs):
    return np.maximum.reduce(xs)


def _col(width, n, null_frac, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << width, n, dtype=np.uint32)
    nulls = rng.random(n) < null_frac
    return vals, nulls, nullable.pack_nullable(vals, nulls, width)


def test_leaf_excludes_nulls():
    vals, nulls, nc = _col(9, 20_000, 0.2, seed=1)
    bits, count = nullable.evaluate(q.Eq(nc, 0))
    expect = (vals == 0) & ~nulls  # stored 0 at null slots must NOT match
    assert int(count) == int(expect.sum())
    np.testing.assert_array_equal(
        np.asarray(bitvector.to_bool(bits, vals.size)), expect
    )


def test_not_is_kleene():
    vals, nulls, nc = _col(9, 15_000, 0.15, seed=2)
    # SQL: NOT(v = 7) excludes NULL rows too
    bits, count = nullable.evaluate(q.Not(q.Eq(nc, 7)))
    expect = (vals != 7) & ~nulls
    assert int(count) == int(expect.sum())
    np.testing.assert_array_equal(
        np.asarray(bitvector.to_bool(bits, vals.size)), expect
    )


def test_or_null_true_is_true():
    # Or(UNKNOWN, TRUE) = TRUE: null in column a, match in column b
    n = 12_000
    av, an, a = _col(9, n, 0.3, seed=3)
    bv, bn, b = _col(9, n, 0.0, seed=4)
    bits, count = nullable.evaluate(
        q.Or(q.Eq(a, 5), q.Range(b, 0, 256))
    )
    la = _tri_leaf(av == 5, an)
    lb = _tri_leaf(bv < 256, bn)
    expect = _tri_or(la, lb) == T
    assert int(count) == int(expect.sum())
    np.testing.assert_array_equal(
        np.asarray(bitvector.to_bool(bits, n)), expect
    )


def test_nested_kleene_fuzz():
    rng = np.random.default_rng(5)
    n = 9_000
    av, an, a = _col(9, n, 0.2, seed=6)
    bv, bn, b = _col(7, n, 0.1, seed=7)
    expr = q.And(
        q.Not(q.Or(q.Eq(a, 3), q.Range(b, 10, 50))),
        q.Range(a, 0, 400),
    )
    la = _tri_leaf(av == 3, an)
    lb = _tri_leaf((bv >= 10) & (bv < 50), bn)
    lr = _tri_leaf(av < 400, an)
    expect = _tri_and(-_tri_or(la, lb), lr) == T
    bits, count = nullable.evaluate(expr)
    assert int(count) == int(expect.sum())
    np.testing.assert_array_equal(
        np.asarray(bitvector.to_bool(bits, n)), expect
    )


def test_mixed_with_plain_columns_keeps_fusion_semantics():
    n = 10_000
    av, an, a = _col(9, n, 0.25, seed=8)
    pv = np.random.default_rng(9).integers(0, 512, n, dtype=np.uint32)
    p = layout.to_device(layout.pack(pv, 9))
    bits, count = nullable.evaluate(
        q.And(q.Range(p, 100, 300), q.Not(q.Eq(a, 2)))
    )
    expect = (pv >= 100) & (pv < 300) & (av != 2) & ~an
    assert int(count) == int(expect.sum())


def test_pack_nullable_validation():
    with pytest.raises(ValueError, match="same shape"):
        nullable.pack_nullable(
            np.zeros(10, np.uint32), np.zeros(5, bool), 9
        )


def test_mixed_and_groups_pure_siblings_into_one_fused_pass(monkeypatch):
    # the pure conjuncts must reach the planner as ONE And (fused conj
    # pass), not one q.evaluate call per pure leaf
    n = 6_000
    av, an, a = _col(9, n, 0.2, seed=10)
    p1v = np.random.default_rng(11).integers(0, 512, n, dtype=np.uint32)
    p2v = np.random.default_rng(12).integers(0, 128, n, dtype=np.uint32)
    p1 = layout.to_device(layout.pack(p1v, 9))
    p2 = layout.to_device(layout.pack(p2v, 7))

    calls = []
    real = nullable.q.evaluate

    def spy(expr):
        calls.append(expr)
        return real(expr)

    monkeypatch.setattr(nullable.q, "evaluate", spy)
    bits, count = nullable.evaluate(
        nullable.q.And(
            nullable.q.Range(p1, 100, 300),
            nullable.q.Range(p2, 10, 90),
            nullable.q.Not(nullable.q.Eq(a, 2)),
        ),
    )
    expect = (
        (p1v >= 100) & (p1v < 300) & (p2v >= 10) & (p2v < 90)
        & (av != 2) & ~an
    )
    assert int(count) == int(expect.sum())
    # one planner call for both pure ranges (fused), one for the nullable leaf
    pure_ands = [e for e in calls if isinstance(e, nullable.q.And)]
    assert len(pure_ands) == 1 and len(pure_ands[0].terms) == 2
