"""Query-layer tests: predicate trees vs direct numpy evaluation."""
import numpy as np
import pytest

from shared_simd_scan_tpu import bitvector, layout, query as q


def _col(width, n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    return vals, layout.to_device(layout.pack(vals, width))


@pytest.fixture(scope="module")
def table():
    n = 20_000
    a_vals, a = _col(9, n, 1)
    b_vals, b = _col(12, n, 2)
    c_vals, c = _col(7, n, 3)
    return n, (a_vals, a), (b_vals, b), (c_vals, c)


def _check(expr, expect, n):
    bits, count = q.evaluate(expr)
    assert int(count) == int(expect.sum())
    np.testing.assert_array_equal(
        np.asarray(bitvector.to_bool(bits, n)), expect
    )


def test_fused_range_conjunction(table):
    n, (av, a), (bv, b), _ = table
    expr = q.And(q.Range(a, 100, 400), q.Range(b, 1000, 3000))
    _check(expr, (av >= 100) & (av < 400) & (bv >= 1000) & (bv < 3000), n)


def test_eq_is_degenerate_range(table):
    n, (av, a), _, _ = table
    _check(q.Eq(a, 7), av == 7, n)


def test_same_column_ranges_intersect(table):
    n, (av, a), _, _ = table
    expr = q.And(q.Range(a, 50, 300), q.Range(a, 200, 511))
    _check(expr, (av >= 200) & (av < 300), n)
    # statically empty intersection -> all zeros without a kernel pass
    bits, count = q.evaluate(
        q.And(q.Range(a, 50, 100), q.Range(a, 300, 400))
    )
    assert int(count) == 0


def test_in_or_not_composition(table):
    n, (av, a), (bv, b), (cv, c) = table
    expr = q.Or(
        q.In(a, [3, 77, 200, 431]),
        q.And(q.Range(b, 0, 500), q.Not(q.Eq(c, 10))),
    )
    expect = np.isin(av, [3, 77, 200, 431]) | ((bv < 500) & (cv != 10))
    _check(expr, expect, n)


def test_nested_not_tail_invariant(table):
    n, (av, a), _, _ = table
    bits, count = q.evaluate(q.Not(q.Eq(a, 0)))
    assert int(count) == int((av != 0).sum())
    if n % 32:
        assert int(np.asarray(bits)[-1] >> (n % 32)) == 0


def test_mixed_subtree_under_and(table):
    n, (av, a), (bv, b), (cv, c) = table
    expr = q.And(
        q.Range(a, 0, 256),
        q.In(c, list(range(20, 28))),
        q.Or(q.Eq(b, 5), q.Range(b, 3000, 4000)),
    )
    expect = (
        (av < 256)
        & np.isin(cv, np.arange(20, 28))
        & ((bv == 5) | ((bv >= 3000) & (bv < 4000)))
    )
    _check(expr, expect, n)


def test_more_than_max_columns_ranges():
    # > MAX_COLUMNS range conjuncts split into several fused passes
    n = 6_000
    cols = [_col(6, n, 10 + i) for i in range(10)]
    expr = q.And(*[q.Range(d, 8, 56) for _, d in cols])
    expect = np.ones(n, bool)
    for v, _ in cols:
        expect &= (v >= 8) & (v < 56)
    _check(expr, expect, n)


def test_mismatched_n_raises():
    _, a = _col(9, 1_000, 20)
    _, b = _col(9, 2_000, 21)
    with pytest.raises(ValueError, match="share n"):
        q.evaluate(q.And(q.Eq(a, 1), q.Eq(b, 2)))


def test_empty_in_matches_nothing(table):
    n, (av, a), _, _ = table
    bits, count = q.evaluate(
        q.Or(q.In(a, []), q.Eq(a, 3))
    )
    assert int(count) == int((av == 3).sum())


def test_evaluate_sharded_matches_numpy():
    from shared_simd_scan_tpu.ops.scan import bits_to_canonical
    from shared_simd_scan_tpu.parallel import dist

    mesh = dist.make_mesh()
    n = 8 * 32 * 128 * 8 + 13
    av, a = _col(9, n, 30)
    bv, b = _col(11, n, 31)
    sa, sb = dist.shard_column(a, mesh), dist.shard_column(b, mesh)
    expr = q.And(
        q.Range(sa, 50, 400),
        q.Or(q.In(sb, [7, 99, 1500]), q.Not(q.Range(sb, 0, 1024))),
    )
    bits, count = q.evaluate_sharded(expr, mesh)
    expect = ((av >= 50) & (av < 400)) & (
        np.isin(bv, [7, 99, 1500]) | ~(bv < 1024)
    )
    assert int(count) == int(expect.sum())
    got = np.asarray(bitvector.to_bool(bits_to_canonical(bits, n), n))
    np.testing.assert_array_equal(got, expect)


def test_evaluate_sharded_not_tail_stays_zero():
    from shared_simd_scan_tpu.ops.scan import bits_to_canonical
    from shared_simd_scan_tpu.parallel import dist

    mesh = dist.make_mesh()
    n = 8 * 32 * 128 * 8 + 5
    av, a = _col(9, n, 32)
    sa = dist.shard_column(a, mesh)
    bits, count = q.evaluate_sharded(q.Not(q.Eq(sa, 0)), mesh)
    assert int(count) == int((av != 0).sum())
    canon = np.asarray(bits_to_canonical(bits, n))
    if n % 32:
        assert int(canon[-1] >> (n % 32)) == 0


def test_query_fuzz_random_trees():
    # random predicate trees (depth <= 3) vs direct numpy evaluation
    rng = np.random.default_rng(77)
    n = 9_000
    widths = (9, 12, 7)
    cols = [_col(w, n, seed=100 + i) for i, w in enumerate(widths)]

    def leaf():
        i = rng.integers(len(cols))
        v, d = cols[i]
        w = widths[i]
        dom = 1 << w
        kind = rng.integers(3)
        if kind == 0:
            key = int(rng.integers(dom))
            return q.Eq(d, key), v == key
        if kind == 1:
            lo, hi = sorted(int(x) for x in rng.integers(0, dom, 2))
            return q.Range(d, lo, hi), (v >= lo) & (v < hi)
        keys = rng.choice(dom, size=int(rng.integers(1, 12)), replace=False)
        return q.In(d, keys), np.isin(v, keys)

    def tree(depth):
        if depth == 0 or rng.random() < 0.3:
            return leaf()
        kind = rng.integers(3)
        if kind == 2:
            e, m = tree(depth - 1)
            return q.Not(e), ~m
        terms = [tree(depth - 1) for _ in range(int(rng.integers(2, 4)))]
        if kind == 0:
            out = terms[0][1]
            for _, m in terms[1:]:
                out = out & m
            return q.And(*[e for e, _ in terms]), out
        out = terms[0][1]
        for _, m in terms[1:]:
            out = out | m
        return q.Or(*[e for e, _ in terms]), out

    for trial in range(12):
        expr, expect = tree(3)
        bits, count = q.evaluate(expr)
        assert int(count) == int(expect.sum()), trial
        np.testing.assert_array_equal(
            np.asarray(bitvector.to_bool(bits, n)), expect, err_msg=str(trial)
        )


def test_or_of_ranges_fuses_per_column(table):
    n, (av, a), (bv, b), _ = table
    expr = q.Or(
        q.Range(a, 10, 40),
        q.Range(a, 100, 140),
        q.Range(a, 300, 505),
        q.Range(b, 0, 700),
        q.Range(a, 450, 20),  # statically empty disjunct: ignored
    )
    expect = (
        ((av >= 10) & (av < 40))
        | ((av >= 100) & (av < 140))
        | ((av >= 300) & (av < 505))
        | (bv < 700)
    )
    _check(expr, expect, n)


def test_or_of_many_ranges_chunks_past_32(table):
    n, (av, a), _, _ = table
    spans = [(8 * i, 8 * i + 3) for i in range(40)]  # 40 > 32 ranges
    expr = q.Or(*[q.Range(a, lo, hi) for lo, hi in spans])
    expect = np.zeros(n, bool)
    for lo, hi in spans:
        expect |= (av >= lo) & (av < hi)
    _check(expr, expect, n)


def test_sharded_or_of_ranges_fuses():
    from shared_simd_scan_tpu.ops.scan import bits_to_canonical
    from shared_simd_scan_tpu.parallel import dist

    mesh = dist.make_mesh()
    n = 8 * 32 * 128 * 8 + 21
    av, a = _col(9, n, 33)
    sa = dist.shard_column(a, mesh)
    expr = q.Or(q.Range(sa, 5, 30), q.Range(sa, 200, 260), q.Eq(sa, 400))
    bits, count = q.evaluate_sharded(expr, mesh)
    expect = (
        ((av >= 5) & (av < 30))
        | ((av >= 200) & (av < 260))
        | (av == 400)
    )
    assert int(count) == int(expect.sum())
    got = np.asarray(bitvector.to_bool(bits_to_canonical(bits, n), n))
    np.testing.assert_array_equal(got, expect)


def test_explain_names_tiers(table):
    n, (av, a), (bv, b), (cv, c) = table
    plan = q.explain(
        q.And(
            q.Range(a, 100, 400),
            q.Range(b, 0, 500),
            q.Or(q.In(c, list(range(8, 16))), q.In(c, [3, 50, 99])),
        )
    )
    assert "conj:fused-range m=2" in plan
    # the two In disjuncts on one column merge into ONE member pass
    assert "k=11 [merged In/Eq disjuncts, one pass]" in plan
    assert plan.count("member:") == 1
    # a lone In keeps its tier name (consecutive run -> interval)
    assert "member:interval" in q.explain(q.In(c, list(range(8, 16))))
    assert isinstance(plan, str) and plan.count("\n") >= 2


def test_or_merges_in_and_eq_on_same_column(table):
    n, (av, a), _, (cv, c) = table
    expr = q.Or(q.In(c, [5, 9, 80]), q.Eq(c, 100), q.Eq(a, 3))
    bits, count = q.evaluate(expr)
    expect = np.isin(cv, [5, 9, 80, 100]) | (av == 3)
    assert int(count) == int(expect.sum())
    np.testing.assert_array_equal(
        np.asarray(bitvector.to_bool(bits, n)), expect
    )


def test_explain_empty_intersection(table):
    n, (av, a), _, _ = table
    plan = q.explain(q.And(q.Range(a, 50, 60), q.Range(a, 100, 200)))
    assert "statically empty" in plan
