"""Property-based fuzz over the COMPOSED analytics surface.

Randomized (width, predicate tree, nullable x FOR x dict wrapping,
local vs sharded) against an independent numpy Kleene-logic oracle —
the reference's oracle-comparison pattern (test/simd_scan_tests.cpp)
scaled up to the planner surface this rebuild adds.

Design notes for CI budget: trees, range bounds and data are fully
random per seed, but In-list key sets draw from small per-width pools
and ``n`` is fixed — concrete key sets and array shapes are jit-cache
keys, so unbounded randomness there would recompile every case.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from shared_simd_scan_tpu import (
    bitvector,
    dictcol,
    forcol,
    layout,
    nullable,
    query as q,
)
from shared_simd_scan_tpu.ops import aggregate as agg_ops

N = 4097  # odd tail: exercises the padding/mask path in every kernel
WIDTHS = (5, 9)

# fixed In-list pools per width (jit-cache friendly: concrete key sets
# are static compile keys)
KEY_POOLS = {
    w: [
        tuple(range(3, 3 + min(6, 1 << (w - 1)))),                   # interval
        tuple(int(x) for x in (np.arange(3) * 61 + 3) % (1 << w)),   # compare
        tuple(int(x) for x in (np.arange(8) * 97 + 5) % (1 << w)),   # ortree
        tuple(sorted({int(x) for x in (np.arange(17) * 37 + 11) % (1 << w)})),
    ]
    for w in WIDTHS
}
# one big spread set at the wide width: reaches the multi-chunk member /
# static-DAG grouping paths through the planner
KEY_POOLS[9].append(
    tuple(sorted({int(x) for x in (np.arange(40) * 53 + 7) % (1 << 9)}))
)


def _make_columns(rng, nullable_mask=False):
    """-> list of (leaf_col, values, null_mask) with leaf_col a
    DeviceColumn or NullableColumn."""
    cols = []
    for w in WIDTHS:
        vals = rng.integers(0, 1 << w, N, dtype=np.uint32)
        if nullable_mask:
            nulls = rng.random(N) < 0.15
            col = nullable.pack_nullable(vals, nulls, w)
            vals = vals.copy()
            vals[nulls] = 0  # stored value at null slots
        else:
            nulls = np.zeros(N, bool)
            col = layout.to_device(layout.pack(vals, w))
        cols.append((col, vals, nulls, w))
    return cols


def _rand_tree(rng, cols, depth):
    """Random predicate tree; leaves reference the (col, width) pool."""
    if depth == 0 or rng.random() < 0.4:
        col, _, _, w = cols[rng.integers(len(cols))]
        r = rng.random()
        if r < 0.45:
            lo = int(rng.integers(0, 1 << w))
            hi = int(rng.integers(lo, (1 << w) + 1))
            return q.Range(col, lo, hi)
        if r < 0.6:
            return q.Eq(col, int(rng.integers(0, 1 << w)))
        pool = KEY_POOLS[w]
        return q.In(col, pool[rng.integers(len(pool))])
    r = rng.random()
    if r < 0.2:
        return q.Not(_rand_tree(rng, cols, depth - 1))
    ctor = q.And if r < 0.6 else q.Or
    arity = int(rng.integers(2, 4))
    return ctor(*[_rand_tree(rng, cols, depth - 1) for _ in range(arity)])


def _ref_tu(expr, data):
    """Numpy Kleene oracle -> (true, unknown) boolean arrays.

    ``data`` maps id(leaf col) -> (values, null_mask)."""
    if isinstance(expr, q.Range):
        vals, nulls = data[id(expr.col)]
        m = (vals >= expr.lo) & (vals < expr.hi)
        return m & ~nulls, nulls.copy()
    if isinstance(expr, q.In):
        vals, nulls = data[id(expr.col)]
        m = np.isin(vals, np.asarray(expr.keys, np.uint32))
        return m & ~nulls, nulls.copy()
    if isinstance(expr, q.Not):
        t, u = _ref_tu(expr.term, data)
        return ~(t | u), u
    tus = [_ref_tu(x, data) for x in expr.terms]
    t, tu = tus[0][0].copy(), tus[0][0] | tus[0][1]
    if isinstance(expr, q.And):
        for ti, ui in tus[1:]:
            t &= ti
            tu &= ti | ui
    else:
        for ti, ui in tus[1:]:
            t |= ti
            tu |= ti | ui
    return t, tu & ~t


def _check_bits(bits, count, expect):
    assert int(count) == int(expect.sum())
    got = np.asarray(bits)
    ref = np.packbits(expect, bitorder="little")
    ref = np.pad(ref, (0, (-len(ref)) % 4)).view(np.uint32)
    np.testing.assert_array_equal(got[: len(ref)], ref)


def test_fuzz_plain_trees_and_aggregates():
    rng = np.random.default_rng(12345)
    cols = _make_columns(rng)
    data = {id(c): (v, nl) for c, v, nl, _ in cols}
    # a measure column for the masked-aggregate cross-check
    mw = 11
    mvals = rng.integers(0, 1 << mw, N, dtype=np.uint32)
    mdev = layout.to_device(layout.pack(mvals, mw))
    for case in range(50):
        tree = _rand_tree(rng, cols, depth=3)
        expect, u = _ref_tu(tree, data)
        assert not u.any()  # plain columns: never unknown
        bits, count = q.evaluate(tree)
        _check_bits(bits, count, expect)
        assert isinstance(q.explain(tree), str)  # planner smoke
        if case % 10 == 0:
            s, c = agg_ops.masked_aggregate_device(
                mdev, bits
            )
            assert int(c) == int(expect.sum())
            assert int(s) == int(mvals[expect].astype(np.uint64).sum())


def test_fuzz_nullable_trees():
    rng = np.random.default_rng(777)
    cols = _make_columns(rng, nullable_mask=True)
    # mix in one plain column so pure subtrees keep the fused planner
    pv = rng.integers(0, 1 << 9, N, dtype=np.uint32)
    plain = layout.to_device(layout.pack(pv, 9))
    cols.append((plain, pv, np.zeros(N, bool), 9))
    data = {id(c): (v, nl) for c, v, nl, _ in cols}
    for _ in range(30):
        tree = _rand_tree(rng, cols, depth=3)
        expect, _ = _ref_tu(tree, data)
        bits, count = nullable.evaluate(tree)
        _check_bits(bits, count, expect)


def test_fuzz_for_dict_trees():
    rng = np.random.default_rng(4242)
    # FOR column: narrow band at a large base; dict column: arbitrary
    # sparse 64-bit-ish domain
    base = 1_000_000
    fvals = (base + rng.integers(0, 200, N)).astype(np.uint64)
    fc = forcol.pack_for(fvals)
    dom = np.sort(rng.choice(10_000_000, size=37, replace=False)).astype(
        np.uint64
    )
    dvals = dom[rng.integers(0, dom.size, N)]
    dc = dictcol.pack_dict(dvals)
    for _ in range(15):
        flo = int(rng.integers(base - 10, base + 210))
        fhi = int(rng.integers(flo, base + 220))
        dlo = int(rng.integers(0, 10_000_000))
        dhi = int(rng.integers(dlo, 10_000_001))
        dkeys = tuple(
            int(x) for x in rng.choice(dom, size=5, replace=False)
        ) + (int(rng.integers(0, 10_000_000)),)  # + likely-absent key
        tree = q.And(
            q.Range(fc, flo, fhi),
            q.Or(q.Range(dc, dlo, dhi), q.In(dc, dkeys)),
        )
        expect = ((fvals >= flo) & (fvals < fhi)) & (
            ((dvals >= dlo) & (dvals < dhi))
            | np.isin(dvals, np.asarray(dkeys, np.uint64))
        )
        bits, count = dictcol.evaluate(tree)
        _check_bits(bits, count, expect)


def test_fuzz_sharded_matches_local():
    from shared_simd_scan_tpu.parallel import dist

    rng = np.random.default_rng(99)
    cols = _make_columns(rng)
    data = {id(c): (v, nl) for c, v, nl, _ in cols}
    mesh = dist.make_mesh()
    sharded_cols = []
    for c, v, nl, w in cols:
        sc = dist.shard_column(c, mesh)
        sharded_cols.append((sc, v, nl, w))
    smap = {
        id(sc): orig
        for (sc, _, _, _), (orig, _, _, _) in zip(sharded_cols, cols)
    }

    def _to_local(expr):
        if isinstance(expr, q.Range):
            return q.Range(smap[id(expr.col)], expr.lo, expr.hi)
        if isinstance(expr, q.In):
            return q.In(smap[id(expr.col)], expr.keys)
        if isinstance(expr, q.Not):
            return q.Not(_to_local(expr.term))
        ctor = q.And if isinstance(expr, q.And) else q.Or
        return ctor(*[_to_local(t) for t in expr.terms])

    for _ in range(10):
        tree = _rand_tree(rng, sharded_cols, depth=2)
        expect, _ = _ref_tu(_to_local(tree), {
            id(orig): data[id(orig)] for orig, _, _, _ in cols
        })
        bits_s, count_s = q.evaluate_sharded(tree, mesh)
        flat = np.asarray(bits_s).reshape(-1)[: layout.bitvector_words(N)]
        _check_bits(jnp.asarray(flat), count_s, expect)
