"""Fused filter+aggregate scan tests: exact per-key SUM/COUNT parity
against the numpy oracle, split-accumulator widths, padding, sharding."""
import jax.numpy as jnp
import numpy as np
import pytest

from shared_simd_scan_tpu import layout
from shared_simd_scan_tpu.ops import aggregate as agg_ops
from shared_simd_scan_tpu.ops import oracle


def _cols(wp, wm, n, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 1 << wp, size=n, dtype=np.uint32)
    m = rng.integers(0, 1 << wm, size=n, dtype=np.uint32)
    return p, m, layout.pack(p, wp), layout.pack(m, wm)


@pytest.mark.parametrize("wp,wm", [(9, 9), (9, 16), (5, 17), (9, 31), (31, 12)])
def test_aggregate_parity_vs_numpy(wp, wm):
    n = 30_000
    p, m, pcol, mcol = _cols(wp, wm, n, seed=wp * 37 + wm)
    pdev, mdev = layout.to_device(pcol), layout.to_device(mcol)
    keys = np.unique(
        np.random.default_rng(1).integers(0, 1 << wp, 8).astype(np.uint32)
    )
    sums, counts = agg_ops.aggregate_scan_device(pdev, mdev, keys)
    esums = np.array(
        [m[p == k].astype(np.uint64).sum() for k in keys], np.uint64
    )
    ecounts = np.array([(p == k).sum() for k in keys], np.uint32)
    np.testing.assert_array_equal(np.asarray(counts), ecounts)
    np.testing.assert_array_equal(sums, esums)


def test_aggregate_matches_oracle():
    wp, wm, n = 9, 20, 12_000
    p, m, pcol, mcol = _cols(wp, wm, n, seed=3)
    pdev, mdev = layout.to_device(pcol), layout.to_device(mcol)
    keys = np.arange(0, 16, dtype=np.uint32)
    sums, counts = agg_ops.aggregate_scan_device(pdev, mdev, keys)
    osums, ocounts = oracle.aggregate_scan(pcol, mcol, keys)
    np.testing.assert_array_equal(sums, osums)
    np.testing.assert_array_equal(np.asarray(counts), ocounts)


def test_aggregate_key_zero_ignores_padding():
    # padding blocks hold p=0, m=0; counts for key 0 must exclude them
    wp, wm, n = 9, 9, 4_099  # ragged tail
    p, m, pcol, mcol = _cols(wp, wm, n, seed=4)
    pdev, mdev = layout.to_device(pcol), layout.to_device(mcol)
    keys = np.array([0], np.uint32)
    sums, counts = agg_ops.aggregate_scan_device(pdev, mdev, keys)
    assert int(counts[0]) == int((p == 0).sum())
    assert int(sums[0]) == int(m[p == 0].astype(np.uint64).sum())


def test_aggregate_split_headroom_wide_measure():
    # wm=31 with adversarial data: every value max, all matching one key
    wp, wm, n = 3, 31, 50_000
    p = np.full(n, 5, np.uint32)
    m = np.full(n, (1 << 31) - 1, np.uint32)
    pdev = layout.to_device(layout.pack(p, wp))
    mdev = layout.to_device(layout.pack(m, wm))
    sums, counts = agg_ops.aggregate_scan_device(
        pdev, mdev, np.array([5], np.uint32)
    )
    assert int(counts[0]) == n
    assert int(sums[0]) == n * ((1 << 31) - 1)  # ~1.07e14, needs uint64


@pytest.mark.parametrize("wp,wm", [(9, 9), (9, 16), (5, 17), (9, 31), (31, 12)])
def test_aggregate_bitplane_static_parity_vs_numpy(wp, wm):
    n = 30_000
    p, m, pcol, mcol = _cols(wp, wm, n, seed=wp * 19 + wm)
    pdev, mdev = layout.to_device(pcol), layout.to_device(mcol)
    keys = np.unique(
        np.random.default_rng(2).integers(0, 1 << wp, 12).astype(np.uint32)
    )
    counts, slo, shi = agg_ops.aggregate_bitplane_static_tiles(
        pdev.tiles, mdev.tiles, keys, wp, wm, n
    )
    sums = agg_ops.finalize_sums(slo, shi)
    esums = np.array(
        [m[p == k].astype(np.uint64).sum() for k in keys], np.uint64
    )
    ecounts = np.array([(p == k).sum() for k in keys], np.uint32)
    np.testing.assert_array_equal(np.asarray(counts), ecounts)
    np.testing.assert_array_equal(sums, esums)


@pytest.mark.parametrize("wp,wm", [(9, 9), (9, 16), (9, 31)])
def test_aggregate_bitplane_traced_parity_vs_numpy(wp, wm):
    n = 20_000
    p, m, pcol, mcol = _cols(wp, wm, n, seed=wp * 7 + wm)
    pdev, mdev = layout.to_device(pcol), layout.to_device(mcol)
    keys = np.unique(
        np.random.default_rng(3).integers(0, 1 << wp, 9).astype(np.uint32)
    )
    counts, slo, shi = agg_ops.aggregate_bitplane_tiles(
        pdev.tiles, mdev.tiles, jnp.asarray(keys), wp, wm, n
    )
    sums = agg_ops.finalize_sums(slo, shi)
    esums = np.array(
        [m[p == k].astype(np.uint64).sum() for k in keys], np.uint64
    )
    ecounts = np.array([(p == k).sum() for k in keys], np.uint32)
    np.testing.assert_array_equal(np.asarray(counts), ecounts)
    np.testing.assert_array_equal(sums, esums)


def test_aggregate_bitplane_key_zero_ignores_padding():
    # padding blocks hold p=0, m=0; key-0 match words must be masked
    wp, wm, n = 9, 9, 4_099  # ragged tail
    p, m, pcol, mcol = _cols(wp, wm, n, seed=6)
    pdev, mdev = layout.to_device(pcol), layout.to_device(mcol)
    keys = np.array([0], np.uint32)
    counts, slo, shi = agg_ops.aggregate_bitplane_static_tiles(
        pdev.tiles, mdev.tiles, keys, wp, wm, n
    )
    assert int(counts[0]) == int((p == 0).sum())
    assert int(agg_ops.finalize_sums(slo, shi)[0]) == int(
        m[p == 0].astype(np.uint64).sum()
    )


def test_aggregate_bitplane_out_of_domain_key():
    wp, wm, n = 5, 9, 8_000
    p, m, pcol, mcol = _cols(wp, wm, n, seed=7)
    pdev, mdev = layout.to_device(pcol), layout.to_device(mcol)
    keys = np.array([3, 1 << wp, 0xFFFFFFFF], np.uint32)
    counts, slo, shi = agg_ops.aggregate_bitplane_static_tiles(
        pdev.tiles, mdev.tiles, keys, wp, wm, n
    )
    sums = agg_ops.finalize_sums(slo, shi)
    assert int(counts[0]) == int((p == 3).sum())
    assert int(sums[0]) == int(m[p == 3].astype(np.uint64).sum())
    assert int(counts[1]) == 0 and int(counts[2]) == 0
    assert int(sums[1]) == 0 and int(sums[2]) == 0


def test_aggregate_bitplane_split_headroom_wide_measure():
    # wm=31 adversarial: every value max, all matching one key — exercises
    # the lo/hi popcount accumulators at their provable headroom bound
    wp, wm, n = 3, 31, 50_000
    p = np.full(n, 5, np.uint32)
    m = np.full(n, (1 << 31) - 1, np.uint32)
    pdev = layout.to_device(layout.pack(p, wp))
    mdev = layout.to_device(layout.pack(m, wm))
    counts, slo, shi = agg_ops.aggregate_bitplane_static_tiles(
        pdev.tiles, mdev.tiles, np.array([5], np.uint32), wp, wm, n,
    )
    assert int(counts[0]) == n
    assert int(agg_ops.finalize_sums(slo, shi)[0]) == n * ((1 << 31) - 1)


def test_aggregate_dispatch_crossover():
    # small k stays on select-accumulate, large k flips to bit-plane, and
    # the costs agree with the tier picked
    assert agg_ops.pick_aggregate_tier(9, 16, np.array([1], np.uint32)) == "compare"
    big = np.arange(32, dtype=np.uint32)
    assert agg_ops.pick_aggregate_tier(9, 16, big) == "bitplane"
    assert agg_ops.aggregate_bitplane_cost(9, 16, big) < agg_ops._agg_compare_cost(
        9, 16, 32
    )


def test_aggregate_device_dispatch_parity():
    # the device entry point must return identical results on either side
    # of the crossover (routes through pick_aggregate_tier)
    wp, wm, n = 9, 16, 25_000
    p, m, pcol, mcol = _cols(wp, wm, n, seed=8)
    pdev, mdev = layout.to_device(pcol), layout.to_device(mcol)
    for k in (1, 2, 24, 32):
        keys = np.random.default_rng(k).permutation(1 << wp)[:k].astype(np.uint32)
        sums, counts = agg_ops.aggregate_scan_device(
            pdev, mdev, keys
        )
        esums = np.array(
            [m[p == kk].astype(np.uint64).sum() for kk in keys], np.uint64
        )
        ecounts = np.array([(p == kk).sum() for kk in keys], np.uint32)
        np.testing.assert_array_equal(np.asarray(counts), ecounts)
        np.testing.assert_array_equal(sums, esums)


@pytest.mark.parametrize("wp,wm", [(9, 9), (9, 31), (16, 12)])
def test_minmax_parity_vs_numpy(wp, wm):
    n = 20_000
    p, m, pcol, mcol = _cols(wp, wm, n, seed=wp + wm)
    pdev, mdev = layout.to_device(pcol), layout.to_device(mcol)
    keys = np.unique(
        np.random.default_rng(2).integers(0, 1 << wp, 6).astype(np.uint32)
    )
    mn, mx, counts = agg_ops.minmax_scan_device(pdev, mdev, keys)
    for j, key in enumerate(keys):
        sel = m[p == key]
        assert int(counts[j]) == sel.size
        if sel.size:
            assert int(mn[j]) == int(sel.min())
            assert int(mx[j]) == int(sel.max())


def test_minmax_empty_group_sentinels():
    wp, wm, n = 9, 31, 5_000
    p = np.zeros(n, np.uint32)  # only value 0 present
    m = np.full(n, (1 << 31) - 1, np.uint32)
    pdev = layout.to_device(layout.pack(p, wp))
    mdev = layout.to_device(layout.pack(m, wm))
    keys = np.array([0, 7], np.uint32)  # key 7 matches nothing
    mn, mx, counts = agg_ops.minmax_scan_device(pdev, mdev, keys)
    assert int(counts[0]) == n and int(counts[1]) == 0
    assert int(mn[0]) == (1 << 31) - 1 and int(mx[0]) == (1 << 31) - 1
    assert int(mn[1]) == 1 << 31  # empty: 2^wm
    assert int(mx[1]) == 0


def test_minmax_key_zero_ignores_padding():
    wp, wm, n = 9, 9, 4_099  # ragged tail; padding p=0, m=0
    rng = np.random.default_rng(8)
    p = np.zeros(n, np.uint32)
    m = rng.integers(100, 512, n, dtype=np.uint32)  # all measures >= 100
    pdev = layout.to_device(layout.pack(p, wp))
    mdev = layout.to_device(layout.pack(m, wm))
    mn, mx, counts = agg_ops.minmax_scan_device(
        pdev, mdev, np.array([0], np.uint32)
    )
    assert int(counts[0]) == n
    assert int(mn[0]) == int(m.min())  # padding zeros must NOT leak in


def test_aggregate_validation():
    wp, wm, n = 9, 9, 1_000
    p, m, pcol, mcol = _cols(wp, wm, n)
    pdev, mdev = layout.to_device(pcol), layout.to_device(mcol)
    with pytest.raises(ValueError, match="1 <= k <= 32"):
        agg_ops.aggregate_scan_device(
            pdev, mdev, np.arange(40, dtype=np.uint32)
        )
    mdev2 = layout.to_device(layout.pack(m[: n - 100], wm))
    with pytest.raises(ValueError, match="column lengths differ"):
        agg_ops.aggregate_scan_device(
            pdev, mdev2, np.arange(4, dtype=np.uint32)
        )


def test_sharded_aggregate_matches_single_chip():
    from shared_simd_scan_tpu.parallel import dist

    wp, wm, n = 9, 17, 60_000
    p, m, pcol, mcol = _cols(wp, wm, n, seed=6)
    pdev, mdev = layout.to_device(pcol), layout.to_device(mcol)
    mesh = dist.make_mesh()
    spdev = dist.shard_column(pdev, mesh)
    smdev = dist.shard_column(mdev, mesh)
    keys = np.arange(0, 8, dtype=np.uint32)
    sums, counts = dist.sharded_aggregate_scan(
        spdev, smdev, keys, mesh
    )
    esums = np.array([m[p == k].astype(np.uint64).sum() for k in keys], np.uint64)
    ecounts = np.array([(p == k).sum() for k in keys], np.uint32)
    np.testing.assert_array_equal(np.asarray(counts), ecounts)
    np.testing.assert_array_equal(sums, esums)

    mn, mx, counts2 = dist.sharded_minmax_scan(
        spdev, smdev, keys, mesh
    )
    for j, key in enumerate(keys):
        sel = m[p == key]
        assert int(counts2[j]) == sel.size
        if sel.size:
            assert int(mn[j]) == int(sel.min())
            assert int(mx[j]) == int(sel.max())


@pytest.mark.parametrize("wm", [9, 16, 31])
def test_masked_aggregate_parity_vs_numpy(wm):
    rng = np.random.default_rng(50 + wm)
    n = 20_000
    mvals = rng.integers(0, 1 << wm, n, dtype=np.uint32)
    mdev = layout.to_device(layout.pack(mvals, wm))
    mask = rng.random(n) < 0.3
    from shared_simd_scan_tpu import bitvector

    bits = bitvector.from_bool(jnp.asarray(mask))
    s, c = agg_ops.masked_aggregate_device(mdev, bits)
    assert int(c) == int(mask.sum())
    assert int(s) == int(mvals[mask].astype(np.uint64).sum())


def test_masked_aggregate_from_query_tree():
    # end-to-end: SELECT SUM(m), COUNT(*) WHERE <predicate tree>
    from shared_simd_scan_tpu import query as q

    rng = np.random.default_rng(60)
    n = 30_000
    pvals = rng.integers(0, 512, n, dtype=np.uint32)
    mvals = rng.integers(0, 1 << 20, n, dtype=np.uint32)
    pdev = layout.to_device(layout.pack(pvals, 9))
    mdev = layout.to_device(layout.pack(mvals, 20))
    bits, _ = q.evaluate(
        q.Or(q.Range(pdev, 10, 50), q.In(pdev, [300, 301, 499])),
    )
    s, c = agg_ops.masked_aggregate_device(mdev, bits)
    mask = ((pvals >= 10) & (pvals < 50)) | np.isin(pvals, [300, 301, 499])
    assert int(c) == int(mask.sum())
    assert int(s) == int(mvals[mask].astype(np.uint64).sum())


def test_masked_aggregate_tail_bits_zero_by_invariant():
    # padding region contributes nothing because bits past n are zero
    rng = np.random.default_rng(61)
    n = 32 * 128 * 8 + 9
    mvals = rng.integers(0, 1 << 16, n, dtype=np.uint32)
    mdev = layout.to_device(layout.pack(mvals, 16))
    from shared_simd_scan_tpu import bitvector

    bits = bitvector.from_bool(jnp.ones(n, bool))
    s, c = agg_ops.masked_aggregate_device(mdev, bits)
    assert int(c) == n
    assert int(s) == int(mvals.astype(np.uint64).sum())


def test_sharded_masked_aggregate_matches_single_chip():
    from shared_simd_scan_tpu import query as q
    from shared_simd_scan_tpu.parallel import dist

    mesh = dist.make_mesh()
    rng = np.random.default_rng(62)
    n = 8 * 32 * 128 * 8 + 3
    pvals = rng.integers(0, 512, n, dtype=np.uint32)
    mvals = rng.integers(0, 1 << 24, n, dtype=np.uint32)
    spdev = dist.shard_column(layout.to_device(layout.pack(pvals, 9)), mesh)
    smdev = dist.shard_column(layout.to_device(layout.pack(mvals, 24)), mesh)
    bits, _ = q.evaluate_sharded(
        q.Range(spdev, 100, 300), mesh
    )
    s, c = dist.sharded_masked_aggregate(smdev, bits, mesh)
    mask = (pvals >= 100) & (pvals < 300)
    assert int(c) == int(mask.sum())
    assert int(s) == int(mvals[mask].astype(np.uint64).sum())


def test_sharded_aggregate_bitplane_dispatch():
    # concrete keys past the crossover route the sharded aggregate through
    # the bit-plane shard_map variant; results must match numpy exactly
    from shared_simd_scan_tpu.parallel import dist

    wp, wm, n = 9, 16, 60_000
    p, m, pcol, mcol = _cols(wp, wm, n, seed=9)
    pdev, mdev = layout.to_device(pcol), layout.to_device(mcol)
    mesh = dist.make_mesh()
    spdev = dist.shard_column(pdev, mesh)
    smdev = dist.shard_column(mdev, mesh)
    keys = np.unique(
        np.random.default_rng(4).integers(0, 1 << wp, 24).astype(np.uint32)
    )
    assert agg_ops.pick_aggregate_tier(wp, wm, keys) == "bitplane"
    sums, counts = dist.sharded_aggregate_scan(
        spdev, smdev, keys, mesh
    )
    esums = np.array(
        [m[p == k].astype(np.uint64).sum() for k in keys], np.uint64
    )
    ecounts = np.array([(p == k).sum() for k in keys], np.uint32)
    np.testing.assert_array_equal(np.asarray(counts), ecounts)
    np.testing.assert_array_equal(sums, esums)
