"""Zone-map (scan skipping) tests vs numpy."""
import numpy as np
import pytest

import jax.numpy as jnp

from shared_simd_scan_tpu import bitvector, layout, zonemap


def _sorted_col(width, n, seed=0):
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.integers(0, 1 << width, size=n, dtype=np.uint32))
    return vals, layout.pack_device(jnp.asarray(vals), width)


def _check(vals, dev, zmap, lo, hi):
    bits, cnt = zonemap.pruned_range_scan(
        dev, zmap, lo, hi
    )
    mask = (vals >= lo) & (vals < hi)
    assert int(cnt) == int(mask.sum()), (lo, hi)
    got = np.asarray(bitvector.to_bool(bits, dev.n))
    np.testing.assert_array_equal(got, mask)


def test_zonemap_sorted_point_and_range():
    width, n = 9, 70_000
    vals, dev = _sorted_col(width, n, seed=1)
    zmap = zonemap.build_zonemap(dev, zone_b1=8)
    # point queries incl. absent keys, plus ranges spanning zone edges
    for key in (0, 17, 100, 511):
        bits, cnt = zonemap.pruned_eq_scan(dev, zmap, key)
        assert int(cnt) == int((vals == key).sum())
        got = np.asarray(bitvector.to_bool(bits, n))
        np.testing.assert_array_equal(got, vals == key)
    _check(vals, dev, zmap, 100, 120)
    _check(vals, dev, zmap, 0, 512)      # full domain -> fallback path
    _check(vals, dev, zmap, 511, 512)


def test_zonemap_no_match_prunes_everything():
    width, n = 9, 20_000
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 200, size=n, dtype=np.uint32)  # domain gap
    dev = layout.pack_device(jnp.asarray(vals), width)
    zmap = zonemap.build_zonemap(dev, zone_b1=8)
    assert zonemap.prune_span(zmap, 300, 400) is None
    bits, cnt = zonemap.pruned_range_scan(dev, zmap, 300, 400)
    assert int(cnt) == 0
    assert np.asarray(bits).sum() == 0


def test_zonemap_unsorted_is_sound():
    width, n = 9, 30_000
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    dev = layout.pack_device(jnp.asarray(vals), width)
    zmap = zonemap.build_zonemap(dev, zone_b1=8)
    _check(vals, dev, zmap, 37, 38)   # spans ~everything -> fallback
    _check(vals, dev, zmap, 5, 200)


def test_zonemap_clustered_span_is_small():
    # time-clustered data: values grow with the row index
    width, n = 9, 66_000
    base = (np.arange(n, dtype=np.uint32) * 512) // n
    vals = base  # strictly clustered
    dev = layout.pack_device(jnp.asarray(vals), width)
    zmap = zonemap.build_zonemap(dev, zone_b1=8)
    sp = zonemap.prune_span(zmap, 100, 102)
    assert sp is not None
    start, span = sp
    # the narrow predicate lands on a single zone (the minimum bucket)
    assert span == 8 and span < zmap.b1
    _check(vals, dev, zmap, 100, 102)


def test_zonemap_padding_zone_prunes():
    # a tiny column: the padded tail zones must report (0xFFFFFFFF, 0)
    width, n = 9, 200
    vals = np.full(n, 37, np.uint32)
    dev = layout.pack_device(jnp.asarray(vals), width)
    zmap = zonemap.build_zonemap(dev, zone_b1=8)
    assert zmap.zmax[1:].max(initial=0) == 0  # only zone 0 holds data
    _check(vals, dev, zmap, 37, 38)
    bits, cnt = zonemap.pruned_eq_scan(dev, zmap, 36)
    assert int(cnt) == 0


def test_zonemap_rejects_bad_zone_size():
    width, n = 9, 10_000
    vals = np.zeros(n, np.uint32)
    dev = layout.pack_device(jnp.asarray(vals), width)
    with pytest.raises(ValueError, match="zone_b1"):
        zonemap.build_zonemap(dev, zone_b1=7)


def test_query_planner_uses_zonemaps():
    # Range/Eq leaves on mapped columns prune; composition with
    # unmapped columns, Or and Not stays exact vs numpy
    from shared_simd_scan_tpu import query as q

    width, n = 9, 40_000
    rng = np.random.default_rng(7)
    a_vals = np.sort(rng.integers(0, 1 << width, size=n, dtype=np.uint32))
    b_vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    a = layout.pack_device(jnp.asarray(a_vals), width)
    b = layout.pack_device(jnp.asarray(b_vals), width)
    zmaps = {id(a): zonemap.build_zonemap(a, zone_b1=8)}

    expr = q.And(q.Range(a, 100, 120), q.Not(q.Eq(b, 7)))
    bits, cnt = q.evaluate(expr, zonemaps=zmaps)
    mask = (a_vals >= 100) & (a_vals < 120) & (b_vals != 7)
    assert int(cnt) == int(mask.sum())
    np.testing.assert_array_equal(
        np.asarray(bitvector.to_bool(bits, n)), mask
    )

    expr2 = q.Or(q.Eq(a, 3), q.Range(b, 500, 512))
    bits2, cnt2 = q.evaluate(expr2, zonemaps=zmaps)
    mask2 = (a_vals == 3) | (b_vals >= 500)
    assert int(cnt2) == int(mask2.sum())
    np.testing.assert_array_equal(
        np.asarray(bitvector.to_bool(bits2, n)), mask2
    )

    # identical results without the zonemap (the pruning is transparent)
    bits3, cnt3 = q.evaluate(expr)
    assert int(cnt3) == int(cnt)
    np.testing.assert_array_equal(np.asarray(bits3), np.asarray(bits))


@pytest.mark.parametrize("n", [40_000, 32_768 * 8])  # partial + exact zones
def test_zonemap_from_values_matches_device_build(n):
    width = 9
    rng = np.random.default_rng(n)
    vals = rng.integers(1, 1 << width, size=n, dtype=np.uint32)
    dev = layout.pack_device(jnp.asarray(vals), width)
    zdev = zonemap.build_zonemap(dev, zone_b1=8)
    zval = zonemap.build_zonemap_from_values(vals, dev.tiles.shape[1],
                                             zone_b1=8)
    np.testing.assert_array_equal(zdev.zmin, zval.zmin)
    np.testing.assert_array_equal(zdev.zmax, zval.zmax)
    assert zdev.zone_b1 == zval.zone_b1 and zdev.b1 == zval.b1


def _zcheck(vals, dev, zmap, lo, hi):
    bits, cnt = zonemap.zoned_range_scan(dev, zmap, lo, hi)
    mask = (vals >= lo) & (vals < hi)
    assert int(cnt) == int(mask.sum()), (lo, hi)
    got = np.asarray(bitvector.to_bool(bits, dev.n))
    np.testing.assert_array_equal(got, mask)


def test_zoned_scan_clustered_unsorted():
    # matching values clustered at BOTH file ends: prune_span degrades to
    # a (near-)full span, the gathered scan keeps per-zone skipping
    width, n = 9, 9 * 8 * 128 * 32  # b1 = 72 rows worth at w=9... n values
    rng = np.random.default_rng(5)
    vals = rng.integers(100, 200, size=n, dtype=np.uint32)
    vals[: 4096 * 8] = 7          # first zone rows
    vals[-4096 * 8 :] = 7         # last zone rows
    dev = layout.pack_device(jnp.asarray(vals), width)
    zmap = zonemap.build_zonemap(dev, zone_b1=8)
    # the single-span pruner must cover ~the whole column here
    s, span = zonemap.prune_span(zmap, 7, 8)
    assert span >= zmap.b1 // 2
    # the gathered scan sees only the two end clusters
    live = zonemap.zone_step_mask(zmap, 7, 8, 8)
    assert live[0] and live[-1] and not live[1:-1].any()
    _zcheck(vals, dev, zmap, 7, 8)
    _zcheck(vals, dev, zmap, 150, 160)   # dense -> fallback path
    _zcheck(vals, dev, zmap, 300, 400)   # nothing matches


def test_zoned_scan_ragged_tail_and_padding():
    width, n = 9, 70_003  # ragged: validity tail mid-step
    rng = np.random.default_rng(6)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    vals[n - 10 :] = 3
    dev = layout.pack_device(jnp.asarray(vals), width)
    zmap = zonemap.build_zonemap(dev, zone_b1=8)
    _zcheck(vals, dev, zmap, 3, 4)


def test_zoned_scan_padded_grid_steps_do_not_double_count():
    # 3 live zones -> g=4: the padded entry revisits a live tile; counts
    # must not change
    width, n = 9, 9 * 8 * 128 * 32
    rng = np.random.default_rng(7)
    vals = rng.integers(100, 200, size=n, dtype=np.uint32)
    for z in (0, 16, 64):  # three separated zones of key 9 (block rows)
        vals[z * 4096 : (z + 8) * 4096] = 9
    dev = layout.pack_device(jnp.asarray(vals), width)
    zmap = zonemap.build_zonemap(dev, zone_b1=8)
    live = zonemap.zone_step_mask(zmap, 9, 10, 8)
    assert int(live.sum()) == 3
    _zcheck(vals, dev, zmap, 9, 10)
