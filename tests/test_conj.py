"""Conjunctive multi-column scan tests: fused AND of per-column range /
equality predicates, parity against numpy, plus the sharded path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shared_simd_scan_tpu import bitvector, layout
from shared_simd_scan_tpu.ops import conj as conj_ops
from shared_simd_scan_tpu.parallel import dist


def _cols(widths, n, seed=0):
    rng = np.random.default_rng(seed)
    vals, devs = [], []
    for w in widths:
        v = rng.integers(0, 1 << w, size=n, dtype=np.uint32)
        vals.append(v)
        devs.append(layout.to_device(layout.pack(v, w)))
    return vals, devs


def _expect(vals, lows, highs):
    m = np.ones_like(vals[0], dtype=bool)
    for v, lo, hi in zip(vals, lows, highs):
        m &= (v >= lo) & (v < hi)
    return m


def _check(bits, count, n, expect):
    assert int(count) == int(expect.sum())
    assert bitvector.to_bytes(bits, n) == np.packbits(
        expect, bitorder="little"
    ).tobytes()


@pytest.mark.parametrize(
    "widths", [(9, 9), (9, 16), (5, 12, 31), (1, 2, 3, 4)]
)
def test_conj_range_parity(widths):
    n = 25_000
    vals, devs = _cols(widths, n, seed=3)
    lows = np.asarray([(1 << w) // 4 for w in widths], np.uint32)
    highs = np.asarray([3 * (1 << w) // 4 for w in widths], np.uint32)
    bits, count = conj_ops.conj_range_scan_device(
        devs, lows, highs
    )
    _check(bits, count, n, _expect(vals, lows, highs))


def test_conj_single_column_matches_range_scan():
    # m=1 degenerates to the single range scan
    from shared_simd_scan_tpu.ops import scan as scan_ops

    n = 9_000
    vals, devs = _cols((9,), n, seed=4)
    bits, count = conj_ops.conj_range_scan_device(
        devs, [100], [300]
    )
    rbits, rcounts = scan_ops.range_scan_device(
        devs[0], [100], [300]
    )
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(rbits[0]))
    assert int(count) == int(rcounts[0])


def test_conj_eq_and_tail():
    # equality conjunction; n deliberately not a multiple of 32*8
    widths = (9, 7)
    n = 32 * 128 * 8 + 57
    vals, devs = _cols(widths, n, seed=5)
    # force some joint matches so the test is not vacuous
    vals[0][:50] = 7
    vals[1][:50] = 3
    devs = [
        layout.to_device(layout.pack(v, w)) for v, w in zip(vals, widths)
    ]
    bits, count = conj_ops.conj_eq_scan_device(devs, [7, 3])
    expect = (vals[0] == 7) & (vals[1] == 3)
    assert int(count) == int(expect.sum()) >= 50
    _check(bits, count, n, expect)


def test_conj_empty_and_full_ranges():
    widths = (9, 9)
    n = 5_000
    vals, devs = _cols(widths, n, seed=6)
    # empty range on column 1 -> zero matches, all bits zero
    bits, count = conj_ops.conj_range_scan_device(
        devs, [0, 100], [512, 100]
    )
    assert int(count) == 0
    assert not any(bitvector.to_bytes(bits, n))
    # full ranges -> every value matches (padding must stay masked)
    bits, count = conj_ops.conj_range_scan_device(
        devs, [0, 0], [512, 512]
    )
    expect = np.ones(n, dtype=bool)
    _check(bits, count, n, expect)


def test_conj_mismatched_n_raises():
    _, (d1,) = _cols((9,), 1_000, seed=7)
    _, (d2,) = _cols((9,), 2_000, seed=7)
    with pytest.raises(ValueError, match="share n"):
        conj_ops.conj_range_scan_device([d1, d2], [0, 0], [1, 1])


def test_conj_traced_predicates_inside_jit():
    widths = (9, 16)
    n = 12_000
    vals, devs = _cols(widths, n, seed=8)
    tiles = tuple(d.tiles for d in devs)

    @jax.jit
    def run(lows, highs):
        return conj_ops.conj_range_scan_tiles(
            tiles, lows, highs, widths, n
        )

    lows = np.asarray([50, 1000], np.uint32)
    highs = np.asarray([400, 60000], np.uint32)
    bits, count = run(jnp.asarray(lows), jnp.asarray(highs))
    expect = _expect(vals, lows, highs)
    assert int(count) == int(expect.sum())
    from shared_simd_scan_tpu.ops.scan import bits_to_canonical

    got = np.asarray(jax.device_get(bits_to_canonical(bits, n)))
    exp_words = np.zeros((n + 31) // 32, np.uint32)
    idx = np.nonzero(expect)[0]
    np.bitwise_or.at(
        exp_words, idx // 32, np.uint32(1) << (idx % 32).astype(np.uint32)
    )
    np.testing.assert_array_equal(got, exp_words)


def test_sharded_conj_range_scan():
    mesh = dist.make_mesh()
    widths = (9, 11)
    n = 8 * 32 * 128 * 8 + 5
    vals, devs = _cols(widths, n, seed=9)
    sdevs = [dist.shard_column(d, mesh) for d in devs]
    lows = np.asarray([100, 512], np.uint32)
    highs = np.asarray([400, 1500], np.uint32)
    bits, count = dist.sharded_conj_range_scan(
        sdevs, lows, highs, mesh
    )
    expect = _expect(vals, lows, highs)
    assert int(count) == int(expect.sum())
    from shared_simd_scan_tpu.ops.scan import bits_to_canonical

    got = np.asarray(jax.device_get(bits_to_canonical(bits, n)))
    exp_words = np.zeros((n + 31) // 32, np.uint32)
    idx = np.nonzero(expect)[0]
    np.bitwise_or.at(
        exp_words, idx // 32, np.uint32(1) << (idx % 32).astype(np.uint32)
    )
    np.testing.assert_array_equal(got, exp_words)


def test_conj_inverted_bounds_are_empty():
    n = 5_000
    vals, devs = _cols((9,), n, seed=10)
    bits, count = conj_ops.conj_range_scan_device(
        devs, [300], [100]  # hi < lo: empty, not wrapped
    )
    assert int(count) == 0
    assert not any(bitvector.to_bytes(bits, n))
