"""IN-list (membership) scan tests: all four kernel tiers + dispatch +
sharded path, parity against the jnp oracle and numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shared_simd_scan_tpu import bitvector, layout
from shared_simd_scan_tpu.ops import member as member_ops
from shared_simd_scan_tpu.ops import oracle


def _col(width, n, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    return vals, layout.pack(vals, width)


def _check(vals, dev, keys, bits, count):
    n = dev.n
    expect = np.isin(vals, np.asarray(keys, np.uint32))
    assert int(count) == int(expect.sum())
    assert bitvector.to_bytes(bits, n) == np.packbits(
        expect, bitorder="little"
    ).tobytes()


def test_member_consecutive_uses_range_tier():
    # consecutive run -> single unsigned compare per value, any k
    width, n = 9, 40_000
    vals, col = _col(width, n, seed=1)
    dev = layout.to_device(col)
    keys = np.arange(100, 180, dtype=np.uint32)  # k=80 consecutive
    bits, count = member_ops.member_scan_device(dev, keys)
    _check(vals, dev, keys, bits, count)


@pytest.mark.parametrize("width", [7, 9, 16, 31])
def test_member_window_tier_clustered(width):
    # clusters of 8 -> few windows, window popmask tier
    n = 30_000
    vals, col = _col(width, n, seed=width)
    dev = layout.to_device(col)
    dom = 1 << width
    bases = np.array([0, 64, 128], np.uint32) % dom
    keys = np.concatenate([b + np.arange(0, 16, 2, dtype=np.uint32) for b in bases])
    keys = (keys % dom).astype(np.uint32)
    bits, count = member_ops.member_scan_device(dev, keys)
    _check(vals, dev, keys, bits, count)


def test_member_compare_tier_spread_keys():
    # spread keys, small k -> compare tier
    width, n = 10, 20_000
    vals, col = _col(width, n, seed=3)
    dev = layout.to_device(col)
    keys = (np.arange(7, dtype=np.uint32) * 131 + 5) % (1 << width)
    bits, count = member_ops.member_scan_device(dev, keys)
    _check(vals, dev, keys, bits, count)


def test_member_chunked_compare_large_spread():
    # 100 spread keys at width 12: one OR over every key in one body
    width, n = 12, 15_000
    vals, col = _col(width, n, seed=4)
    dev = layout.to_device(col)
    keys = ((np.arange(100, dtype=np.uint32) * 37 + 11) % (1 << width)).astype(
        np.uint32
    )
    # keys are spread (few repeats per 32-window) so the window tier loses
    bits, count = member_ops.member_scan_device(dev, keys)
    _check(vals, dev, keys, bits, count)


def test_member_chunked_window_many_clusters():
    # 40 clustered windows: the window tier over all of them in one body
    width, n = 16, 12_000
    vals, col = _col(width, n, seed=5)
    dev = layout.to_device(col)
    bases = (np.arange(40, dtype=np.uint32) * 1024) % (1 << width)
    keys = np.concatenate(
        [b + np.arange(8, dtype=np.uint32) for b in bases]
    ).astype(np.uint32)
    assert len(member_ops.member_window_plan(keys)[0]) > 32
    bits, count = member_ops.member_scan_device(dev, keys)
    _check(vals, dev, keys, bits, count)


@pytest.mark.parametrize("width,k", [(9, 8), (9, 32), (13, 100)])
def test_member_bitsliced_tier_traced(width, k):
    # TRACED spread keys past the cost rule -> bit-sliced tier (width 13
    # prices out the domain bitmap, so k=100 stays bit-sliced).  Concrete
    # keys always prefer the static OR-tree.
    n = 25_000
    vals, col = _col(width, n, seed=40 + k)
    dev = layout.to_device(col)
    keys = ((np.arange(k, dtype=np.uint32) * 37 + 11) % (1 << width)).astype(
        np.uint32
    )

    @jax.jit
    def run(tiles, ks):
        return member_ops.member_scan_tiles(
            tiles, ks, width, dev.n
        )

    bits, count = run(dev.tiles, jnp.asarray(keys))
    _check(vals, dev, keys, bits, count)


@pytest.mark.parametrize("width,k", [(7, 16), (9, 64), (11, 128)])
def test_member_domain_tier_traced(width, k):
    # TRACED spread keys past the flat-cost crossover -> domain-bitmap
    # tier (concrete keys now always prefer the static OR-tree)
    n = 25_000
    vals, col = _col(width, n, seed=60 + width)
    dev = layout.to_device(col)
    keys = ((np.arange(k, dtype=np.uint32) * 37 + 11) % (1 << width)).astype(
        np.uint32
    )

    @jax.jit
    def run(tiles, ks):
        return member_ops.member_scan_tiles(
            tiles, ks, width, dev.n
        )

    bits, count = run(dev.tiles, jnp.asarray(keys))
    _check(vals, dev, keys, bits, count)


@pytest.mark.parametrize("width,k", [(7, 16), (9, 8), (9, 64), (11, 128), (13, 100), (16, 40)])
def test_member_ortree_tier_spread(width, k):
    # concrete spread keys -> the static OR-tree tier at every k (its
    # counted-DAG cost undercuts compare/bit-sliced/domain/window)
    n = 25_000
    vals, col = _col(width, n, seed=80 + width + k)
    dev = layout.to_device(col)
    keys = ((np.arange(k, dtype=np.uint32) * 37 + 11) % (1 << width)).astype(
        np.uint32
    )
    assert member_ops.member_dispatch_tier(keys, width) == "ortree"
    bits, count = member_ops.member_scan_device(dev, keys)
    _check(vals, dev, keys, bits, count)


def test_member_ortree_full_domain_and_out_of_domain():
    width, n = 8, 10_000
    vals, col = _col(width, n, seed=91)
    dev = layout.to_device(col)
    # full domain (shuffled so the interval tier does not claim it):
    # OR-tree root is None -> all-match row, tail still masked
    keys = np.arange(1 << width, dtype=np.uint32)
    keys = np.concatenate([keys[1::2], keys[0::2]])
    bits, count = member_ops.member_scan_device(dev, keys)
    _check(vals, dev, keys, bits, count)
    assert int(count) == n
    # out-of-domain keys are dropped before the DAG build
    keys = np.array([5, 1 << width, (1 << width) + 7, 200], np.uint32)
    bits, count = member_ops.member_scan_device(dev, keys)
    _check(vals, dev, np.array([5, 200], np.uint32), bits, count)


def test_member_ortree_zero_key_padding():
    # key 0 in the set must not match zero-filled padding blocks
    width, n = 9, 4097
    vals, col = _col(width, n, seed=92)
    dev = layout.to_device(col)
    keys = np.array([0, 77, 200, 401, 13, 263, 97, 310], np.uint32)
    assert member_ops.member_dispatch_tier(keys, width) == "ortree"
    bits, count = member_ops.member_scan_device(dev, keys)
    _check(vals, dev, keys, bits, count)


def test_member_domain_traced_keys():
    # traced keys hit the domain tier through the cost fall-through; the
    # bitmap build is a tiny XLA OR-reduce so it works under jit
    width, k, n = 9, 64, 20_000
    vals, col = _col(width, n, seed=77)
    dev = layout.to_device(col)
    keys = ((np.arange(k, dtype=np.uint32) * 53 + 3) % (1 << width)).astype(
        np.uint32
    )

    @jax.jit
    def run(tiles, ks):
        return member_ops.member_scan_tiles(
            tiles, ks, width, dev.n
        )

    bits, count = run(dev.tiles, jnp.asarray(keys))
    n_words = layout.bitvector_words(n)
    canon = bits.reshape(-1)[:n_words]
    expect = np.isin(vals, keys)
    assert int(count) == int(expect.sum())
    assert bitvector.to_bytes(canon, n) == np.packbits(
        expect, bitorder="little"
    ).tobytes()


def test_domain_table_bits_and_duplicates():
    width = 9
    keys = np.array([0, 31, 32, 511, 511, 7, 7], np.uint32)
    tab = np.asarray(member_ops.domain_table(keys, width)).reshape(-1)
    assert tab.shape[0] == (1 << width) // 32
    expect = np.zeros_like(tab)
    for key in set(keys.tolist()):
        expect[key // 32] |= np.uint32(1) << np.uint32(key % 32)
    np.testing.assert_array_equal(tab, expect)


def test_member_bitsliced_direct_out_of_domain():
    # the bit-sliced member tier itself: out-of-domain keys (incl. the
    # all-ones sentinel) match nothing, key 0 ignores padding blocks
    width, n = 9, 100
    vals, col = _col(width, n, seed=8)
    dev = layout.to_device(col)
    keys = np.array([0, 512, 700, 0xFFFFFFFF, int(vals[0])], np.uint32)
    bits, count = member_ops._member_bitsliced_tiles(
        dev.tiles, jnp.asarray(keys), 0, width=width, n=n
    )
    expect = np.isin(vals, keys[keys < 512])
    assert int(count) == int(expect.sum())
    from shared_simd_scan_tpu.ops.scan import bits_to_canonical

    got = np.asarray(bits_to_canonical(bits, n))
    exp_words = np.zeros_like(got)
    idx = np.nonzero(expect)[0]
    np.bitwise_or.at(
        exp_words, idx // 32, np.uint32(1) << (idx % 32).astype(np.uint32)
    )
    np.testing.assert_array_equal(got, exp_words)


def test_member_bitsliced_traced_keys():
    # traced spread keys of static size also route bit-sliced
    width, n, k = 9, 9_000, 16
    vals, col = _col(width, n, seed=9)
    dev = layout.to_device(col)
    keys = ((np.arange(k, dtype=np.uint32) * 53 + 2) % 512).astype(np.uint32)

    @jax.jit
    def run(ks):
        return member_ops.member_scan_device(dev, ks)

    bits, count = run(jnp.asarray(keys))
    _check(vals, dev, keys, bits, count)


def test_member_traced_keys_fall_back_to_compare():
    width, n = 9, 10_000
    vals, col = _col(width, n, seed=6)
    dev = layout.to_device(col)
    keys = np.array([3, 9, 200, 511], np.uint32)

    @jax.jit
    def run(ks):
        return member_ops.member_scan_device(dev, ks)

    bits, count = run(jnp.asarray(keys))
    _check(vals, dev, keys, bits, count)


def test_member_duplicate_keys_count_once():
    width, n = 9, 8_000
    vals, col = _col(width, n, seed=7)
    dev = layout.to_device(col)
    keys = np.array([5, 5, 5, 300, 300], np.uint32)
    bits, count = member_ops.member_scan_device(dev, keys)
    expect = np.isin(vals, np.unique(keys))
    assert int(count) == int(expect.sum())
    # many duplicates in one large key set
    keys2 = np.concatenate(
        [np.full(40, 7, np.uint32), np.full(40, 450, np.uint32)]
    )
    rng = np.random.default_rng(8)
    keys2 = np.concatenate([keys2, rng.integers(0, 512, 30).astype(np.uint32)])
    bits2, count2 = member_ops.member_scan_device(dev, keys2)
    expect2 = np.isin(vals, np.unique(keys2))
    assert int(count2) == int(expect2.sum())
    assert bitvector.to_bytes(bits2, n) == np.packbits(
        expect2, bitorder="little"
    ).tobytes()


def test_member_key_zero_ignores_padding():
    # padding blocks are zero-filled; key 0 in the set must not match them
    width, n = 9, 4_097  # ragged tail
    vals, col = _col(width, n, seed=9)
    dev = layout.to_device(col)
    keys = np.array([0, 17], np.uint32)
    bits, count = member_ops.member_scan_device(dev, keys)
    _check(vals, dev, keys, bits, count)
    # bits at i >= n are zero
    mask = np.frombuffer(bitvector.to_bytes(bits, n), np.uint8)
    tail_bits = np.unpackbits(mask, bitorder="little")[n:]
    assert not tail_bits.any()


def test_member_oracle_matches_numpy():
    width, n = 9, 5_000
    vals, col = _col(width, n, seed=10)
    keys = np.array([1, 2, 3, 400], np.uint32)
    bits, count = oracle.member_scan(col, keys)
    expect = np.isin(vals, keys)
    assert int(count) == int(expect.sum())
    assert bitvector.to_bytes(np.asarray(bits), n) == np.packbits(
        expect, bitorder="little"
    ).tobytes()


def test_member_vs_oracle_fuzz():
    rng = np.random.default_rng(11)
    for width in (1, 5, 9, 24):
        n = int(rng.integers(100, 20_000))
        vals, col = _col(width, n, seed=int(rng.integers(1 << 30)))
        dev = layout.to_device(col)
        k = int(rng.integers(1, 60))
        keys = rng.integers(0, 1 << width, k).astype(np.uint32)
        bits, count = member_ops.member_scan_device(dev, keys)
        obits, ocount = oracle.member_scan(col, keys)
        assert int(count) == int(ocount), (width, n, k)
        np.testing.assert_array_equal(np.asarray(bits), np.asarray(obits))


def test_member_dispatch_stays_static_inside_jit():
    # regression: jnp.asarray inside a jit trace stages numpy constants
    # into Tracers; the dispatcher must inspect the RAW keys argument or
    # concrete key sets silently demote to the traced compare tier
    width, n = 9, 5_000
    vals, col = _col(width, n, seed=20)
    dev = layout.to_device(col)
    keys = np.arange(8, dtype=np.uint32)

    def f_member(tiles):
        return member_ops.member_scan_tiles(
            tiles, keys, width, n
        )[1]

    s = str(jax.make_jaxpr(f_member)(dev.tiles))
    assert "_member_compare_tiles" not in s  # range tier, not compare
    assert "_range_impl" in s

    from shared_simd_scan_tpu.layout import DeviceColumn
    from shared_simd_scan_tpu.ops import scan as scan_ops

    def f_shared(tiles):
        d = DeviceColumn(width=width, n=n, tiles=tiles)
        return scan_ops.shared_scan_device(d, keys)[1]

    s2 = str(jax.make_jaxpr(f_shared)(dev.tiles))
    assert "_interval_impl" in s2  # interval tier, not general compare


def test_member_window_plan():
    bases, pops = member_ops.member_window_plan(
        np.array([0, 1, 33, 40, 95, 33], np.uint32)
    )
    assert bases == [0, 32, 64]
    assert pops == [0b11, (1 << 1) | (1 << 8), 1 << 31]


def test_sharded_member_scan_matches_single_chip():
    from shared_simd_scan_tpu.parallel import dist

    width, n = 9, 50_000
    vals, col = _col(width, n, seed=12)
    dev = layout.to_device(col)
    mesh = dist.make_mesh()
    sdev = dist.shard_column(dev, mesh)
    for keys in (
        np.arange(10, 26, dtype=np.uint32),            # interval tier
        np.array([3, 4, 5, 6, 64, 65, 66, 67], np.uint32),  # window tier
        np.array([7, 199, 402], np.uint32),            # compare tier
        ((np.arange(64, dtype=np.uint32) * 37 + 11) % 512),  # ortree tier
    ):
        bits_s, count_s = dist.sharded_member_scan(
            sdev, keys, mesh
        )
        flat = np.asarray(bits_s).reshape(-1)[: layout.bitvector_words(n)]
        expect = np.isin(vals, keys)
        assert int(count_s) == int(expect.sum())
        assert flat.tobytes()[: (n + 7) // 8] == np.packbits(
            expect, bitorder="little"
        ).tobytes()


def test_ortree_liveness_cap_prices_out_big_dags():
    # a wide-domain spread set whose factored DAG keeps > _ORTREE_MAX_LIVE
    # words live must be priced out of the OR-tree tier (dispatch cap),
    # landing on a flat-cost tier instead — and still verify
    width = 31
    rng = np.random.default_rng(5)
    keys = np.array(
        sorted(set(int(v) for v in rng.integers(0, 1 << width, size=300,
                                                 dtype=np.uint32))),
        dtype=np.uint32,
    )
    from shared_simd_scan_tpu.ops.scan import _static_dag_liveness
    assert _static_dag_liveness(width, keys.tolist(), member=True) \
        > member_ops._ORTREE_MAX_LIVE
    assert member_ops.member_ortree_cost(width, keys) == 1 << 30
    assert member_ops.member_dispatch_tier(keys, width) != "ortree"

    n = 20_000
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    vals[:50] = keys[:50]  # guarantee hits
    dev = layout.pack_device(vals, width)
    _, count = member_ops.member_scan_device(dev, keys)
    assert int(count) == int(np.isin(vals, keys).sum())
