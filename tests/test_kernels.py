"""Tier parity tests vs the jnp oracle (XLA tiers compiled on the CPU,
Triton-driver tiers interpreted).

Mirrors the reference's oracle test pattern (test/simd_scan_tests.cpp):
vectorized tiers checked against scalar-semantics oracles on the Catch2
corpora plus randomized widths — but covering EVERY tier and both
drivers, closing the reference's coverage gap (SURVEY.md §4).
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shared_simd_scan_tpu import bitvector, layout
from shared_simd_scan_tpu.ops import oracle, scan as scan_ops, unpack as unpack_ops

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "reference_golden_9bit.json").read_text()
)
RAMP509 = np.arange(509, dtype=np.uint32)
TINY12 = np.array([1, 2, 3, 3, 2, 1, 1, 2, 3, 1, 2, 3], dtype=np.uint32)

WIDTHS = [1, 2, 3, 5, 7, 8, 9, 11, 16, 17, 24, 25, 31]


def _rand_column(width, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << width, size=n, dtype=np.uint32)


@pytest.mark.parametrize("width", WIDTHS)
def test_unpack_kernel_parity(width):
    n = 10_000
    vals = _rand_column(width, n, seed=width)
    dev = layout.pack_device(vals, width)
    out = unpack_ops.unpack_device(dev)
    np.testing.assert_array_equal(np.asarray(out), vals)


def test_unpack_kernel_ramp509_golden():
    dev = layout.pack_device(jnp.asarray(RAMP509), 9)
    out = unpack_ops.unpack_device(dev)
    np.testing.assert_array_equal(np.asarray(out), RAMP509)
    np.testing.assert_array_equal(
        np.asarray(out[:16]), np.array(GOLDEN["ramp509_decompressed_first16"])
    )


@pytest.mark.parametrize("width", [1, 9, 16, 31])
def test_pack_kernel_roundtrip(width):
    n = 33 * 128 + 17  # exercise partial block + partial lane tile
    vals = _rand_column(width, n, seed=100 + width)
    dev = layout.pack_device(vals, width)
    unpacked_dev_layout = unpack_ops.unpack_tiles(dev.tiles, width)
    repacked = unpack_ops.pack_tiles(unpacked_dev_layout, width)
    np.testing.assert_array_equal(np.asarray(repacked), np.asarray(dev.tiles))


@pytest.mark.parametrize("width", [3, 9, 17])
def test_scan_kernel_parity(width):
    n = 12_345
    vals = _rand_column(width, n, seed=width)
    key = int(vals[7])
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    bits, hits = scan_ops.scan_device(dev, key)
    obits, ohits = oracle.scan(col, key)
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(obits))
    assert int(hits) == int(ohits) == int(np.sum(vals == key))


def test_scan_kernel_golden_tiny12():
    dev = layout.pack_device(jnp.asarray(TINY12), 9)
    bits, hits = scan_ops.scan_device(dev, 3)
    assert int(hits) == GOLDEN["tiny12_scan3_hits"] == 4
    assert bitvector.to_bytes(bits, 12) == bytes(GOLDEN["tiny12_scan3_bits"])


def test_scan_kernel_golden_ramp509():
    dev = layout.pack_device(jnp.asarray(RAMP509), 9)
    bits, hits = scan_ops.scan_device(dev, 3)
    assert int(hits) == GOLDEN["ramp509_scan3_hits"]
    assert bitvector.to_bytes(bits, 509) == bytes(GOLDEN["ramp509_scan3_bits"])


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_shared_scan_kernel_parity(k):
    width, n = 9, 20_000
    vals = _rand_column(width, n, seed=k)
    keys = np.arange(k, dtype=np.uint32)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    bits, counts = scan_ops.shared_scan_device(dev, keys)
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(obits))
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    for j in range(k):
        assert int(counts[j]) == int(np.sum(vals == keys[j]))


def test_shared_scan_padding_bits_zero():
    # padded blocks are zero-valued; predicate 0 must NOT match padding
    width, n = 9, 100  # far below one lane tile (128 blocks)
    vals = _rand_column(width, n, seed=5)
    dev = layout.pack_device(vals, width)
    bits, counts = scan_ops.shared_scan_device(dev, np.array([0], np.uint32))
    assert int(counts[0]) == int(np.sum(vals == 0))
    assert np.asarray(bitvector.to_bool(bits[0], n)).sum() == int(counts[0])


def test_shared_scan_linear_kernel_parity():
    width, n, k = 9, 4_096, 4
    vals = _rand_column(width, n, seed=9)
    keys = np.arange(k, dtype=np.uint32)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    lin = scan_ops.shared_scan_linear_device(dev, keys)
    olin = oracle.shared_scan_linear(col, keys)
    np.testing.assert_array_equal(np.asarray(lin), np.asarray(olin))


TIER_CASES = [
    ("compare", k, "xla") for k in (1, 3, 8, 33, 64, 100, 256)
] + [("compare", k, "triton") for k in (1, 3, 8)] + [
    ("bitsliced", 3, "xla"), ("bitsliced", 40, "xla"),
    ("bitsliced", 3, "triton"), ("bitsliced", 8, "triton"),
    ("bitsliced", 20, "triton"),
    ("static", 8, "xla"), ("static", 48, "xla"),
    ("static", 8, "triton"), ("static", 20, "triton"),
    ("interval", 8, "xla"), ("interval", 40, "xla"), ("interval", 100, "xla"),
    ("interval", 1, "triton"), ("interval", 8, "triton"),
    ("interval", 32, "triton"), ("interval", 33, "triton"),
]


def _tier_call(tier, tiles, keys, width, n, backend):
    if tier == "compare":
        return scan_ops.shared_scan_tiles(tiles, jnp.asarray(keys), width, n,
                                          backend=backend)
    if tier == "bitsliced":
        return scan_ops.shared_scan_bitsliced_tiles(
            tiles, jnp.asarray(keys), width, n, backend=backend)
    if tier == "static":
        return scan_ops.shared_scan_bitsliced_static_tiles(
            tiles, keys, width, n, backend=backend)
    return scan_ops.interval_scan_tiles(
        tiles, int(keys[0]), len(keys), width, n, backend=backend)


@pytest.mark.parametrize("tier,k,backend", TIER_CASES)
def test_tier_driver_parity(tier, k, backend):
    # every tier body under both drivers (Triton interpreted on the CPU)
    # against the oracle; ragged n exercises the validity tail
    width, n = 9, 15_001
    vals = _rand_column(width, n, seed=60 + k)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    if tier == "interval":
        keys = np.arange(7, 7 + k, dtype=np.uint32)
    else:
        keys = (np.arange(k, dtype=np.uint32) * 11 + 5) % (1 << width)
    bits, counts = _tier_call(tier, dev.tiles, keys, width, n, backend)
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(
        np.asarray(scan_ops.bits_to_canonical(bits, n)), np.asarray(obits)
    )


def test_dispatch_routes_tiers_to_drivers():
    # the static driver choice: TRITON_TIERS run a Pallas (Triton)
    # program up to their key cap, everything else is plain XLA
    import jax

    width, n = 9, 5_000
    tiles = layout.pack_device(_rand_column(width, n, seed=1), width).tiles

    def has_pallas(fn):
        return "pallas_call" in str(jax.make_jaxpr(fn)(tiles))

    assert "interval" in scan_ops.TRITON_TIERS
    assert has_pallas(lambda t: scan_ops.interval_scan_tiles(t, 0, 8, width, n))
    assert not has_pallas(
        lambda t: scan_ops.interval_scan_tiles(
            t, 0, scan_ops.TRITON_TIERS["interval"] + 1, width, n))
    assert not has_pallas(
        lambda t: scan_ops.windowed_scan_tiles(t, np.arange(8), width, n))
    assert not has_pallas(
        lambda t: scan_ops.interval_scan_tiles(t, 0, 8, width, n, backend="xla"))
    with pytest.raises(ValueError, match="backend"):
        scan_ops.interval_scan_tiles(tiles, 0, 8, width, n, backend="mosaic")


def test_triton_interpret_switch(monkeypatch):
    # the one interpret switch: interpreted on the CPU, compiled on the
    # GPU, an error anywhere else
    import jax

    from shared_simd_scan_tpu.ops import driver

    assert driver.triton_interpret() is True
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert driver.triton_interpret() is False
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="not on .rocm."):
        driver.triton_interpret()


def test_shared_scan_device_dispatch_large_k():
    width, n, k = 9, 10_000, 40
    vals = _rand_column(width, n, seed=3)
    dev = layout.pack_device(vals, width)
    keys = (np.arange(k, dtype=np.uint32) * 5 + 2) % (1 << width)
    bits, counts = scan_ops.shared_scan_device(dev, keys)
    for j in range(k):
        assert int(counts[j]) == int((vals == keys[j]).sum())


def test_chunked_dispatch_used_above_32():
    # shared_scan_device must route k>32 arbitrary keys through its
    # dispatch and still match the oracle
    width, n, k = 7, 20_000, 40
    vals = _rand_column(width, n, seed=9)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    keys = (np.arange(k, dtype=np.uint32) * 3 + 1) % (1 << width)
    bits, counts = scan_ops.shared_scan_device(dev, keys)
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(obits))


@pytest.mark.parametrize("k", [1, 5, 8, 32, 33, 64, 100, 256])
def test_bitsliced_shared_scan_parity(k):
    # arbitrary spread keys through the bit-sliced (bit-plane) tier,
    # cross-checked against the oracle
    width, n = 9, 50_000
    vals = _rand_column(width, n, seed=k)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    keys = (np.arange(k, dtype=np.uint32) * 11 + 5) % (1 << width)
    bits, counts = scan_ops.shared_scan_bitsliced_tiles(
        dev.tiles, jnp.asarray(keys), width, n
    )
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(
        np.asarray(scan_ops.bits_to_canonical(bits, n)), np.asarray(obits)
    )


@pytest.mark.parametrize("width", [1, 3, 8, 16, 17, 31])
def test_bitsliced_shared_scan_widths(width):
    width_dom = min(1 << width, 1 << 16)
    n, k = 20_000, 24
    vals = _rand_column(width, n, seed=width)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    rng = np.random.default_rng(width)
    keys = rng.integers(0, width_dom, k, dtype=np.uint32)
    bits, counts = scan_ops.shared_scan_bitsliced_tiles(
        dev.tiles, jnp.asarray(keys), width, n
    )
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(
        np.asarray(scan_ops.bits_to_canonical(bits, n)), np.asarray(obits)
    )


def test_bitsliced_out_of_domain_and_padding():
    # keys >= 2^width must match nothing (only width planes are compared,
    # so without the kill mask key 512+v would alias v at width 9); key 0
    # must not match zero-filled padding blocks
    width, n = 9, 100
    vals = _rand_column(width, n, seed=2)
    dev = layout.pack_device(vals, width)
    keys = np.array([0, 512, 513, int(vals[3]) + 512, 0xFFFFFFFF], np.uint32)
    bits, counts = scan_ops.shared_scan_bitsliced_tiles(
        dev.tiles, jnp.asarray(keys), width, n
    )
    assert int(counts[0]) == int((vals == 0).sum())
    assert np.asarray(counts)[1:].sum() == 0
    assert np.asarray(scan_ops.bits_to_canonical(bits, n))[1:].sum() == 0


@pytest.mark.parametrize("k", [1, 2, 8, 32, 33, 100, 256, 300])
def test_bitsliced_static_shared_scan_parity(k):
    # concrete spread keys through the static AND-DAG bit-sliced tier
    # (shared memoized combo tree instead of the per-key XOR+AND fold),
    # cross-checked against the oracle.  k=300 exercises one DAG over
    # more keys than the dispatch's cost-model groups.
    width, n = 9, 50_000
    vals = _rand_column(width, n, seed=k + 1000)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    keys = (np.arange(k, dtype=np.uint32) * 11 + 5) % (1 << width)
    bits, counts = scan_ops.shared_scan_bitsliced_static_tiles(
        dev.tiles, keys, width, n
    )
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(
        np.asarray(scan_ops.bits_to_canonical(bits, n)), np.asarray(obits)
    )


@pytest.mark.parametrize("width", [1, 3, 8, 16, 17, 31])
def test_bitsliced_static_shared_scan_widths(width):
    width_dom = min(1 << width, 1 << 16)
    n, k = 20_000, 24
    vals = _rand_column(width, n, seed=width + 50)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    rng = np.random.default_rng(width + 50)
    keys = rng.integers(0, width_dom, k, dtype=np.uint32)
    bits, counts = scan_ops.shared_scan_bitsliced_static_tiles(
        dev.tiles, keys, width, n
    )
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(
        np.asarray(scan_ops.bits_to_canonical(bits, n)), np.asarray(obits)
    )


def test_bitsliced_static_out_of_domain_and_padding():
    # out-of-domain keys produce constant-zero rows; key 0 must not match
    # zero-filled padding blocks; duplicate keys each get their own row
    width, n = 9, 100
    vals = _rand_column(width, n, seed=2)
    dev = layout.pack_device(vals, width)
    keys = np.array(
        [0, 512, int(vals[3]) + 512, 0xFFFFFFFF, 0, int(vals[3])], np.uint32
    )
    bits, counts = scan_ops.shared_scan_bitsliced_static_tiles(
        dev.tiles, keys, width, n
    )
    counts = np.asarray(counts)
    assert counts[0] == (vals == 0).sum() == counts[4]
    assert counts[1] == counts[2] == counts[3] == 0
    assert counts[5] == (vals == vals[3]).sum()
    assert np.asarray(scan_ops.bits_to_canonical(bits, n))[1:4].sum() == 0


def test_bitsliced_static_rejects_traced_keys():
    import jax

    width, n = 9, 1000
    vals = _rand_column(width, n, seed=3)
    dev = layout.pack_device(vals, width)

    @jax.jit
    def run(keys):
        return scan_ops.shared_scan_bitsliced_static_tiles(
            dev.tiles, keys, width, n
        )

    with pytest.raises(TypeError, match="concrete keys"):
        run(jnp.arange(8, dtype=jnp.uint32))


def test_shared_scan_device_dispatches_static_dag_for_spread_keys():
    # concrete spread keys must reach the static AND-DAG tier (not the
    # traced bit-sliced tier, and not the traced compare fallback)
    import jax

    width, n = 9, 5000
    vals = _rand_column(width, n, seed=4)
    dev_tiles = layout.pack_device(vals, width).tiles
    keys = (np.arange(8, dtype=np.uint32) * 97 + 5) % 512

    def f(tiles):
        d = layout.DeviceColumn(width=width, n=n, tiles=tiles)
        return scan_ops.shared_scan_device(d, keys)[1]

    s = str(jax.make_jaxpr(f)(dev_tiles))
    assert "_static_impl" in s
    # and the result is right
    d = layout.DeviceColumn(width=width, n=n, tiles=dev_tiles)
    _, counts = scan_ops.shared_scan_device(d, keys)
    for j in range(8):
        assert int(counts[j]) == int((vals == keys[j]).sum())


def test_bitsliced_traced_keys():
    # nothing inspects key VALUES, so the tier must work with keys
    # produced inside a jit trace
    import jax

    width, n, k = 9, 10_000, 48
    vals = _rand_column(width, n, seed=7)
    dev = layout.pack_device(vals, width)

    @jax.jit
    def run(base):
        keys = (base + jnp.arange(k, dtype=jnp.uint32) * 13) % 512
        return scan_ops.shared_scan_bitsliced_tiles(
            dev.tiles, keys, width, n
        )

    _, counts = run(jnp.uint32(5))
    keys = (5 + np.arange(k, dtype=np.uint32) * 13) % 512
    for j in range(k):
        assert int(counts[j]) == int((vals == keys[j]).sum())


@pytest.mark.parametrize("spread", ["clustered", "spread", "dupes"])
def test_windowed_scan_parity(spread):
    # arbitrary concrete keys via the 32-aligned-window tier
    width, n = 9, 40_000
    vals = _rand_column(width, n, seed=3)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    if spread == "clustered":
        keys = np.array([10, 11, 12, 40, 41, 42, 43, 100, 101, 102,
                         103, 104, 200, 201], np.uint32)
    elif spread == "spread":
        keys = (np.arange(20, dtype=np.uint32) * 25 + 3) % 512
    else:
        keys = np.array([7, 7, 300, 300, 12], np.uint32)  # duplicates
    bits, counts = scan_ops.windowed_scan_tiles(
        dev.tiles, keys, width, n
    )
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(
        np.asarray(scan_ops.bits_to_canonical(bits, n)), np.asarray(obits)
    )


def test_windowed_dispatch_cost_rule():
    # clustered keys dispatch to the windowed tier; spread keys do not
    clustered = np.arange(16, dtype=np.uint32).reshape(2, 8)
    clustered = (clustered + np.array([[64], [256]], np.uint32)).reshape(-1)
    assert scan_ops.windowed_cost(clustered) < 12 * clustered.shape[0]
    spread = (np.arange(8, dtype=np.uint32) * 61 + 5) % 512
    assert scan_ops.windowed_cost(spread) >= 12 * spread.shape[0]
    # and the dispatch path result matches the oracle either way
    width, n = 9, 20_000
    vals = _rand_column(width, n, seed=4)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    for keys in (clustered, spread):
        bits, counts = scan_ops.shared_scan_device(dev, keys)
        obits, ocounts = oracle.shared_scan(col, keys)
        np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
        np.testing.assert_array_equal(np.asarray(bits), np.asarray(obits))


@pytest.mark.parametrize("k", [49, 96, 130, 300])
def test_windowed_chunked_parity(k):
    # k > 48 clustered keys through the windowed tier (the cost model
    # prices them per 32-row chunk); oracle parity up to k=300
    width, n = 9, 40_000
    vals = _rand_column(width, n, seed=k)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    rng = np.random.default_rng(k)
    # clusters of 8 consecutive keys at random bases (sorted caller order)
    bases = rng.choice(np.arange(0, 504, 8), size=(k + 7) // 8, replace=False)
    keys = np.sort(
        (bases[:, None] + np.arange(8, dtype=np.uint32)).reshape(-1)[:k]
    ).astype(np.uint32)
    bits, counts = scan_ops.windowed_scan_tiles(
        dev.tiles, keys, width, n
    )
    assert bits.shape[0] == k and counts.shape[0] == k
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(
        np.asarray(scan_ops.bits_to_canonical(bits, n)), np.asarray(obits)
    )


def test_windowed_chunked_dispatch_large_k():
    # clustered concrete keys at k > 48 dispatch via the windowed tier
    # (cost rule) and match the oracle end-to-end; a spread set of the
    # same size does not satisfy the cost rule
    width, n, k = 9, 20_000, 64
    clustered = (
        np.arange(k, dtype=np.uint32).reshape(2, 32)
        + np.array([[0], [256]], np.uint32)
    ).reshape(-1) % 512
    assert scan_ops.windowed_cost(clustered) < 12 * k
    spread = (np.arange(k, dtype=np.uint32) * 61 + 5) % 512
    assert scan_ops.windowed_cost(spread) >= 12 * k
    vals = _rand_column(width, n, seed=11)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    for keys in (clustered, spread):
        bits, counts = scan_ops.shared_scan_device(dev, keys)
        obits, ocounts = oracle.shared_scan(col, keys)
        np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
        np.testing.assert_array_equal(np.asarray(bits), np.asarray(obits))


def test_windowed_rejects_traced_keys():
    width, n = 9, 2_048
    vals = _rand_column(width, n, seed=5)
    dev = layout.to_device(layout.pack(vals, width))
    import jax

    def f(keys):
        return scan_ops.windowed_scan_tiles(dev.tiles, keys, width, n)

    with pytest.raises(TypeError, match="concrete"):
        jax.make_jaxpr(f)(jnp.arange(4, dtype=jnp.uint32))


@pytest.mark.parametrize("k", [8, 6, 12])
def test_shared_scan_linear_parity_k(k):
    # k % 4 == 0 exercises the SWAPMOVE byte-transpose-quad interleave
    # fast path; k=6 the byte-expansion fallback (oracle:
    # simd_scan_shared_linear.cpp:57 byte order)
    width, n = 9, 10_000
    vals = _rand_column(width, n, seed=70 + k)
    keys = ((np.arange(k, dtype=np.uint32) * 5 + 2) % (1 << width)).astype(
        np.uint32
    )
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    lin = scan_ops.shared_scan_linear_device(dev, keys)
    olin = oracle.shared_scan_linear(col, keys)
    np.testing.assert_array_equal(np.asarray(lin), np.asarray(olin))


def _linear_oracle(vals, keys, n):
    nbytes = (n + 7) // 8
    eb = np.zeros((len(keys), nbytes * 8), np.uint8)
    for j, key in enumerate(keys):
        eb[j, :n] = vals == key
    return np.packbits(
        eb.reshape(len(keys), nbytes, 8), axis=-1, bitorder="little"
    ).reshape(len(keys), nbytes).T.reshape(-1)


@pytest.mark.parametrize(
    "k,w", [(1, 5), (3, 300), (4, 257), (6, 300), (8, 1024), (12, 77),
            (20, 300), (8, 9_000)]
)
def test_interleave_linear_matches_byte_oracle(k, w):
    # the plain byte transpose against numpy on ragged byte counts
    rng = np.random.default_rng(13 + k)
    bits = rng.integers(0, 2**32, size=(k, w), dtype=np.uint32)
    nbytes = w * 4 - 3
    got = np.asarray(scan_ops.interleave_linear(jnp.asarray(bits), nbytes))
    exp = bits.view(np.uint8).reshape(k, -1)[:, :nbytes].T.reshape(-1)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("kind", ["consecutive", "spread", "traced"])
@pytest.mark.parametrize("k", [4, 8, 12, 16, 20, 24, 32, 64])
def test_linear_export_parity(k, kind):
    # linear export = the shared scan's dispatch + the byte interleave,
    # as uint32 words, for concrete consecutive / spread and traced keys
    import jax

    rng = np.random.default_rng(57 + k)
    width = 9 if k % 8 else 11
    n = int(rng.integers(5_000, 12_000))
    vals = rng.integers(0, 1 << width, n, dtype=np.uint32)
    dev = layout.to_device(layout.pack(vals, width))
    if kind == "consecutive":
        keys = np.arange(40, 40 + k, dtype=np.uint32)
    else:
        keys = np.unique(rng.integers(0, 1 << width, 4 * k, dtype=np.uint32))[:k]
    if kind == "traced":
        words = jax.jit(
            lambda kv: scan_ops.shared_scan_linear_words_device(dev, kv)
        )(jnp.asarray(keys))
    else:
        words = scan_ops.shared_scan_linear_words_device(dev, keys)
    nbytes = (n + 7) // 8
    np.testing.assert_array_equal(
        np.asarray(words).view(np.uint8)[: nbytes * k],
        _linear_oracle(vals, keys, n),
    )


def test_linear_words_needs_k_multiple_of_4():
    dev = layout.pack_device(_rand_column(9, 1000, seed=1), 9)
    with pytest.raises(ValueError, match="k % 4"):
        scan_ops.shared_scan_linear_words_device(dev, np.arange(6))


def test_linear_words_dispatch_no_tracer_demotion(monkeypatch):
    # concrete numpy keys closed over inside a jit must stay on the
    # CONCRETE tiers (the jnp.asarray-before-Tracer-check demotion bug
    # class): forcing the traced tier to raise proves the route
    import jax

    def _boom(*a, **k):
        raise AssertionError("concrete keys demoted to the traced tier")

    monkeypatch.setattr(scan_ops, "shared_scan_bitsliced_tiles", _boom)
    rng = np.random.default_rng(51)
    n = 9_000
    vals = rng.integers(0, 512, n, dtype=np.uint32)
    dev = layout.to_device(layout.pack(vals, 9))
    keys = np.array([9, 300, 44, 501, 2, 60, 120, 7], np.uint32)  # spread
    out = jax.jit(
        lambda t: scan_ops.shared_scan_linear_words_device(
            layout.DeviceColumn(width=9, n=n, tiles=t), keys
        )
    )(dev.tiles)
    assert out.shape[0] == ((n + 7) // 8) * 8 // 4
    np.testing.assert_array_equal(
        np.asarray(out).view(np.uint8), _linear_oracle(vals, keys, n)
    )


def test_static_group_sizes_branch_cap():
    # the static tier's cost model prices key groups of <= 8 chunks of
    # _static_krows rows; groups past the first must be exact (no zero
    # rows except possibly in the final group)
    for k in range(1, 2049):
        sizes = scan_ops._static_group_sizes(k)
        assert sum(sizes) == k
        for g in sizes:
            krows = scan_ops._static_krows(g)
            assert -(-g // krows) <= 8, (k, g)
        for g in sizes[:-1]:
            krows = scan_ops._static_krows(g)
            assert g % krows == 0, (k, g)  # only the tail may pad
