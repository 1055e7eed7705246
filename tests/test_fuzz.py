"""Randomized cross-implementation fuzz: jnp oracle vs XLA tier vs host C++
on random (width, n, k) configurations including awkward tails."""
import numpy as np
import pytest

from shared_simd_scan_tpu import bitvector, layout
from shared_simd_scan_tpu.ops import oracle, scan as scan_ops

try:
    from shared_simd_scan_tpu import host
    HOST = host.available()
except Exception:
    HOST = False

CASES = [
    # (width, n, k, seed)
    (1, 1, 1, 0),
    (2, 31, 3, 1),
    (6, 4097, 5, 2),
    (9, 32 * 128 * 8 + 1, 7, 3),   # one value past a full lane tile
    (13, 12_345, 11, 4),
    (21, 999, 2, 5),
    (30, 2048, 4, 6),
    (31, 777, 3, 7),
]


@pytest.mark.parametrize("width,n,k,seed", CASES)
def test_three_way_agreement(width, n, k, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    keys = rng.integers(0, 1 << width, size=k, dtype=np.uint32)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)

    obits, ocounts = oracle.shared_scan(col, keys)
    xbits, xcounts = scan_ops.shared_scan_tiles(
        dev.tiles, keys, width, n, backend="xla"
    )
    xbits = scan_ops.bits_to_canonical(xbits, n)
    np.testing.assert_array_equal(np.asarray(xbits), np.asarray(obits))
    np.testing.assert_array_equal(np.asarray(xcounts), np.asarray(ocounts))

    # numpy ground truth
    for j in range(k):
        expect = vals == keys[j]
        assert int(ocounts[j]) == int(expect.sum())
        assert bitvector.to_bytes(obits[j], n) == np.packbits(
            expect, bitorder="little"
        ).tobytes()

    if HOST:
        data = host.pack_bytes(vals, width)
        assert data == col.to_bytes()
        hbits, hcounts = host.shared_scan_bytes(data, n, width, keys)
        for j in range(k):
            assert hcounts[j] == int(ocounts[j])
            assert hbits[j] == bitvector.to_bytes(obits[j], n)
