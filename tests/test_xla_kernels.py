"""XLA-driver parity tests (natively compiled on CPU, no interpreter)."""
import numpy as np
import pytest

from shared_simd_scan_tpu import bitvector, layout
from shared_simd_scan_tpu.ops import oracle, scan as scan_ops, unpack as unpack_ops


def _xla_shared_scan(dev, keys):
    bits, counts = scan_ops.shared_scan_tiles(
        dev.tiles, np.asarray(keys, np.uint32), dev.width, dev.n, backend="xla"
    )
    return scan_ops.bits_to_canonical(bits, dev.n), counts


def _col(width, n, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    return vals, layout.pack(vals, width)


@pytest.mark.parametrize("width", [1, 4, 9, 13, 24, 31])
def test_unpack_xla_parity(width):
    vals, col = _col(width, 30_000, seed=width)
    dev = layout.to_device(col)
    np.testing.assert_array_equal(
        np.asarray(unpack_ops.unpack_device(dev)), vals
    )


@pytest.mark.parametrize("k", [1, 3, 8])
def test_shared_scan_xla_parity(k):
    width, n = 9, 25_000
    vals, col = _col(width, n, seed=k + 40)
    dev = layout.to_device(col)
    keys = np.arange(k, dtype=np.uint32)
    bits, counts = _xla_shared_scan(dev, keys)
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(obits))
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))


def test_shared_scan_xla_tail_masking():
    width, n = 9, 77
    vals, col = _col(width, n, seed=99)
    dev = layout.to_device(col)
    bits, counts = _xla_shared_scan(dev, np.array([0], np.uint32))
    assert int(counts[0]) == int((vals == 0).sum())
    assert bitvector.to_bytes(bits[0], n) == np.packbits(
        vals == 0, bitorder="little"
    ).tobytes()
