"""The Triton scan driver (interpreted on the CPU) at the widths around
the 9-bit headline column, against the oracle."""
import numpy as np
import pytest

from shared_simd_scan_tpu import layout
from shared_simd_scan_tpu.ops import oracle, scan as scan_ops


def _tier_call(tier, tiles, keys, width, n):
    if tier == "compare":
        return scan_ops.shared_scan_tiles(tiles, keys, width, n, backend="triton")
    if tier == "bitsliced":
        return scan_ops.shared_scan_bitsliced_tiles(tiles, keys, width, n,
                                                    backend="triton")
    if tier == "static":
        return scan_ops.shared_scan_bitsliced_static_tiles(tiles, keys, width, n,
                                                           backend="triton")
    return scan_ops.interval_scan_tiles(tiles, int(keys[0]), len(keys), width, n,
                                        backend="triton")


@pytest.mark.parametrize("width", [1, 8, 17, 31])
@pytest.mark.parametrize("tier", ["compare", "bitsliced", "static", "interval"])
def test_triton_driver_widths(tier, width):
    # the Triton driver at the widths around the 9-bit headline column,
    # each tier at a non-power-of-two key count
    n = 9_001
    vals = np.random.default_rng(70 + width).integers(0, 1 << width, n, dtype=np.uint32)
    col = layout.pack(vals, width)
    dev = layout.to_device(col)
    k = 3 if tier == "compare" else 12
    if tier == "interval":
        lo = max(0, min(int(vals[0]), (1 << width) - k))
        keys = np.arange(lo, lo + k, dtype=np.uint32)
    else:
        rng = np.random.default_rng(width)
        keys = rng.integers(0, 1 << width, k, dtype=np.uint64).astype(np.uint32)
        keys[0] = vals[0]  # at least one key that matches
    bits, counts = _tier_call(tier, dev.tiles, keys, width, n)
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(
        np.asarray(scan_ops.bits_to_canonical(bits, n)), np.asarray(obits)
    )
