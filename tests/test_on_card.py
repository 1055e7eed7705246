"""Checks that need the card: the Triton driver compiled for the GPU
against the XLA driver.  Marked ``gpu``; the ``gpu`` fixture skips them
where JAX has no GPU (``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``
on a GPU host)."""
import numpy as np
import pytest

from shared_simd_scan_tpu import layout
from shared_simd_scan_tpu.ops import scan as scan_ops


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 8, 9, 17, 31])
@pytest.mark.parametrize("tier", sorted(scan_ops.TRITON_TIERS))
def test_triton_driver_matches_xla_on_card(gpu, tier, width):
    # every Triton tier at its dispatch cap (the largest program the
    # default path compiles) across the width range
    n = 3_000_017
    k = scan_ops.TRITON_TIERS[tier]
    vals = np.random.default_rng(width).integers(0, 1 << width, n, dtype=np.uint32)
    tiles = layout.pack_device(vals, width).tiles
    keys = ((np.arange(k, dtype=np.uint64) * 61 + vals[0]) % (1 << width)).astype(np.uint32)

    def run(backend):
        if tier == "interval":
            return scan_ops.interval_scan_tiles(
                tiles, int(vals[0]), k, width, n, backend=backend)
        if tier == "bitsliced_static":
            return scan_ops.shared_scan_bitsliced_static_tiles(
                tiles, keys, width, n, backend=backend)
        fn = (scan_ops.shared_scan_bitsliced_tiles if tier == "bitsliced"
              else scan_ops.shared_scan_tiles)
        return fn(tiles, keys, width, n, backend=backend)

    (tb, tc), (xb, xc) = run("triton"), run("xla")
    np.testing.assert_array_equal(np.asarray(tb), np.asarray(xb))
    np.testing.assert_array_equal(np.asarray(tc), np.asarray(xc))
    assert int(np.asarray(tc).sum()) > 0
