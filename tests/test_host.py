"""Native host library (csrc/sss_host.cpp) conformance tests.

Three independent implementations must agree byte-for-byte: the C++ host
library, the jnp oracle, and numpy (packbits).  Mirrors the reference's
oracle pattern (SURVEY.md §4) with the host lib in the scalar-oracle role.
"""
import numpy as np
import pytest

from shared_simd_scan_tpu import bitvector, layout
from shared_simd_scan_tpu.ops import oracle

host = pytest.importorskip("shared_simd_scan_tpu.host")

if not host.available():
    pytest.skip("native host library unavailable", allow_module_level=True)

WIDTHS = [1, 3, 8, 9, 15, 17, 31]


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_unpack_roundtrip(width):
    rng = np.random.default_rng(width)
    n = 10_007
    vals = rng.integers(0, 1 << width, n, dtype=np.uint32)
    data = host.pack_bytes(vals, width)
    assert len(data) == (n * width + 7) // 8
    np.testing.assert_array_equal(host.unpack_bytes(data, n, width), vals)


@pytest.mark.parametrize("width", [9, 17])
def test_pack_matches_jnp_layout(width):
    rng = np.random.default_rng(width + 100)
    n = 5_003
    vals = rng.integers(0, 1 << width, n, dtype=np.uint32)
    assert host.pack_bytes(vals, width) == layout.pack(vals, width).to_bytes()


def test_scan_parity_vs_numpy_and_oracle():
    width, n = 9, 20_011
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 1 << width, n, dtype=np.uint32)
    data = host.pack_bytes(vals, width)
    key = int(vals[3])
    bits, hits = host.scan_bytes(data, n, width, key)
    assert hits == int((vals == key).sum())
    assert bits == np.packbits(vals == key, bitorder="little").tobytes()
    obits, ohits = oracle.scan(layout.pack(vals, width), key)
    assert int(ohits) == hits
    assert bitvector.to_bytes(obits, n) == bits


def test_shared_scan_parity_and_k_over_64():
    width, n = 9, 8_009
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 1 << width, n, dtype=np.uint32)
    data = host.pack_bytes(vals, width)
    k = 70  # exercises the multi-pass k>64 path
    keys = np.arange(k, dtype=np.uint32)
    bl, cl = host.shared_scan_bytes(data, n, width, keys)
    for j in range(k):
        assert cl[j] == int((vals == keys[j]).sum())
        assert bl[j] == np.packbits(vals == keys[j], bitorder="little").tobytes()


def test_pack_column_into_device_pipeline():
    width, n = 9, 4_001
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 1 << width, n, dtype=np.uint32)
    col = host.pack_column(vals, width)
    np.testing.assert_array_equal(np.asarray(oracle.unpack(col)), vals)


def test_interleave_bytes_matches_numpy():
    if not host.available():
        pytest.skip("host lib unavailable")
    rng = np.random.default_rng(11)
    # k=8 AVX2 16B-store path, k=16 8B-store path, k=5 scalar path,
    # k%4 quad path (k=4/12/20), ragged nbytes (sub-32-group
    # tails) on each
    for k, stride, nbytes in (
        (8, 9000, 9000), (8, 100, 97), (16, 5000, 4999), (5, 300, 300),
        (8, 40, 3), (24, 70, 65), (4, 777, 775), (12, 3000, 2990),
        (20, 500, 500), (28, 95, 64),
    ):
        rows = rng.integers(0, 256, size=(k, stride), dtype=np.uint8)
        got = host.interleave_bytes(rows, nbytes)
        exp = rows[:, :nbytes].T.reshape(-1)
        np.testing.assert_array_equal(got, exp)


def test_interleave_bytes_linear_parity_vs_oracle():
    if not host.available():
        pytest.skip("host lib unavailable")
    # end-to-end: host shared scan -> interleave == oracle linear layout
    from shared_simd_scan_tpu.ops import oracle

    width, n, k = 9, 10_000, 8
    rng = np.random.default_rng(12)
    vals = rng.integers(0, 1 << width, n, dtype=np.uint32)
    keys = rng.permutation(1 << width)[:k].astype(np.uint32)
    col = layout.pack(vals, width)
    payload, counts = host.shared_scan_bytes(col.to_bytes(), n, width, keys)
    rows = np.stack([np.frombuffer(b, np.uint8) for b in payload])
    got = host.interleave_bytes(rows, (n + 7) // 8)
    exp = np.asarray(oracle.shared_scan_linear(col, keys))
    np.testing.assert_array_equal(got, exp)
