"""Sharded (multi-chip) scan tests on the virtual 8-device CPU mesh.

The reference has no distributed layer (SURVEY.md §2.4); this validates the
new data-parallel component: block-axis sharding, replicated predicates,
psum'd counts — the standard substitute for several devices (§4).
"""
import jax
import numpy as np
import pytest

from shared_simd_scan_tpu import layout
from shared_simd_scan_tpu.ops import oracle
from shared_simd_scan_tpu.ops.scan import bits_to_canonical
from shared_simd_scan_tpu.ops.unpack import values_to_flat
from shared_simd_scan_tpu.parallel import dist


@pytest.fixture(scope="module")
def mesh():
    return dist.make_mesh()


def _col(width, n, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    return vals, layout.pack(vals, width)


def test_mesh_spans_all_devices(mesh):
    assert mesh.devices.size == len(jax.devices()) == 8


@pytest.mark.parametrize("n", [70_000, 8 * 8 * 128 * 32])
def test_sharded_shared_scan_parity(mesh, n):
    width, k = 9, 4
    vals, col = _col(width, n)
    sdev = dist.shard_column(layout.to_device(col), mesh)
    keys = np.arange(k, dtype=np.uint32)
    bits, counts = dist.sharded_shared_scan(sdev, keys, mesh)
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(
        np.asarray(bits_to_canonical(bits, n)), np.asarray(obits)
    )


def test_sharded_scan_single_predicate(mesh):
    width, n = 9, 50_000
    vals, col = _col(width, n, seed=3)
    sdev = dist.shard_column(layout.to_device(col), mesh)
    key = int(vals[11])
    bits, count = dist.sharded_scan(sdev, key, mesh)
    assert int(count) == int(np.sum(vals == key))


def test_sharded_unpack_parity(mesh):
    width, n = 17, 40_000
    vals, col = _col(width, n, seed=7)
    sdev = dist.shard_column(layout.to_device(col), mesh)
    out = dist.sharded_unpack(sdev, mesh)
    np.testing.assert_array_equal(np.asarray(values_to_flat(out, n)), vals)


def test_shard_column_sharding_layout(mesh):
    width, n = 9, 100_000
    _, col = _col(width, n, seed=1)
    sdev = dist.shard_column(layout.to_device(col), mesh)
    # block axis divisible by mesh * 8 rows; sharding spec as designed
    assert sdev.tiles.shape[1] % (8 * layout.SUBLANES) == 0
    spec = sdev.tiles.sharding.spec
    assert spec == jax.sharding.PartitionSpec(None, dist.DATA_AXIS, None)


def test_sharded_interval_scan_parity(mesh):
    width, n, k = 9, 60_000, 8
    vals, col = _col(width, n, seed=21)
    sdev = dist.shard_column(layout.to_device(col), mesh)
    lo = 100
    bits, counts = dist.sharded_interval_scan(sdev, lo, k, mesh)
    keys = np.arange(lo, lo + k, dtype=np.uint32)
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(
        np.asarray(bits_to_canonical(bits, n)), np.asarray(obits)
    )


def test_sharded_linear_scan_parity(mesh):
    # the linear export sharded along the block axis must produce the
    # exact single-device linear word stream (shard spans concatenate
    # contiguously) and psum'd counts
    from shared_simd_scan_tpu.ops import scan as scan_ops

    width, n, k = 9, 60_000 - 11, 8
    vals, col = _col(width, n, seed=27)
    dev = layout.to_device(col)
    sdev = dist.shard_column(dev, mesh)
    lo = 200
    words, counts = dist.sharded_linear_scan(sdev, lo, k, mesh)
    keys = np.arange(lo, lo + k, dtype=np.uint32)
    ew = scan_ops.shared_scan_linear_words_device(dev, keys)
    _, ec = scan_ops.shared_scan_device(dev, keys)
    np.testing.assert_array_equal(np.asarray(words), np.asarray(ew))
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ec))


def test_sharded_range_scan_parity(mesh):
    width, n = 9, 50_000
    vals, col = _col(width, n, seed=22)
    sdev = dist.shard_column(layout.to_device(col), mesh)
    lows = np.array([0, 100], np.uint32)
    highs = np.array([50, 400], np.uint32)
    bits, counts = dist.sharded_range_scan(sdev, lows, highs, mesh)
    for j in range(2):
        expect = (vals >= lows[j]) & (vals < highs[j])
        assert int(counts[j]) == int(expect.sum())


def test_sharded_histogram_parity(mesh):
    width, n = 9, 45_000
    vals, col = _col(width, n, seed=23)
    sdev = dist.shard_column(layout.to_device(col), mesh)
    counts = dist.sharded_histogram(sdev, mesh)
    expect = np.bincount(vals, minlength=512).astype(np.uint32)
    np.testing.assert_array_equal(np.asarray(counts), expect)
    sub = dist.sharded_histogram(sdev, mesh, lo=20, k=16)
    np.testing.assert_array_equal(np.asarray(sub), expect[20:36])


def test_sharded_large_k_parity():
    # k>32 through the sharded path must match the oracle (counts psum'd across the virtual mesh)
    width, n, k = 9, 70_000, 40
    rng = np.random.default_rng(21)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    col = layout.pack(vals, width)
    mesh = dist.make_mesh()
    sdev = dist.shard_column(layout.to_device(col), mesh)
    keys = (np.arange(k, dtype=np.uint32) * 13 + 2) % (1 << width)
    bits, counts = dist.sharded_shared_scan(sdev, keys, mesh)
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    got = np.asarray(bits_to_canonical(bits, n))
    np.testing.assert_array_equal(got, np.asarray(obits))


def test_sharded_windowed_clustered_parity():
    # clustered concrete keys (incl. k>48 -> chunked windowed) dispatch
    # through the sharded windowed path and match the oracle
    width, n = 9, 70_000
    rng = np.random.default_rng(33)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    col = layout.pack(vals, width)
    mesh = dist.make_mesh()
    sdev = dist.shard_column(layout.to_device(col), mesh)
    for k, bases in ((14, [10, 40, 100]), (56, [0, 64, 192, 256, 320, 448, 480])):
        keys = np.sort(np.concatenate(
            [b + np.arange(8, dtype=np.uint32) for b in np.asarray(bases, np.uint32)]
        ))[:k].astype(np.uint32)
        from shared_simd_scan_tpu.ops import scan as scan_ops
        assert scan_ops.windowed_cost(keys) < 12 * k
        assert scan_ops._consecutive_lo(keys) is None
        bits, counts = dist.sharded_shared_scan(sdev, keys, mesh)
        obits, ocounts = oracle.shared_scan(col, keys)
        np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
        np.testing.assert_array_equal(
            np.asarray(bits_to_canonical(bits, n)), np.asarray(obits)
        )


def test_sharded_dispatch_consecutive_uses_interval():
    # the sharded dispatcher must give consecutive concrete keys the same
    # result (via the interval kernel) as the oracle
    width, n, k = 9, 50_000, 8
    rng = np.random.default_rng(34)
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    col = layout.pack(vals, width)
    mesh = dist.make_mesh()
    sdev = dist.shard_column(layout.to_device(col), mesh)
    keys = np.arange(5, 5 + k, dtype=np.uint32)
    bits, counts = dist.sharded_shared_scan(sdev, keys, mesh)
    ibits, icounts = dist.sharded_interval_scan(sdev, 5, k, mesh)
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(ibits))
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(icounts))
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))


def test_multiprocess_collectives_demo():
    """The sharded surface across REAL process boundaries (Gloo).

    Spawns 2 OS processes, each with 1 CPU device, joined via
    jax.distributed.initialize (scripts/run_multiproc_demo.py, which
    forces its children onto the CPU).  Subprocesses get a clean env (no
    forced 8-device count)."""
    import os
    import pathlib
    import subprocess
    import sys

    script = (
        pathlib.Path(__file__).resolve().parent.parent
        / "scripts" / "run_multiproc_demo.py"
    )
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "PYTHONPATH", "JAX_PLATFORMS")
    }
    out = subprocess.run(
        [sys.executable, str(script), "--nproc=2", "--devs-per-proc=1"],
        env=env, capture_output=True, text=True, timeout=420,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "multiproc demo: OK" in out.stdout


def test_sharded_shared_scan_traced_parity(mesh):
    # traced keys through the sharded path: validity masks must be
    # offset per shard (ragged n lands mid-shard)
    width, k, n = 9, 4, 70_003
    vals, col = _col(width, n, seed=21)
    sdev = dist.shard_column(layout.to_device(col), mesh)
    keys = np.arange(k, dtype=np.uint32)
    bits, counts = dist._sharded_shared_scan_tiles(
        sdev.tiles, jax.numpy.asarray(keys), mesh=mesh, width=width, n=n
    )
    obits, ocounts = oracle.shared_scan(col, keys)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ocounts))
    np.testing.assert_array_equal(
        np.asarray(bits_to_canonical(bits, n)), np.asarray(obits)
    )
