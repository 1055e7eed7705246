"""Structural op-counting (utils/costmodel) sanity tests."""
import jax.numpy as jnp
import numpy as np

from shared_simd_scan_tpu import layout
from shared_simd_scan_tpu.ops import scan as scan_ops, unpack as unpack_ops
from shared_simd_scan_tpu.utils.costmodel import count_vector_ops


def _tiles(width):
    vals = np.arange(8 * 128 * 32, dtype=np.uint32) & ((1 << width) - 1)
    return layout.pack_device(jnp.asarray(vals), width).tiles


def test_unpack_counted_ops_match_schedule():
    # unpack w=9: 21 non-straddling values (shift+and) + 11 straddling
    # (shift+shl+or+and) = 86 ops/block = 2.6875/value
    t = _tiles(9)
    c = count_vector_ops(lambda x: unpack_ops.unpack_tiles(x, 9), t)
    sched = layout.unpack_schedule(9)
    expect = sum(4 if s else 2 for _, _, s in sched) / 32
    assert abs(c["per_value"] - expect) < 0.2, c
    assert c["n_kernels"] == 0  # plain XLA, no Pallas program


def test_interval_cheaper_than_general_at_k8():
    t = _tiles(9)
    n = t.shape[1] * 128 * 32
    keys = jnp.arange(8, dtype=jnp.uint32)
    # body costs under the XLA driver (the Triton driver adds the same
    # per-key count reduction to both)
    g = count_vector_ops(
        lambda x, kk: scan_ops.shared_scan_tiles(x, kk, 9, n, backend="xla"),
        t, keys)
    iv = count_vector_ops(
        lambda x: scan_ops.interval_scan_tiles(x, 0, 8, 9, n, backend="xla"), t)
    assert iv["per_value"] < 0.5 * g["per_value"], (iv, g)
    assert g["per_value"] > 20  # ~3 ops per (value, key) plus unpack


def test_bitsliced_cheaper_than_compare_past_crossover():
    # the dispatch rule (scan._bitsliced_wins, crossover k>=5 at w=9)
    # must agree with the counted costs it models
    t = _tiles(9)
    n = t.shape[1] * 128 * 32
    for k in (8, 32):
        keys = jnp.arange(k, dtype=jnp.uint32) * 7 % 512
        bs = count_vector_ops(
            lambda x, kk: scan_ops.shared_scan_bitsliced_tiles(x, kk, 9, n),
            t, keys)
        g = count_vector_ops(
            lambda x, kk: scan_ops.shared_scan_tiles(x, kk, 9, n), t, keys)
        assert bs["per_value"] < g["per_value"], (k, bs, g)
        assert scan_ops._bitsliced_wins(9, k)
    assert not scan_ops._bitsliced_wins(9, 2)


def test_static_dag_count_matches_dispatch_pricing():
    # the counted ops of the static AND-DAG tier track the dispatch's
    # own DAG pricing (scan.bitsliced_static_cost)
    t = _tiles(9)
    n = t.shape[1] * 128 * 32
    keys = (np.arange(8, dtype=np.uint32) * 61 + 5) % 512
    c = count_vector_ops(
        lambda x: scan_ops.shared_scan_bitsliced_static_tiles(
            x, keys, 9, n, backend="xla"), t)
    assert c["n_kernels"] == 0
    priced = scan_ops._static_dag_ops(9, keys.tolist())
    assert c["per_block"] > priced  # DAG + unpack + transpose + counts
    assert c["per_value"] < 20, c
