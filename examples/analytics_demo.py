"""End-to-end analytics walkthrough on a packed three-column table.

Runs on any backend (the CPU runs the Triton driver's programs
interpreted, a GPU compiles them):

    PYTHONPATH=. python examples/analytics_demo.py

Covers the full user surface: host-codec ingest, device upload, shared
scans, IN-list membership, fused multi-column WHERE clauses, the
predicate-tree query layer, masked aggregates, histogram statistics, and
bitvector persistence.
"""
import numpy as np

import shared_simd_scan_tpu as sss
from shared_simd_scan_tpu import bitvector, layout, query as q, stats
from shared_simd_scan_tpu.ops import aggregate as agg_ops
from shared_simd_scan_tpu.ops import scan as scan_ops


def main() -> int:
    rng = np.random.default_rng(7)
    n = 1_000_000

    # a tiny star-schema fact table: price (9-bit), region (5-bit),
    # status (4-bit), revenue measure (20-bit)
    price = rng.integers(0, 512, n, dtype=np.uint32)
    region = rng.integers(0, 32, n, dtype=np.uint32)
    status = rng.integers(0, 16, n, dtype=np.uint32)
    revenue = rng.integers(0, 1 << 20, n, dtype=np.uint32)

    cols = {
        "price": layout.to_device(sss.pack(price, 9)),
        "region": layout.to_device(sss.pack(region, 5)),
        "status": layout.to_device(sss.pack(status, 4)),
        "revenue": layout.to_device(sss.pack(revenue, 20)),
    }
    packed_mb = sum(
        layout.packed_nbytes(c.width, n) for c in cols.values()
    ) / 1e6
    print(f"table: {n} rows, 4 columns, {packed_mb:.1f} MB packed "
          f"(vs {16 * n / 1e6:.0f} MB raw uint32)")

    # 1. shared scan: SELECT COUNT(*) GROUP BY price-bucket for 8 buckets
    keys = np.arange(8, dtype=np.uint32)
    bits, counts = scan_ops.shared_scan_device(
        cols["price"], keys)
    print("shared scan counts (price in 0..7):",
          [int(c) for c in counts])

    # 2. fused WHERE clause over three columns, one pass
    expr = q.And(
        q.Range(cols["price"], 100, 400),
        q.Range(cols["region"], 2, 10),
        q.Or(q.In(cols["status"], [1, 4, 9]), q.Eq(cols["status"], 0)),
    )
    match_bits, match_count = q.evaluate(expr)
    expect = (
        (price >= 100) & (price < 400) & (region >= 2) & (region < 10)
        & (np.isin(status, [1, 4, 9]) | (status == 0))
    )
    assert int(match_count) == int(expect.sum())
    print(f"WHERE clause matches: {int(match_count)} rows "
          f"({100 * int(match_count) / n:.1f}%)")

    # 3. masked aggregate: SELECT SUM(revenue), COUNT(*) WHERE <expr>
    total, cnt = agg_ops.masked_aggregate_device(
        cols["revenue"], match_bits)
    assert int(total) == int(revenue[expect].astype(np.uint64).sum())
    print(f"SUM(revenue) over matches: {int(total)} (count {int(cnt)})")

    # 4. row materialization + persistence
    idx, _ = bitvector.match_indices(match_bits, n, size=16)
    print("first matching rows:", [int(i) for i in np.asarray(idx[:5])])

    # 5. column statistics from one histogram pass
    qs = stats.quantiles(cols["price"], [0.5, 0.99])
    top, topc = stats.topk_values(cols["price"], 3)
    print(f"price p50={int(qs[0])} p99={int(qs[1])}; "
          f"top-3 values {list(map(int, top))}")

    # 6. encodings: FOR for banded data, dictionary for sparse domains
    from shared_simd_scan_tpu import dictcol, forcol

    ts = rng.integers(1_700_000_000, 1_700_086_400, n).astype(np.uint64)
    fts = forcol.pack_for(ts)  # one day of timestamps -> 17 bits
    print(f"timestamps FOR-encoded at {fts.width} bits "
          f"(raw needs 31+); base={fts.base}")
    _, cnt = forcol.evaluate(
        q.Range(fts, 1_700_040_000, 1_700_050_000))
    assert int(cnt) == int(((ts >= 1_700_040_000) & (ts < 1_700_050_000)).sum())

    skus = (rng.integers(0, 150, n).astype(np.uint64) * 982_451_653) % (1 << 40)
    dsku = dictcol.pack_dict(skus)
    print(f"sparse 40-bit SKUs dictionary-encoded at {dsku.width} bits "
          f"({dsku.values.size} distinct)")

    # 7. zone maps: scan skipping on the (sorted) timestamp column —
    # a point-in-time predicate touches O(1) zones, not the whole column
    from shared_simd_scan_tpu import zonemap

    sorted_ts = forcol.pack_for(np.sort(ts))
    zmap = zonemap.build_zonemap(sorted_ts.dev, zone_b1=8)
    lo_c = 1_700_040_000 - sorted_ts.base
    span = zonemap.prune_span(zmap, lo_c, lo_c + 600)
    _, zcnt = zonemap.pruned_range_scan(
        sorted_ts.dev, zmap, lo_c, lo_c + 600)
    tss = np.sort(ts)
    assert int(zcnt) == int(
        ((tss >= 1_700_040_000) & (tss < 1_700_040_600)).sum()
    )
    print(f"zone map: 10-minute window scans {span[1]}/{zmap.b1} "
          f"block-rows ({zmap.nzones} zones)")

    # 8. the plan, statically
    print(q.explain(expr))

    print("demo OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
