"""Drive the scan engine's main path once on the GPU at full scale.

    python chip_smoke.py [--seed S] [--n N] [--four-cards]

Generates from ``--seed`` a 9-bit predicate column of 477,218,588 values
(512 MiB packed, the reference benchmark's default scale), a 16-bit measure
column, two more predicate columns of widths 7 and 12 and a clustered
9-bit column; packs them on the device and runs one phase per family
through the public entry points, each compared bit-exact with numpy; the
last phase runs every Triton tier at its key cap on the 7- and 12-bit
columns against the XLA driver and numpy's counts.
Every phase prints its compile time, its wall time after
``block_until_ready`` and ``compiled.memory_analysis()``.  The last line
is one JSON object naming the device; any failing phase exits non-zero.

``--four-cards`` runs only the sharded path (parallel.dist on a 1-D mesh
of 4 devices) against numpy and against the 1-card result.

Needs a GPU: on any other platform it exits non-zero before doing work.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax

N_DEFAULT = 477_218_588
SPREAD8 = [3, 70, 141, 212, 283, 354, 425, 496]
FAILED: list[str] = []


def _card_line() -> str:
    """Name and power limit, read by a child that does not import JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: n/a"
    return (
        f"memory_analysis: args={m.argument_size_in_bytes} "
        f"out={m.output_size_in_bytes} temp={m.temp_size_in_bytes}"
    )


def phase(name, fn, args, check):
    """Compile ``fn`` for ``args``, run it once, check the result."""
    try:
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        t1 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        t2 = time.perf_counter()
        print(f"[{name}] compile {t1 - t0:.2f} s, run {1e3 * (t2 - t1):.2f} ms, "
              f"{_mem(compiled)}", flush=True)
        check(jax.device_get(out))
        print(f"[{name}] ok", flush=True)
        return out
    except Exception as e:  # noqa: BLE001 — every phase reports, then exit 1
        FAILED.append(name)
        print(f"[{name}] FAILED: {type(e).__name__}: {e}", flush=True)
        return None


def _require(ok, msg):
    if not ok:
        raise AssertionError(msg)


def _bits_ref(np, v, key):
    return np.packbits(v == key, bitorder="little")


def _check_bits(np, words, ref_bytes, what):
    got = np.asarray(words).view(np.uint8)[: ref_bytes.shape[0]]
    if not np.array_equal(got, ref_bytes):
        raise AssertionError(f"{what}: bitvector differs from numpy")


def _check_scan(np, v, keys, out, what):
    bits, counts = out
    for j, key in enumerate(keys):
        ref = _bits_ref(np, v, key)
        _check_bits(np, bits[j], ref, f"{what} key {key}")
        want = int(np.count_nonzero(v == key))
        if int(counts[j]) != want:
            raise AssertionError(f"{what} key {key}: count {int(counts[j])} != {want}")


def single_card(args, np, sss):
    from shared_simd_scan_tpu import layout, query as q, zonemap
    from shared_simd_scan_tpu.ops import aggregate as agg, scan, unpack
    from shared_simd_scan_tpu.ops.member import member_scan_device

    n = args.n
    rng = np.random.default_rng(args.seed)
    v9 = rng.integers(0, 1 << 9, n, dtype=np.uint32)
    v7 = rng.integers(0, 1 << 7, n, dtype=np.uint32)
    v12 = rng.integers(0, 1 << 12, n, dtype=np.uint32)
    m16 = rng.integers(0, 1 << 16, n, dtype=np.uint32)
    vc = ((np.arange(n, dtype=np.uint64) * 512) // n).astype(np.uint32)

    def packed(v, w):
        return unpack.pack_device_kernel(jax.device_put(v), w)

    # 0. shift semantics the interval/windowed bodies rely on
    amounts = jax.device_put(np.array([32, 33, 64, 1 << 20, (1 << 32) - 1], np.uint32))
    phase("0 shift >= 32 gives 0", lambda a: jax.numpy.uint32(1) << a, (amounts,),
          lambda out: _require(not np.asarray(out).any(), f"oversized shift gave {out}"))

    # 1. pack -> unpack round trip
    vals = jax.device_put(v9)
    t = phase("1 pack", lambda x: unpack.pack_device_kernel(x, 9).tiles, (vals,),
              lambda out: None)
    c9 = layout.DeviceColumn(9, n, t)
    phase("1 unpack", lambda tl: unpack.unpack_device(layout.DeviceColumn(9, n, tl)),
          (t,), lambda out: _require(np.array_equal(out, v9), "unpack(pack(v)) != v"))
    del vals
    c7, c12, m = packed(v7, 7), packed(v12, 12), packed(m16, 16)
    cc = packed(vc, 9)

    def col(tl, w=9):
        return layout.DeviceColumn(w, n, tl)

    # 2. shared scans: consecutive, spread, traced keys
    cons = list(range(100, 108))
    phase("2 shared consecutive k=8",
          lambda tl: scan.shared_scan_device(col(tl), np.asarray(cons, np.uint32)),
          (c9.tiles,), lambda out: _check_scan(np, v9, cons, out, "consecutive"))
    phase("2 shared spread k=8",
          lambda tl: scan.shared_scan_device(col(tl), np.asarray(SPREAD8, np.uint32)),
          (c9.tiles,), lambda out: _check_scan(np, v9, SPREAD8, out, "spread"))
    traced = [7, 77, 177, 277, 377, 477, 1, 511]
    phase("2 shared traced k=8",
          lambda tl, k: scan.shared_scan_device(col(tl), k),
          (c9.tiles, jax.device_put(np.asarray(traced, np.uint32))),
          lambda out: _check_scan(np, v9, traced, out, "traced"))

    # 3. single-predicate scan
    phase("3 scan", lambda tl: scan.scan_device(col(tl), 5), (c9.tiles,),
          lambda out: _check_scan(np, v9, [5], ([out[0]], [out[1]]), "scan"))

    # 4. IN-list with 100 spread keys
    keys100 = np.unique(rng.integers(0, 512, 300).astype(np.uint32))[:100]

    def check_member(out):
        ref = np.isin(v9, keys100)
        _check_bits(np, out[0], np.packbits(ref, bitorder="little"), "member")
        if int(out[1]) != int(ref.sum()):
            raise AssertionError(f"member count {int(out[1])} != {int(ref.sum())}")

    phase("4 member k=100", lambda tl: member_scan_device(col(tl), keys100),
          (c9.tiles,), check_member)

    # 5. 3-column WHERE, then a masked aggregate over its bitvector
    in12 = [5, 900, 1700, 2500, 3300, 4000]

    def expr(t9, t7, t12):
        a, b, c = col(t9), col(t7, 7), col(t12, 12)
        return q.And(q.Range(a, 50, 400), q.Range(b, 10, 100),
                     q.Or(q.In(c, in12), q.Not(q.Eq(a, 200))))

    ref5 = ((v9 >= 50) & (v9 < 400) & (v7 >= 10) & (v7 < 100)
            & (np.isin(v12, in12) | (v9 != 200)))

    def check_where(out):
        _check_bits(np, out[0], np.packbits(ref5, bitorder="little"), "where")
        if int(out[1]) != int(ref5.sum()):
            raise AssertionError(f"where count {int(out[1])} != {int(ref5.sum())}")

    where = phase("5 query.evaluate", lambda a, b, c: q.evaluate(expr(a, b, c)),
                  (c9.tiles, c7.tiles, c12.tiles), check_where)
    if where is not None:
        row = agg.bits_from_canonical(where[0], m.tiles.shape[1])

        def check_masked(out):
            total = int(agg.finalize_sums(out[1], out[2])[0])
            want = int(m16[ref5].astype(np.uint64).sum())
            if total != want or int(out[0]) != int(ref5.sum()):
                raise AssertionError(f"masked sum {total} != {want}")

        phase("5 masked_aggregate", lambda mt, r: agg.masked_aggregate_tiles(mt, r, 16),
              (m.tiles, row), check_masked)

    # 6. GROUP-BY aggregate k=8 and MIN/MAX
    gkeys = np.asarray(SPREAD8, np.uint32)

    def check_agg(out):
        sums = agg.finalize_sums(out[1], out[2])
        for j, key in enumerate(gkeys):
            sel = v9 == key
            if int(sums[j]) != int(m16[sel].astype(np.uint64).sum()) or int(
                out[0][j]
            ) != int(sel.sum()):
                raise AssertionError(f"aggregate key {key} differs")

    def agg_call(pt, mt):
        tier = agg.pick_aggregate_tier(9, 16, gkeys)
        if tier == "bitplane":
            return agg.aggregate_bitplane_static_tiles(pt, mt, gkeys, 9, 16, n)
        return agg.aggregate_scan_tiles(pt, mt, gkeys, 9, 16, n)

    phase("6 aggregate k=8", agg_call, (c9.tiles, m.tiles), check_agg)

    def check_minmax(out):
        mn, mx = agg.finalize_minmax(out[1], out[2], out[0], 16)
        for j, key in enumerate(gkeys):
            sel = m16[v9 == key]
            if int(mn[j]) != int(sel.min()) or int(mx[j]) != int(sel.max()):
                raise AssertionError(f"minmax key {key} differs")

    phase("6 minmax k=8",
          lambda pt, mt: agg.minmax_scan_tiles(pt, mt, gkeys, 9, 16, n),
          (c9.tiles, m.tiles), check_minmax)

    # 7. full-domain histogram: the program stats.histogram_full runs for
    # a 9-bit column (one 512-key window)
    hist_ref = np.bincount(v9, minlength=512)
    phase("7 histogram", lambda tl: scan.histogram_device(col(tl)), (c9.tiles,),
          lambda out: _require(np.array_equal(out, hist_ref), "histogram differs"))

    # 8. linear export at k=8
    def check_linear(out):
        ref = np.stack([_bits_ref(np, v9, k) for k in cons]).T.reshape(-1)
        if not np.array_equal(np.asarray(out), ref):
            raise AssertionError("linear export differs from numpy packbits")

    phase("8 linear k=8",
          lambda tl: scan.shared_scan_linear_device(col(tl), np.asarray(cons, np.uint32)),
          (c9.tiles,), check_linear)

    # 9. zone-map-pruned range on a clustered column
    b1 = cc.tiles.shape[1]
    zm = zonemap.build_zonemap_from_values(vc, b1, zone_b1=64 if b1 % 64 == 0 else 8)
    lo, hi = 100, 104
    refz = (vc >= lo) & (vc < hi)
    for name, fn in (("pruned", zonemap.pruned_range_scan),
                     ("zoned", zonemap.zoned_range_scan)):
        try:
            t0 = time.perf_counter()
            bits, cnt = jax.block_until_ready(fn(cc, zm, lo, hi))
            print(f"[9 {name} range] {1e3 * (time.perf_counter() - t0):.2f} ms "
                  f"(first call, compile included)", flush=True)
            _check_bits(np, jax.device_get(bits), np.packbits(refz, bitorder="little"),
                        name)
            if int(cnt) != int(refz.sum()):
                raise AssertionError(f"{name} count {int(cnt)} != {int(refz.sum())}")
            print(f"[9 {name} range] ok", flush=True)
        except Exception as e:  # noqa: BLE001
            FAILED.append(f"9 {name}")
            print(f"[9 {name} range] FAILED: {e}", flush=True)

    # 10. the Triton driver at the other widths: each Triton tier at its
    # dispatch cap on the 7- and 12-bit columns; bits equal to the XLA
    # driver's (compared on the device), counts equal to numpy's
    for w, v, c in ((7, v7, c7), (12, v12, c12)):
        hist = np.bincount(v, minlength=1 << w)
        for tier, cap in sorted(scan.TRITON_TIERS.items()):
            if tier == "interval":
                keys = np.arange(3, 3 + cap, dtype=np.uint32)
            else:
                keys = ((np.arange(cap) * 61 + 3) % (1 << w)).astype(np.uint32)

            def both(tl, tier=tier, keys=keys, w=w):
                (tb, tc), (xb, xc) = (_tier_call(scan, tier, tl, keys, w, n, be)
                                      for be in ("triton", "xla"))
                return jax.numpy.array_equal(tb, xb), tc, xc

            def check(out, keys=keys, hist=hist):
                _require(bool(out[0]), "Triton bits differ from the XLA driver's")
                want = hist[keys]
                _require(np.array_equal(out[1], want) and np.array_equal(out[2], want),
                         "counts differ from numpy")

            phase(f"10 triton {tier} k={cap} w={w}", both, (c.tiles,), check)


def _tier_call(scan, tier, tiles, keys, width, n, backend):
    """One Triton-capable tier on the given driver -> (bits, counts)."""
    if tier == "interval":
        return scan.interval_scan_tiles(tiles, int(keys[0]), len(keys), width, n,
                                        backend=backend)
    if tier == "bitsliced_static":
        return scan.shared_scan_bitsliced_static_tiles(tiles, keys, width, n,
                                                       backend=backend)
    fn = scan.shared_scan_bitsliced_tiles if tier == "bitsliced" else scan.shared_scan_tiles
    return fn(tiles, jax.numpy.asarray(keys), width, n, backend=backend)


def four_cards(args, np, sss):
    from shared_simd_scan_tpu import layout, query as q
    from shared_simd_scan_tpu.ops import aggregate as agg, scan, unpack
    from shared_simd_scan_tpu.ops.member import member_scan_device
    from shared_simd_scan_tpu.parallel import dist

    devices = jax.devices()
    if len(devices) != 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {len(devices)}")
    mesh = dist.make_mesh(devices)
    n = args.n
    rng = np.random.default_rng(args.seed)
    v9 = rng.integers(0, 1 << 9, n, dtype=np.uint32)
    m16 = rng.integers(0, 1 << 16, n, dtype=np.uint32)
    d0 = devices[0]
    c9 = unpack.pack_device_kernel(jax.device_put(v9, d0), 9)
    m = unpack.pack_device_kernel(jax.device_put(m16, d0), 16)
    s9, sm = dist.shard_column(c9, mesh), dist.shard_column(m, mesh)
    shard_devs = {s.device for s in s9.tiles.addressable_shards}
    print(f"[shards] column on {len(shard_devs)} distinct devices", flush=True)
    if len(shard_devs) != 4:
        FAILED.append("shards")

    def step(name, sharded, single, check):
        try:
            t0 = time.perf_counter()
            out = jax.block_until_ready(sharded())
            print(f"[{name}] sharded first call {1e3 * (time.perf_counter() - t0):.2f} ms "
                  "(compile included)", flush=True)
            out = jax.device_get(out)
            check(out)
            one = jax.device_get(jax.block_until_ready(single()))
            for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(one)):
                if not np.array_equal(np.asarray(a), np.asarray(b)):
                    raise AssertionError(f"{name}: 4 cards differ from 1 card")
            print(f"[{name}] ok (numpy and 1 card)", flush=True)
        except Exception as e:  # noqa: BLE001
            FAILED.append(name)
            print(f"[{name}] FAILED: {type(e).__name__}: {e}", flush=True)

    cons = np.arange(100, 108, dtype=np.uint32)
    spread = np.asarray(SPREAD8, np.uint32)
    for name, keys in (("interval", cons), ("spread", spread)):
        step(f"sharded_shared_scan {name}",
             lambda keys=keys: (lambda r: (scan.bits_to_canonical(r[0], n), r[1]))(
                 dist.sharded_shared_scan(s9, keys, mesh)),
             lambda keys=keys: scan.shared_scan_device(c9, keys),
             lambda out, keys=keys: _check_scan(np, v9, keys, out, name))
    keys100 = np.unique(rng.integers(0, 512, 300).astype(np.uint32))[:100]
    ref_m = np.isin(v9, keys100)

    def check_member(out):
        _check_bits(np, out[0], np.packbits(ref_m, bitorder="little"), "member")
        assert int(out[1]) == int(ref_m.sum()), "member count"

    step("sharded_member_scan",
         lambda: (lambda r: (scan.bits_to_canonical(r[0], n), r[1]))(
             dist.sharded_member_scan(s9, keys100, mesh)),
         lambda: member_scan_device(c9, keys100), check_member)
    ref5 = (v9 >= 50) & (v9 < 400) & (np.isin(v9, [60, 61, 300]) | (v9 != 200))

    def where(col):
        return q.And(q.Range(col, 50, 400),
                     q.Or(q.In(col, [60, 61, 300]), q.Not(q.Eq(col, 200))))

    def sharded_where():
        bits, cnt = q.evaluate_sharded(where(s9), mesh)
        s, c = dist.sharded_masked_aggregate(sm, bits, mesh)
        return scan.bits_to_canonical(bits, n), cnt, np.uint64(s), c

    def single_where():
        bits, cnt = q.evaluate(where(c9))
        s, c = agg.masked_aggregate_device(m, bits)
        return bits, cnt, np.uint64(s), c

    def check_where(out):
        _check_bits(np, out[0], np.packbits(ref5, bitorder="little"), "where")
        assert int(out[1]) == int(ref5.sum()) == int(out[3]), "where count"
        assert int(out[2]) == int(m16[ref5].astype(np.uint64).sum()), "where sum"

    step("evaluate_sharded + sharded_masked_aggregate", sharded_where, single_where,
         check_where)

    def check_agg(out):
        sums, counts = out
        for j, key in enumerate(spread):
            sel = v9 == key
            assert int(sums[j]) == int(m16[sel].astype(np.uint64).sum()), "agg sum"
            assert int(counts[j]) == int(sel.sum()), "agg count"

    step("sharded_aggregate_scan",
         lambda: dist.sharded_aggregate_scan(s9, sm, spread, mesh),
         lambda: agg.aggregate_scan_device(c9, m, spread), check_agg)

    def check_linear(out):
        ref = np.stack([_bits_ref(np, v9, k) for k in cons]).T.reshape(-1)
        got = np.asarray(out[0]).view(np.uint8)
        assert np.array_equal(got, ref), "linear export differs from numpy"

    step("sharded linear k=8",
         lambda: dist.sharded_linear_scan(s9, 100, 8, mesh),
         lambda: (scan.shared_scan_linear_words_device(c9, cons),
                  scan.shared_scan_device(c9, cons)[1]),
         check_linear)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=N_DEFAULT)
    ap.add_argument("--four-cards", action="store_true")
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 2
    import numpy as np

    import shared_simd_scan_tpu as sss
    from shared_simd_scan_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    print(_card_line(), flush=True)
    t0 = time.perf_counter()
    (four_cards if args.four_cards else single_card)(args, np, sss)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if FAILED:
        print(f"FAILED phases: {FAILED}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
