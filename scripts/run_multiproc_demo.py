"""Multi-PROCESS collective demo: the sharded scan surface over real
cross-process Gloo collectives on CPU process groups.

The virtual 8-device mesh (tests/conftest.py) exercises the sharding
program in one process; this script runs the SAME library code across N
separate OS processes joined with ``jax.distributed.initialize`` (Gloo
collectives between CPU processes).  Each process owns
``--devs-per-proc`` virtual CPU devices, so the mesh spans processes AND
devices-within-process: counts psum across BOTH boundaries.  Children are
forced onto the CPU (``JAX_PLATFORMS=cpu``): on a GPU host every child
would otherwise open GPU 0.

Checks per process (mirrors __graft_entry__.dryrun_multichip):
  - interval shared scan counts vs numpy
  - spread-key static AND-DAG tier counts
  - IN-list member OR-tree count
  - composed query tree + sharded masked aggregate (count AND sum)

Usage:
  python scripts/run_multiproc_demo.py [--nproc=2] [--devs-per-proc=2]
(parent spawns the children; exit 0 = every process verified)
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

PORT = 19873


def child(proc_id: int, nproc: int, devs: int) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{PORT + nproc}",
        num_processes=nproc,
        process_id=proc_id,
    )
    import numpy as np
    from jax.sharding import Mesh

    from shared_simd_scan_tpu import layout
    from shared_simd_scan_tpu import query as q
    from shared_simd_scan_tpu.parallel import dist

    nd = jax.device_count()
    assert nd == nproc * devs, (nd, nproc, devs)
    mesh = Mesh(np.asarray(jax.devices()), (dist.DATA_AXIS,))

    width, k = 9, 4
    n = nd * 8 * 128 * 32 + 17
    rng = np.random.default_rng(0)  # same column on every process
    vals = rng.integers(0, 1 << width, size=n, dtype=np.uint32)
    sdev = dist.shard_column(layout.to_device(layout.pack(vals, width)), mesh)
    keys = np.arange(k, dtype=np.uint32)

    t0 = time.perf_counter()
    _, counts = dist.sharded_shared_scan(sdev, keys, mesh)
    jax.block_until_ready(counts)
    dt = time.perf_counter() - t0
    got = [int(c) for c in np.asarray(counts)]
    expect = [int((vals == key).sum()) for key in keys]
    assert got == expect, (got, expect)

    skeys = (np.arange(8, dtype=np.uint32) * 97 + 5) % (1 << width)
    _, scounts = dist.sharded_shared_scan(sdev, skeys, mesh)
    assert [int(c) for c in np.asarray(scounts)] == [
        int((vals == key).sum()) for key in skeys
    ]

    _, mcount = dist.sharded_member_scan(sdev, skeys, mesh)
    assert int(mcount) == int(np.isin(vals, skeys).sum())

    mvals = rng.integers(0, 1 << 16, size=n, dtype=np.uint32)
    smdev = dist.shard_column(layout.to_device(layout.pack(mvals, 16)), mesh)
    qbits, qcount = q.evaluate_sharded(
        q.And(q.Range(sdev, 1, 200), q.Not(q.Eq(sdev, 7))),
        mesh,
    )
    total, macount = dist.sharded_masked_aggregate(
        smdev, qbits, mesh)
    mask = (vals >= 1) & (vals < 200) & (vals != 7)
    assert int(qcount) == int(macount) == int(mask.sum())
    assert int(total) == int(mvals[mask].astype(np.uint64).sum())

    # GROUP-BY aggregates: the other two cross-process host finalizes
    sums, acounts = dist.sharded_aggregate_scan(
        sdev, smdev, keys, mesh)
    for j, key in enumerate(keys):
        sel = vals == key
        assert int(acounts[j]) == int(sel.sum())
        assert int(sums[j]) == int(mvals[sel].astype(np.uint64).sum())
    mns, mxs, ccounts = dist.sharded_minmax_scan(
        sdev, smdev, keys, mesh)
    for j, key in enumerate(keys):
        sel = vals == key
        if sel.any():
            assert int(mns[j]) == int(mvals[sel].min())
            assert int(mxs[j]) == int(mvals[sel].max())

    print(
        f"proc {proc_id}/{nproc}: mesh={nd} devices across {nproc} processes"
        f" ({devs}/proc), n={n}, all sharded paths verified"
        f" (first scan+psum {dt * 1e3:.0f} ms incl compile)",
        flush=True,
    )
    return 0


def main(argv: list[str]) -> int:
    nproc, devs = 2, 2
    proc_id = None
    for a in argv:
        if a.startswith("--nproc="):
            nproc = int(a.split("=", 1)[1])
        elif a.startswith("--devs-per-proc="):
            devs = int(a.split("=", 1)[1])
        elif a.startswith("--child="):
            proc_id = int(a.split("=", 1)[1])
    if proc_id is not None:
        return child(proc_id, nproc, devs)

    env = dict(os.environ)
    # Gloo process-group demo: every child on the CPU, repo on the path
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={devs}"
    ).strip()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             f"--nproc={nproc}", f"--devs-per-proc={devs}", f"--child={i}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(nproc)
    ]
    rc = 0
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        sys.stdout.write(out.decode())
        if p.returncode != 0:
            rc = 1
            print(f"proc {i} FAILED (rc={p.returncode})")
    print("multiproc demo:", "OK" if rc == 0 else "FAILED")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
