"""Sharded-engine overhead row: ShardedJaxPlacer on a 1x1 mesh vs JaxPlacer.

BASELINE.json config 5 requires the sharded engine to cost ~nothing when the
mesh degenerates to one device -- the shard_map program, padded batch
geometry, and two-stage top-k must not tax the single-chip fast path by
more than ~10%.  Uses the exact bench.py fixture/geometry so compiled
programs are shared with the main bench where shapes align.

Prints one JSON line with both rates and the ratio.

Usage: python -m epik_tpu.tools.bench_sharded_1x1 [--reads 40960]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=40960)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--inflight", type=int, default=4)
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args(argv)

    import jax

    from ..utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    from ..core.tree import parse_newick
    from ..engine.placer import JaxPlacer, PlacerConfig
    from ..io.build import reads_from_reference, reference_like_db
    from ..parallel.mesh import make_mesh
    from ..parallel.sharding import ShardedJaxPlacer

    log(f"backend: {jax.default_backend()}")
    db, ref = reference_like_db(
        num_leaves=652, kmer_size=10, ref_length=520_000,
        mean_posting_len=12.0, seed=652,
    )
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, args.reads, length=150,
                                 mutation_rate=0.02, seed=7)

    cfg = PlacerConfig(host_threads=max(2, os.cpu_count() or 2))
    mesh = make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])

    pool = ThreadPoolExecutor(max_workers=args.inflight)
    rates = {}
    # engines are built and measured SEQUENTIALLY: each may own a multi-GB
    # (pair) plane, and two resident planes exhaust one device's memory
    for name in ("jax", "sharded_1x1"):
        if name == "jax":
            placer = JaxPlacer(db, tree, config=cfg)
        else:
            placer = ShardedJaxPlacer(db, tree, mesh, config=cfg)
        t_w = time.time()
        placer.place(reads[: args.batch])  # warmup/compile
        log(f"{name}: warmup {time.time() - t_w:.1f}s")
        best = 0.0
        for p in range(args.passes):
            t0 = time.time()
            futs = [pool.submit(placer.place, reads[s : s + args.batch])
                    for s in range(0, args.reads, args.batch)]
            for f in futs:
                f.result()
            rps = args.reads / (time.time() - t0)
            log(f"{name} pass {p + 1}: {rps:.0f} reads/s")
            best = max(best, rps)
        rates[name] = best
        del placer
        import gc

        gc.collect()

    ratio = rates["sharded_1x1"] / rates["jax"]
    print(json.dumps({
        "metric": "sharded_1x1_vs_jax",
        "value": round(ratio, 3),
        "unit": "fraction_of_single_chip_throughput",
        "vs_baseline": round(ratio, 3),
        "jax_reads_per_s": round(rates["jax"], 1),
        "sharded_reads_per_s": round(rates["sharded_1x1"], 1),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
