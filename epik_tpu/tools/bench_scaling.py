"""Multi-device scaling-efficiency benchmark (BASELINE.json configs 4-5).

Measures reads/s at 1..N devices on the available backend.  On a CPU host
with ``--xla_force_host_platform_device_count=8`` this validates the
sharding *logic* and collective overhead; on real multi-GPU hosts it
measures true scaling efficiency (target >= 80%, BASELINE.json).

Usage: python -m epik_tpu.tools.bench_scaling [--reads 20000] [--devices 1 2 4 8]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=8000)
    ap.add_argument("--leaves", type=int, default=128)
    ap.add_argument("--kmers", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--devices", type=int, nargs="+", default=None)
    ap.add_argument("--n-model", type=int, default=1,
                    help="model-axis shards (DB hash-sharded when > 1)")
    args = ap.parse_args(argv)

    import jax

    from ..core.alphabet import DNA
    from ..core.tree import parse_newick
    from ..io.build import random_db
    from ..parallel.mesh import make_mesh
    from ..parallel.sharding import ShardedJaxPlacer

    n_avail = len(jax.devices())
    device_counts = args.devices or [d for d in (1, 2, 4, 8) if d <= n_avail]

    db = random_db(num_leaves=args.leaves, kmer_size=args.k, num_kmers=args.kmers,
                   mean_posting_len=12.0, seed=1, unique_branches=False)
    tree = parse_newick(db.tree())
    rng = np.random.default_rng(2)
    n_parts = 150 // args.k
    reads = []
    key_idx = rng.integers(0, db.num_kmers, size=(args.reads, n_parts))
    for i in range(args.reads):
        s = "".join(DNA.decode_key(int(db.keys[j]), args.k) for j in key_idx[i])
        reads.append((f"q{i}", s.encode()))
    log(f"{len(reads)} reads, {db.num_kmers} k-mers, {tree.get_node_count()} branches")

    results = {}
    base = None  # (rps, nd) of the first measured point
    for nd in device_counts:
        if nd % args.n_model:
            continue
        mesh = make_mesh(n_data=nd // args.n_model, n_model=args.n_model,
                         devices=jax.devices()[:nd])
        placer = ShardedJaxPlacer(db, tree, mesh)
        placer.place(reads[: max(len(reads) // 4, 1)])  # warmup/compile
        t0 = time.time()
        placer.place(reads)
        dt = time.time() - t0
        rps = len(reads) / dt
        # efficiency relative to linear scaling from the first point
        eff = 1.0 if base is None else (rps / nd) / (base[0] / base[1])
        if base is None:
            base = (rps, nd)
        results[nd] = {"reads_per_s": round(rps, 1), "efficiency": round(eff, 3)}
        log(f"{nd} device(s): {rps:.0f} reads/s, efficiency {eff:.2f}")

    virtual = jax.default_backend() == "cpu"
    if virtual:
        log(
            "NOTE: host-platform virtual devices share the same physical "
            "cores -- these numbers validate sharding logic and collective "
            "overhead, not real scaling (run on several GPUs for that)."
        )
    print(json.dumps({
        "metric": "scaling_efficiency",
        "value": results[max(results)]["efficiency"] if results else 0.0,
        "unit": "fraction_of_linear",
        "vs_baseline": 1.0,
        "virtual_devices": virtual,
        "per_device": results,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
