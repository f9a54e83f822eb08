#!/usr/bin/env python3
"""Benchmark: reads placed per second per chip (the reference's own meter).

Mirrors the reference's throughput measurement -- wall-clock seq/s per batch
plus run average (reference: epik/src/epik/main.cpp:347-358,368) -- on a
D652-scale synthetic workload (652-leaf tree, ~1300 branches, k=10, 500k
phylo-k-mers, 150bp reads).  The reference repo publishes no benchmark
numbers (SURVEY.md section 6; BASELINE.json "published": {}), so the
baseline is self-measured: the faithful scalar C++ placer (single thread,
the reference's default -j 1, main.cpp:213) on this host.

Methodology: device passes and baseline passes are *interleaved* so both
sides sample the same host-noise regime; the median over passes is the
headline, with best-of and quartiles beside it.  The persistent JAX compile
cache keeps warmup to one cached compile.  It refuses to run without a GPU.

Prints exactly ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
"""

from __future__ import annotations

import json
import os
import sys
import time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> None:
    import numpy as np

    t0 = time.time()
    import jax

    from epik_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    from epik_tpu.core.tree import parse_newick
    from epik_tpu.engine.placer import JaxPlacer, PlacerConfig
    from epik_tpu.io.build import reads_from_reference, reference_like_db
    from epik_tpu.native import NativeScalarPlacer

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    log(f"devices: {jax.devices()} ({dev.device_kind})")

    # --- D652-scale fixture with realistic window hit rate --------------------
    # keys = k-mers of a simulated reference; reads = mutated substrings, so
    # ~90% of windows hit the DB (uniformly random keys would make almost
    # every overlapping window miss and understate the work)
    NUM_LEAVES = 652
    K = 10
    REF_LEN = 520_000
    MEAN_PLEN = 12.0
    READ_LEN = 150
    # batch geometry: INFLIGHT batches are placed concurrently from worker
    # threads so host staging overlaps device compute.  (The reference's
    # own default is 2000 synchronous reads/batch, main.cpp:214 -- the CLI
    # keeps that default.)  Not yet tuned on the GPU.
    BATCH = int(os.environ.get("EPIK_BENCH_BATCH", "16384"))
    INFLIGHT = int(os.environ.get("EPIK_BENCH_INFLIGHT", "6"))
    NUM_READS = 10 * BATCH  # distinct reads; passes loop them (below)
    # each timed pass places LOOPS x NUM_READS reads, so the ramp-up of the
    # first INFLIGHT batches amortizes away
    LOOPS = int(os.environ.get("EPIK_BENCH_LOOPS", "8"))
    # 9 interleaved passes: the JSON reports median + IQR
    PASSES = int(os.environ.get("EPIK_BENCH_PASSES", "9"))
    # baseline thread count for the second baseline row (the reference's
    # -j/--threads, place.cpp:218-229); the single-thread row (-j 1, the
    # reference default, main.cpp:213) is always measured
    BASE_THREADS = int(os.environ.get("EPIK_BENCH_BASELINE_THREADS",
                                      str(os.cpu_count() or 2)))

    log("building synthetic database ...")
    db, ref = reference_like_db(
        num_leaves=NUM_LEAVES, kmer_size=K, ref_length=REF_LEN,
        mean_posting_len=MEAN_PLEN, seed=652,
    )
    tree = parse_newick(db.tree())
    log(f"db: {db.num_kmers} k-mers, {db.num_entries} postings, "
        f"{tree.get_node_count()} branches ({time.time()-t0:.1f}s)")

    reads = reads_from_reference(ref, NUM_READS, length=READ_LEN,
                                 mutation_rate=0.02, seed=7)
    log(f"reads ready ({time.time()-t0:.1f}s)")

    # all host CPUs for the (rare) host-side stages; the device-tokenize
    # fast path does tokenization + lookup on chip.  plane_mode selectable
    # for A/B runs (EPIK_BENCH_PLANE=classic|shifted).
    plane_mode = os.environ.get("EPIK_BENCH_PLANE", "shifted")
    precision = os.environ.get("EPIK_BENCH_PRECISION", "exact")
    cfg = PlacerConfig(host_threads=max(2, os.cpu_count() or 2),
                       plane_mode=plane_mode, precision=precision)
    placer = JaxPlacer(db, tree, config=cfg)
    log(f"placer ready: fast_bytes={placer._fast_bytes} "
        f"dense_db={placer._dense_db} shifted={placer._shifted} "
        f"({time.time()-t0:.1f}s)")

    # --- warmup (compile; persistent-cached across runs) -----------------------
    t_w = time.time()
    placer.place(reads[:BATCH])
    warmup_s = time.time() - t_w
    log(f"warmup batch (compile) took {warmup_s:.1f}s")

    # --- device pass: the production in-flight batch loop ----------------------
    # worker threads each run a whole batch's place() so host staging,
    # upload and fetch overlap; the device serializes the compute
    # (engine/pipeline.py)
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=INFLIGHT)
    batches = [reads[start : start + BATCH]
               for start in range(0, NUM_READS, BATCH)]

    def device_pass(loops=LOOPS):
        t_run = time.time()
        futs = [
            pool.submit(placer.place, b) for _ in range(loops) for b in batches
        ]
        placed = 0
        for f in futs:
            f.result()  # array-backed collection; rows go straight to jplace
            placed += BATCH
        return placed / (time.time() - t_run)

    # one untimed steady-state pass: the first timed pass otherwise pays
    # XLA autotuning and first touches of the multi-GB plane
    warm_rate = device_pass(loops=2)
    log(f"steady-state warmup pass: {warm_rate:.0f} reads/s (untimed)")

    # --- baseline pass: faithful scalar C++ placer, single thread --------------
    # (the reference binary itself cannot be built here: its i2l submodule
    # is empty; this is the same algorithm at native speed)
    base_seqs = [s for _, s in reads[:4000]]
    nat = NativeScalarPlacer(db)
    nat_mt = (NativeScalarPlacer(db, threads=BASE_THREADS)
              if BASE_THREADS > 1 else None)

    def base_pass():
        t_b = time.time()
        nat.place_scores(base_seqs)
        return len(base_seqs) / (time.time() - t_b)

    def base_pass_mt():
        t_b = time.time()
        nat_mt.place_scores(base_seqs)
        return len(base_seqs) / (time.time() - t_b)

    base_pass()  # warm the baseline's caches too
    if nat_mt is not None:
        base_pass_mt()

    # --- interleaved measurement ------------------------------------------------
    dev_rates, base_rates, base_mt_rates = [], [], []
    for i in range(PASSES):
        dev_rates.append(device_pass())
        base_rates.append(base_pass())
        if nat_mt is not None:
            base_mt_rates.append(base_pass_mt())
        mt_note = (f" | -j{BASE_THREADS} {base_mt_rates[-1]:.0f} reads/s"
                   if base_mt_rates else "")
        log(f"pass {i + 1}: device {dev_rates[-1]:.0f} reads/s/chip | "
            f"baseline {base_rates[-1]:.0f} reads/s{mt_note}")

    # --- sustained pass: one long continuous run (~60 s) ------------------------
    # the round-3 verdict asked for a sustained measurement that shrinks the
    # noise interval instead of arguing about it; this is the same loop held
    # for SUSTAIN seconds
    SUSTAIN = float(os.environ.get("EPIK_BENCH_SUSTAIN", "60"))
    t_sus = time.time()
    placed_sus = 0
    futs = []
    while time.time() - t_sus < SUSTAIN or not futs:
        for b in batches:
            futs.append(pool.submit(placer.place, b))
        while len(futs) > INFLIGHT:
            futs.pop(0).result()
            placed_sus += BATCH
        if time.time() - t_sus >= SUSTAIN:
            break
    for f in futs:
        f.result()
        placed_sus += BATCH
    sustained = placed_sus / (time.time() - t_sus)
    log(f"sustained pass: {sustained:.0f} reads/s over {time.time()-t_sus:.0f}s")

    def quartiles(rates):
        s = sorted(rates)
        n = len(s)
        med = s[n // 2]
        q1 = s[n // 4]
        q3 = s[(3 * n) // 4]
        return med, q1, q3

    best = max(dev_rates)
    base_rps = max(base_rates)
    med, q1, q3 = quartiles(dev_rates)
    base_med = sorted(base_rates)[len(base_rates) // 2]
    log(f"device median {med:.0f} (IQR {q1:.0f}-{q3:.0f}, "
        f"{100*(q3-q1)/med:.1f}% of median) best {best:.0f} reads/s/chip | "
        f"baseline median {base_med:.0f} best {base_rps:.0f} reads/s "
        f"(C++ -j1)")

    out = {
        # headline = MEDIAN of the interleaved passes; best-of is the
        # ceiling, IQR the spread
        "metric": "reads_placed_per_sec_per_chip",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "value": round(med, 1),
        "unit": "reads/s",
        "vs_baseline": round(med / base_med, 2),
        "best": round(best, 1),
        "best_vs_baseline": round(best / base_rps, 2),
        "passes": [round(r, 1) for r in dev_rates],
        "iqr": [round(q1, 1), round(q3, 1)],
        "sustained": round(sustained, 1),
        "warmup_s": round(warmup_s, 1),
        "plane_mode": plane_mode,
        "precision": precision,
    }
    if base_mt_rates:
        base_mt_med = sorted(base_mt_rates)[len(base_mt_rates) // 2]
        log(f"baseline -j{BASE_THREADS} median {base_mt_med:.0f} "
            f"best {max(base_mt_rates):.0f} reads/s")
        out["baseline_threads"] = BASE_THREADS
        out["baseline_mt_median"] = round(base_mt_med, 1)
        out["vs_baseline_mt"] = round(med / base_mt_med, 2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
