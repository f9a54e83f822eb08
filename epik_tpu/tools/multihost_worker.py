"""Multi-process placement worker: one rank of a 2+-process job.

Usage (one invocation per rank; also the multi-host usage example):

    python -m epik_tpu.tools.multihost_worker RANK NPROC PORT [dense|csr]

Streaming / failure-story mode (round-4 verdict ask #7):

    python -m epik_tpu.tools.multihost_worker RANK NPROC PORT stream \
        --out DIR [--resume] [--kill-after K] [--watchdog S]

places a deterministic multi-batch stream through ShardedJaxPlacer with
rank 0 writing a jplace file batch-by-batch (per-batch flush + atomic
resume sidecar, io/jplace.py).  ``--kill-after K`` makes a NON-ZERO rank
die abruptly before batch K (fault injection); the surviving ranks'
BatchWatchdog (parallel/mesh.py) detects the stalled collective and exits
STALL_EXIT_CODE so a supervisor can restart every rank with ``--resume``,
which skips the batches already in the sidecar.  Tested end-to-end in
tests/test_multihost.py::test_kill_restart_resume.

Each rank calls :func:`epik_tpu.parallel.mesh.init_distributed`, builds a
global ('data', 'model') mesh over every device of every process, places
one deterministic batch with :class:`ShardedJaxPlacer`, and checks oracle
parity (the data-axis shards are exchanged at fetch time with
``process_allgather``, so every rank sees and verifies the full batch --
sharding.py::ShardedJaxPlacer._fetch).  Prints ``PARITY OK <n>`` on
success.  The reference has no multi-process analog (single OpenMP
process, SURVEY.md section 5.8) -- this path is green-field.

On CPU the test harness (tests/test_multihost.py) spawns 2 ranks with 4
virtual devices each (XLA_FLAGS=--xla_force_host_platform_device_count=4);
on GPU hosts the same code runs with one device set per process.
"""

from __future__ import annotations

import os
import sys


def _stream(rank, nproc, mesh, args):
    """The failure-story streaming loop: jplace + sidecar + watchdog."""
    import numpy as np

    from epik_tpu.core.alphabet import DNA
    from epik_tpu.core.tree import parse_newick
    from epik_tpu.engine.placer import PlacerConfig
    from epik_tpu.io.build import random_db
    from epik_tpu.io.jplace import jplace_writer
    from epik_tpu.parallel.mesh import BatchWatchdog
    from epik_tpu.parallel.sharding import ShardedJaxPlacer

    out_dir = args["out"]
    resume = args["resume"]
    kill_after = args["kill_after"]
    watchdog_s = args["watchdog"]
    n_batches, batch_size = 5, 16

    db = random_db(num_leaves=16, kmer_size=6, num_kmers=1024, seed=11)
    tree = parse_newick(db.tree())
    rng = np.random.default_rng(3)
    batches = []
    for b in range(n_batches):
        batch = []
        for i in range(batch_size):
            parts = [
                DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 6)
                for _ in range(6)
            ]
            batch.append((f"b{b}_q{i}", "".join(parts).encode()))
        batches.append(batch)

    placer = ShardedJaxPlacer(db, tree, mesh, config=PlacerConfig())
    path = os.path.join(out_dir, "placements_stream.jplace")
    writer = None
    skip = 0
    if rank == 0:
        writer = jplace_writer(path, "epik_tpu multihost_worker stream ",
                               db.tree_newick, resume=resume)
        writer.start()
        skip = writer.resumed_reads // batch_size
    # every rank must agree on how many batches to skip: the sidecar is on
    # a shared filesystem (same contract as the shared output dir); ranks
    # without one assume 0 only when rank 0 does too
    sidecar = path + ".resume"
    if rank != 0 and resume and os.path.exists(sidecar):
        import json as _json

        with open(sidecar) as f:
            skip = _json.load(f)["reads"] // batch_size

    dog = BatchWatchdog(watchdog_s, rank=rank)
    for b in range(skip, n_batches):
        if kill_after is not None and rank != 0 and b >= kill_after:
            print(f"FAULT INJECTION: rank {rank} dying before batch {b}",
                  flush=True)
            os._exit(1)
        dog.arm(f"batch {b}")
        placed = placer.place(batches[b])
        dog.disarm()
        if writer is not None:
            writer << placed
    dog.stop()
    if writer is not None:
        writer.end()
    print(f"STREAM OK {sum(len(b) for b in batches[skip:])}", flush=True)
    return 0


def main() -> int:
    rank = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    mode = sys.argv[4] if len(sys.argv) > 4 else "dense"
    extra = sys.argv[5:]
    args = {"out": None, "resume": False, "kill_after": None,
            "watchdog": 30.0}
    it = iter(extra)
    for a in it:
        if a == "--out":
            args["out"] = next(it)
        elif a == "--resume":
            args["resume"] = True
        elif a == "--kill-after":
            args["kill_after"] = int(next(it))
        elif a == "--watchdog":
            args["watchdog"] = float(next(it))

    # must precede any jax device use; the env vars are set by the spawner
    import jax

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")

    from epik_tpu.parallel.mesh import init_distributed, make_mesh

    init_distributed(f"127.0.0.1:{port}", num_processes=nproc,
                     process_id=rank, initialization_timeout=120)

    import numpy as np

    from epik_tpu.core.alphabet import DNA
    from epik_tpu.core.tree import parse_newick
    from epik_tpu.engine.placer import PlacerConfig
    from epik_tpu.engine.reference import ReferencePlacer
    from epik_tpu.io.build import random_db
    from epik_tpu.parallel.sharding import ShardedJaxPlacer

    n_dev = len(jax.devices())
    n_model = 2 if n_dev % 2 == 0 else 1
    mesh = make_mesh(n_data=n_dev // n_model, n_model=n_model)

    if mode == "stream":
        return _stream(rank, nproc, mesh, args)

    # deterministic fixture: every rank builds the identical DB and batch
    db = random_db(num_leaves=16, kmer_size=6, num_kmers=1024, seed=11)
    tree = parse_newick(db.tree())
    rng = np.random.default_rng(2)
    reads = []
    for i in range(24):
        parts = [
            DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 6)
            for _ in range(6)
        ]
        reads.append((f"q{i}", "".join(parts).encode()))

    # csr: a 1 KiB budget fits neither dense planes nor tiles, the regime
    # of a DB larger than device memory
    cfg = (PlacerConfig(dense_db_budget=1024) if mode == "csr"
           else PlacerConfig())
    placer = ShardedJaxPlacer(db, tree, mesh, config=cfg)
    out = placer.place(reads)

    oracle = ReferencePlacer(db, tree).place(reads)
    best = {
        p.sequence: p.placements[0].branch_id
        for p in oracle.placed_seqs
        if p.placements
    }
    n = 0
    for p in out.placed_seqs:
        if p.placements and p.sequence in best:
            assert p.placements[0].branch_id == best[p.sequence], (
                f"rank {rank}: multi-host {mode} diverges from oracle on "
                f"{p.sequence!r}"
            )
            n += 1
    assert n >= len(reads) - 1, f"rank {rank}: only {n} reads verified"
    print(f"PARITY OK {n}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
