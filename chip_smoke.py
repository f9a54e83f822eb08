#!/usr/bin/env python3
"""Smoke run of the placement engine on a GPU, with checks of its results.

    python chip_smoke.py               # one GPU
    python chip_smoke.py --devices 4   # the multi-device path on four GPUs

One GPU, phases in order:

1. device -- the card (``nvidia-smi``), JAX's devices, the memory pool;
2. d652   -- a D652-scale nucleotide database (652 taxa, k=10, ~400k
   k-mers) and 100k 150 bp reads on disk, placed through the CLI
   (``epik place`` at default flags) and by the native C++ placer
   (``--engine native``); the two jplace files must match for every read;
3. parity -- tools/verify.py: the ppdiff cases and a 300-read mix with
   ambiguity, duplicates, short and no-hit reads on every engine path,
   each against the scalar oracle;
4. amino  -- a reference-derived protein database on the radix-lookup
   device path, against the native placer;
5. bigtree -- a 10k-taxa (~20k branches) database on the posting-tiles
   path and on the CSR path, each against the native placer on a sample,
   with both timed and the tiles step's accumulate / finish split read
   from a profiler trace.

``--devices 4`` runs only the multi-device path: the sharded engine on
meshes 1x4 and 2x2 (dense column-sharded, posting tiles, hash-sharded CSR)
and a 2-process CLI launch with each process bound to two cards, each
compared with the single-card placement.

Times, rates and memory printed here are first observations of one run.
The script exits non-zero, printing no result, when JAX finds no GPU, when
the native host library cannot be built, or when a phase fails.  Its last
line on stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
``--rehearse`` runs the same phases at toy sizes on any backend (for a
CPU dry run; it never prints an ok result).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import glob
import io
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "d652", "parity", "amino", "bigtree")
OUT_DIR = os.path.join(REPO, "chiprun_out")


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_info() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


# --------------------------------------------------------------------------
# fixtures (numpy only: the parent of a multi-process launch stays off JAX)
# --------------------------------------------------------------------------


def sizes(rehearse: bool) -> dict:
    """Fixture shapes: the real ones, or toy ones for a CPU rehearsal."""
    if rehearse:
        return dict(d652=dict(num_leaves=64, ref_length=20_000), reads=600,
                    amino=dict(num_leaves=48, ref_length=10_000), amino_reads=300,
                    big=dict(num_leaves=400, ref_length=20_000), big_reads=600,
                    big_config=dict(dense_db="off"),
                    sample=200, batch=256)
    return dict(d652=dict(num_leaves=652, ref_length=520_000), reads=100_000,
                amino=dict(num_leaves=652, ref_length=400_000), amino_reads=20_480,
                big=dict(num_leaves=10_000, ref_length=1_000_000), big_reads=32_768,
                big_config={},
                sample=2_000, batch=4_096)


def d652_fixture(sz, n_reads):
    """The D652-scale nucleotide database of bench.py and its reads."""
    from epik_tpu.io.build import reads_from_reference, reference_like_db

    db, ref = reference_like_db(kmer_size=10, mean_posting_len=12.0, seed=652,
                                **sz["d652"])
    reads = reads_from_reference(ref, n_reads, length=150, mutation_rate=0.02,
                                 seed=7)
    return db, reads


def write_fasta(path, reads):
    with open(path, "wb") as f:
        for name, seq in reads:
            f.write(b">" + name.encode() + b"\n" + seq + b"\n")


def write_jplace(path, placed, tree):
    from epik_tpu.core.tree import to_newick
    from epik_tpu.io.jplace import jplace_writer

    w = jplace_writer(path, "chip_smoke ", to_newick(tree, jplace_edges=True))
    w.start()
    w << placed
    w.end()
    return path


def diff_clean(path_a, path_b, what):
    from epik_tpu.tools.jplace_diff import jplace_diff

    res = jplace_diff(path_a, path_b)
    log(f"{what}: {res.num_matches}/{res.num_seqs} reads match")
    for m in res.mismatches[:5]:
        log(f"  {m}")
    check(res.num_seqs > 0 and res.clean, f"{what}: placements differ")


# --------------------------------------------------------------------------
# one GPU
# --------------------------------------------------------------------------


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling (its own
    monitoring events), so a phase can report its compile time."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration


def run_cli(argv):
    """``epik`` in-process (one JAX process per card); returns its stdout."""
    from epik_tpu.cli.main import main as epik_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = epik_main([str(a) for a in argv])
    out = buf.getvalue()
    check(rc == 0, f"epik {' '.join(map(str, argv[:1]))} exited {rc}:\n{out}")
    return out


def peak_bytes():
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def phase_device():
    import jax

    devs = jax.devices()
    stats = jax.local_devices()[0].memory_stats() or {}
    log(f"jax {jax.__version__}: {len(devs)} device(s) {devs}")
    log(f"device memory pool (bytes_limit): {stats.get('bytes_limit')}")


def phase_d652(sz, work, clock):
    from epik_tpu.io.db import save

    t0 = time.time()
    db, reads = d652_fixture(sz, sz["reads"])
    dbp = os.path.join(work, "d652.eptk")
    save(db, dbp)
    fasta = os.path.join(work, "d652.fasta")
    write_fasta(fasta, reads)
    log(f"d652: {db.num_kmers} k-mers, {db.num_entries} postings, "
        f"{len(reads)} reads of 150 bp written ({time.time() - t0:.1f} s)")
    del db

    out_jax = os.path.join(work, "d652_jax")
    out_nat = os.path.join(work, "d652_native")
    os.makedirs(out_jax)
    os.makedirs(out_nat)
    c0 = clock.seconds
    t0 = time.time()
    out = run_cli(["place", "-i", dbp, "-s", "nucl", "-o", out_jax, fasta])
    wall = time.time() - t0
    placed = int(re.search(r"Placed (\d+) sequences", out).group(1))
    ms = int(re.search(r"Placement time: .* \((\d+) ms\)", out).group(1))
    path = re.search(r"path: (.*)", out).group(1).strip()
    log(f"d652 cli: {placed} reads in {ms} ms of placement "
        f"({placed / (ms / 1000):.0f} reads/s by the CLI's meter), "
        f"{wall:.1f} s wall incl. DB load; compile {clock.seconds - c0:.1f} s; "
        f"peak device memory {peak_bytes()} bytes")
    log(f"d652 cli path: {path}")
    check(placed == len(reads), f"d652: placed {placed} of {len(reads)}")
    check(path == "dense shifted pair-plane device-tokenize",
          f"d652 took the path {path!r}, not the shifted pair-plane "
          "device-tokenize path")

    t0 = time.time()
    run_cli(["place", "-i", dbp, "-s", "nucl", "-o", out_nat,
             "--engine", "native", "-j", os.cpu_count() or 1, fasta])
    log(f"d652 native -j {os.cpu_count()}: {time.time() - t0:.1f} s wall")
    name = "placements_d652.fasta.jplace"
    diff_clean(os.path.join(out_jax, name), os.path.join(out_nat, name),
               "d652 jax vs native")


def phase_parity(work):
    from epik_tpu.tools.verify import verify

    t0 = time.time()
    summary = verify(os.path.join(work, "verify"), log=log)
    log(f"parity: {summary['cases_passed']}/{summary['cases_total']} cases, "
        f"{summary['reads_matched']}/{summary['reads_total']} reads "
        f"({time.time() - t0:.1f} s)")
    check(summary["ok"], "parity mix: mismatches against the oracle")


def place_timed(placer, reads, batch, inflight=3, passes=1):
    """Place all reads in batches with ``inflight`` batches in flight (the
    CLI pipeline's overlap), ``passes`` times after a warm-up batch;
    returns (collections of the last pass, reads/s of the last pass, all
    pass rates)."""
    from concurrent.futures import ThreadPoolExecutor

    batches = [reads[i:i + batch] for i in range(0, len(reads), batch)]
    placer.place(batches[0])  # compile
    rates = []
    with ThreadPoolExecutor(max_workers=inflight) as pool:
        for _ in range(passes):
            t0 = time.time()
            outs = list(pool.map(placer.place, batches))
            rates.append(len(reads) / (time.time() - t0))
    return outs, rates[-1], rates


def merged(collections):
    from epik_tpu.engine.types import PlacedCollection

    seq_map, placed = {}, []
    for c in collections:
        seq_map.update(c.sequence_map)
        placed.extend(c.placed_seqs)
    return PlacedCollection(sequence_map=seq_map, placed_seqs=placed)


def phase_amino(sz, work):
    from epik_tpu.core.tree import parse_newick
    from epik_tpu.engine.placer import JaxPlacer, PlacerConfig
    from epik_tpu.io.build import reads_from_reference, reference_like_db
    from epik_tpu.native import NativePlacer

    db, ref = reference_like_db(kmer_size=8, mean_posting_len=12.0,
                                sequence_type="amino", seed=20, **sz["amino"])
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, sz["amino_reads"], length=144,
                                 mutation_rate=0.02, sequence_type="amino",
                                 seed=21)
    placer = JaxPlacer(db, tree, config=PlacerConfig(host_threads=os.cpu_count() or 1))
    log(f"amino: {db.num_kmers} k-mers, path {placer.path_name}")
    check(placer._fast_codes, "amino did not take the radix device path")
    outs, rate, _ = place_timed(placer, reads, sz["batch"])
    log(f"amino: {len(reads)} reads at {rate:.0f} reads/s (3 batches in flight)")
    nat = NativePlacer(db, tree, threads=os.cpu_count() or 1).place(reads)
    diff_clean(write_jplace(os.path.join(work, "amino_jax.jplace"), merged(outs), tree),
               write_jplace(os.path.join(work, "amino_native.jplace"), nat, tree),
               "amino jax vs native")


def hlo_scopes(compiled_text: str) -> dict:
    """HLO instruction name -> (op_name metadata, which carries the
    ``jax.named_scope`` path, or "" when XLA dropped it; result shape)
    from a compiled module's text."""
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\S+)')
    out = {}
    for line in compiled_text.splitlines():
        m = pat.match(line)
        if m:
            op = re.search(r'op_name="([^"]*)"', line)
            out[m.group(1)] = (op.group(1) if op else "", m.group(2))
    return out


def trace_split(compiled, args, trace_dir, reps=5):
    """Device time of the compiled step per named scope, from a profiler
    trace: (total ns, {scope: ns}, [(kernel, ns), ...])."""
    import jax

    scopes = hlo_scopes(compiled.as_text())
    jax.block_until_ready(compiled(*args))
    with jax.profiler.trace(trace_dir):
        for _ in range(reps):
            jax.block_until_ready(compiled(*args))
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    from jax.profiler import ProfileData

    total, by_scope, by_kernel = 0, {}, {}
    ops = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = str(stats.get("hlo_op", ""))
                if not op:
                    continue
                dur = int(ev.duration_ns)
                total += dur
                by_kernel[op] = by_kernel.get(op, 0) + dur
                op_name, shape = scopes.get(op, ("", ""))
                ops[op] = f"{shape} {op_name or '(no op_name)'}"
                parts = op_name.split("/")
                scope = ("accumulate" if "accumulate" in parts
                         else "finish" if "finish" in parts else "other")
                by_scope[scope] = by_scope.get(scope, 0) + dur
    top = sorted(((op, ns, ops[op]) for op, ns in by_kernel.items()),
                 key=lambda t: -t[1])
    return total, by_scope, top


def phase_bigtree(sz, work, clock):
    import jax

    from epik_tpu.core.tree import parse_newick
    from epik_tpu.engine.placer import JaxPlacer, PlacerConfig
    from epik_tpu.io.build import reads_from_reference, reference_like_db
    from epik_tpu.native import NativePlacer

    t0 = time.time()
    db, ref = reference_like_db(kmer_size=10, mean_posting_len=12.0, seed=10,
                                **sz["big"])
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, sz["big_reads"], length=150,
                                 mutation_rate=0.02, seed=11)
    log(f"bigtree: {db.num_kmers} k-mers, {db.num_entries} postings, "
        f"{tree.get_node_count()} branches ({time.time() - t0:.1f} s)")
    sample = reads[:sz["sample"]]
    cores = os.cpu_count() or 1
    nat = NativePlacer(db, tree, threads=cores).place(sample)
    nat_path = write_jplace(os.path.join(work, "big_native.jplace"), nat, tree)

    rates = {}
    for mode, cfg in (("tiles", PlacerConfig(host_threads=cores,
                                             **sz["big_config"])),
                      ("csr", PlacerConfig(host_threads=cores, dense_db="off",
                                           tokenize_where="host"))):
        placer = JaxPlacer(db, tree, config=cfg)
        log(f"bigtree {mode}: path {placer.path_name}")
        check(placer._tiles_mode == (mode == "tiles"),
              f"bigtree {mode}: unexpected path {placer.path_name}")
        c0 = clock.seconds
        outs, rates[mode], all_rates = place_timed(placer, reads, sz["batch"],
                                                   passes=2)
        log(f"bigtree {mode}: {len(reads)} reads per pass at "
            + ", ".join(f"{r:.0f}" for r in all_rates)
            + f" reads/s (batch {sz['batch']}, 3 in flight); compile inside "
            f"the passes {clock.seconds - c0:.1f} s; overflow retries "
            f"{placer.overflow_retries}; peak device memory {peak_bytes()} bytes")
        got = placer.place(sample)
        diff_clean(nat_path,
                   write_jplace(os.path.join(work, f"big_{mode}.jplace"), got, tree),
                   f"bigtree {mode} vs native")
        if mode == "tiles":
            fn, args = placer.device_fn_args(reads[:sz["batch"]])
            lowered = jax.jit(fn).lower(*args)
            compiled = lowered.compile()
            t1 = time.time()
            for _ in range(10):
                jax.block_until_ready(compiled(*args))
            step_ms = (time.time() - t1) / 10 * 1000
            # one kernel per HLO op in the trace: CUDA-graph command
            # buffers would fold the step's kernels into one event
            traced = lowered.compile(
                compiler_options={"xla_gpu_enable_command_buffer": ""})
            total, by_scope, top = trace_split(
                traced, args, os.path.join(OUT_DIR, "smoke_trace_bigtree"))
            shares = {k: v / total for k, v in by_scope.items()} if total else {}
            log(f"bigtree tiles step: {step_ms:.2f} ms per {sz['batch']}-read "
                f"batch (host clock, 10 reps); device kernel time "
                f"{total / 5 / 1e6:.2f} ms per step; shares "
                + json.dumps({k: round(v, 4) for k, v in shares.items()}))
            for op, ns, what in top[:8]:
                log(f"  kernel {op}: {ns / 5 / 1e6:.3f} ms per step -- {what}")
        del placer, outs
        gc.collect()
    log(f"bigtree tiles/csr rate ratio: {rates['tiles'] / rates['csr']:.2f}")


def run_one(args):
    from epik_tpu.native import native_available, native_build_error

    sz = sizes(args.rehearse)
    clock = CompileClock()
    check(native_available(), "the native host library could not be built: "
          + native_build_error())
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="epik_smoke_") as work:
        for name, fn in (
            ("device", phase_device),
            ("d652", lambda: phase_d652(sz, work, clock)),
            ("parity", lambda: phase_parity(work)),
            ("amino", lambda: phase_amino(sz, work)),
            ("bigtree", lambda: phase_bigtree(sz, work, clock)),
        ):
            if args.phase and name not in args.phase:
                continue
            t0 = time.time()
            log(f"== phase {name}")
            fn()
            gc.collect()
            log(f"== phase {name} passed ({time.time() - t0:.1f} s)")


# --------------------------------------------------------------------------
# four GPUs
# --------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_two_processes(dbp, fasta, work, rehearse):
    """The CLI's multi-process launch: 2 processes, each bound to its own
    two local devices, one 2x2 mesh.  Runs before this process touches a
    device: a JAX process reserves most of each card it opens."""
    port = free_port()
    env = dict(os.environ)
    procs, outs = [], []
    for rank in range(2):
        out = os.path.join(work, f"mp_rank{rank}")
        os.makedirs(out)
        cmd = [sys.executable, "-m", "epik_tpu", "place", "-i", dbp,
               "-o", out, "--engine", "sharded", "--n-model", "2",
               "--coordinator", f"localhost:{port}", "--num-processes", "2",
               "--process-id", str(rank), "--batch-size", "4096", fasta]
        if rehearse:
            env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        else:
            cmd[-1:-1] = ["--local-devices", f"{2 * rank},{2 * rank + 1}"]
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
        outs.append(out)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, logs)):
        tail = "\n".join(text.strip().splitlines()[-6:])
        log(f"multi-process rank {rank} exited {p.returncode}:\n{tail}")
        check(p.returncode == 0, f"multi-process rank {rank} failed")
        check("sharded mesh 2x2" in text, f"rank {rank}: no 2x2 mesh")
    return os.path.join(outs[0], "placements_d652.fasta.jplace")


def run_four(args):
    from epik_tpu.io.db import save

    sz = sizes(args.rehearse)
    with tempfile.TemporaryDirectory(prefix="epik_smoke4_") as work:
        t0 = time.time()
        db, reads = d652_fixture(sz, 8_192 if not args.rehearse else sz["reads"])
        dbp = os.path.join(work, "d652.eptk")
        save(db, dbp)
        fasta = os.path.join(work, "d652.fasta")
        write_fasta(fasta, reads)
        log(f"d652: {db.num_kmers} k-mers, {len(reads)} reads "
            f"({time.time() - t0:.1f} s)")
        log("== phase multi-process")
        t0 = time.time()
        mp_path = launch_two_processes(dbp, fasta, work, args.rehearse)
        log(f"== phase multi-process ran ({time.time() - t0:.1f} s)")

        from epik_tpu.utils.compile_cache import configure_compile_cache

        configure_compile_cache()
        import jax

        from epik_tpu.core.tree import parse_newick
        from epik_tpu.engine.placer import JaxPlacer, PlacerConfig
        from epik_tpu.parallel.mesh import make_mesh
        from epik_tpu.parallel.sharding import ShardedJaxPlacer

        phase_device()
        check(len(jax.devices()) >= 4, f"need 4 devices, have {len(jax.devices())}")
        tree = parse_newick(db.tree())
        single = JaxPlacer(db, tree, config=PlacerConfig(host_threads=os.cpu_count() or 1))
        ref_path = write_jplace(os.path.join(work, "single.jplace"),
                                merged(place_timed(single, reads, 4096)[0]), tree)
        del single
        gc.collect()
        diff_clean(ref_path, mp_path, "2-process CLI 2x2 vs single card")

        devices = jax.devices()[:4]
        for (nd, nm), mode, cfg, expect in (
            ((1, 4), "dense", PlacerConfig(), "dense"),
            ((2, 2), "dense", PlacerConfig(), "dense"),
            ((2, 2), "tiles", PlacerConfig(dense_db="off"), "tiles"),
            ((2, 2), "csr", PlacerConfig(dense_db="off", tokenize_where="host"), "csr"),
        ):
            t0 = time.time()
            mesh = make_mesh(n_data=nd, n_model=nm, devices=devices)
            sp = ShardedJaxPlacer(db, tree, mesh, config=cfg)
            got = ("dense" if sp._dense_db else
                   "tiles" if sp._tiles_mode else "csr")
            check(got == expect, f"mesh {nd}x{nm} {mode}: took {got}")
            outs, rate, _ = place_timed(sp, reads, 4096)
            log(f"sharded {mode} {nd}x{nm}: {rate:.0f} reads/s "
                f"({time.time() - t0:.1f} s incl. set-up and compile)")
            diff_clean(ref_path,
                       write_jplace(os.path.join(work, f"{mode}_{nd}x{nm}.jplace"),
                                    merged(outs), tree),
                       f"sharded {mode} {nd}x{nm} vs single card")
            del sp, outs
            gc.collect()


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="1: the single-card phases; 4: only the "
                         "multi-device path and what it is compared with")
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes on any backend; never reports ok")
    ap.add_argument("--phase", action="append", default=None,
                    choices=PHASES,
                    help="run only this single-card phase (repeatable; "
                         "never reports ok)")
    args = ap.parse_args(argv)

    try:
        if args.devices == 1:
            from epik_tpu.utils.compile_cache import configure_compile_cache

            configure_compile_cache()
            import jax

            platform = jax.devices()[0].platform
            if platform != "gpu" and not args.rehearse:
                raise SmokeFailure(f"JAX found no GPU (platform {platform!r})")
        if not args.rehearse:
            log(f"card: {card_info()}")
        (run_four if args.devices == 4 else run_one)(args)
    except SmokeFailure as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    import jax

    devs = jax.devices()
    if args.rehearse or args.phase or devs[0].platform != "gpu":
        log(f"partial or rehearsal run on {devs[0].platform} finished; "
            "no result reported")
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
