"""EPIK command-line interface.

One CLI replaces both reference layers: the Python click wrapper
(reference: epik.py:29-70, flag surface -i/-s/--omega/--mu/-o/--threads/
--max-ram) and the C++ driver binary (reference: epik/src/epik/main.cpp:
205-391, flags -d/-q/-j/--batch-size/--keep-at-most/--keep-factor and the
full load -> place -> jplace orchestration).  There is no compile-time
DNA/amino fork -- the database self-describes its alphabet, and ``-s`` is
validated against it (the reference instead picks epik-dna vs epik-aa,
epik.py:78-83).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .. import __version__
from ..core.tree import parse_newick, to_newick
from ..io.db import PKDB_VALUE_SIZE, load
from ..io.fasta import batch_fasta
from ..io.jplace import jplace_writer
from ..utils.progress import (
    ProgressBar,
    humanize_time,
    parse_human_readable,
    to_human_readable,
)

__all__ = ["main", "place_queries"]


def _err(msg: str) -> None:
    print(msg, file=sys.stderr)


def _existing_file(path: str) -> str:
    if not os.path.isfile(path):
        raise argparse.ArgumentTypeError(f"File '{path}' does not exist.")
    return path


def _existing_path(path: str) -> str:
    if not os.path.exists(path):
        raise argparse.ArgumentTypeError(f"Path '{path}' does not exist.")
    return path


def _existing_dir(path: str) -> str:
    if not os.path.isdir(path):
        raise argparse.ArgumentTypeError(f"Directory '{path}' does not exist.")
    return path


def _device_ids(text: str) -> list[int]:
    try:
        return [int(x) for x in text.split(",")]
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"'{text}' is not a comma-separated list of device ids.") from None


def _parser() -> argparse.ArgumentParser:
    fmt = argparse.ArgumentDefaultsHelpFormatter
    ap = argparse.ArgumentParser(
        prog="epik",
        description="EPIK: Evolutionary Placement with Informative "
                    "K-mers on an accelerator.",
    )
    ap.add_argument("--version", action="version",
                    version=f"%(prog)s, version {__version__}")
    sub = ap.add_subparsers(dest="command", required=True)

    pl = sub.add_parser(
        "place", formatter_class=fmt,
        help="Places .fasta files using the input phylo-k-mer database.",
        description="Places .fasta files using the input phylo-k-mer "
                    "database. epik place -s [nucl|amino] -i DB.eptk -o "
                    "output file.fasta",
    )
    pl.add_argument("-i", "-d", "--database", required=True,
                    type=_existing_file, help="Input database.")
    pl.add_argument("-s", "--states", choices=["nucl", "amino"],
                    default="nucl", help="States used in analysis.")
    pl.add_argument("--omega", type=float, default=1.5,
                    help="User omega value, determines the score threshold.")
    pl.add_argument("--mu", type=float, default=1.0,
                    help="The proportion of the database to keep.")
    pl.add_argument("-o", "--outputdir", required=True, type=_existing_dir,
                    help="Output directory.")
    pl.add_argument("-j", "--threads", type=int, default=1,
                    help="Host worker threads for tokenization (device count "
                         "is controlled by jax).")
    pl.add_argument("--max-ram", type=str, default="",
                    help="Approximate RAM limit to use. Database may not be "
                         "fully loaded")
    pl.add_argument("--batch-size", type=int, default=2000,
                    help="Batch size (reads per device step).")
    pl.add_argument("--keep-at-most", type=int, default=7,
                    help="Number of branches to report.")
    pl.add_argument("--keep-factor", type=float, default=0.01,
                    help="Minimum LWR to report.")
    pl.add_argument("--engine",
                    choices=["jax", "sharded", "native", "reference"],
                    default="jax",
                    help="Placement engine: single-device XLA pipeline, the "
                         "multi-device sharded engine, the native C++ CPU "
                         "placer (-j threads, no JAX device needed), or the "
                         "scalar oracle.")
    pl.add_argument("--n-model", type=int, default=1,
                    help="Model-axis shards for --engine sharded (database "
                         "sharded when > 1); remaining devices go "
                         "data-parallel.")
    pl.add_argument("--platform", type=str, default=None,
                    help="Force a jax platform (e.g. cpu, gpu). Default: "
                         "jax's choice.")
    pl.add_argument("--inflight", type=int, default=3,
                    help="Batches placed concurrently (overlaps host "
                         "staging with device compute; 1 = the reference's "
                         "synchronous loop).")
    pl.add_argument("--resume", action="store_true",
                    help="Resume an interrupted run: keep complete "
                         "placements in the existing output file and "
                         "continue from the next read.")
    pl.add_argument("--verbose", action="store_true",
                    help="Print the pipeline stage-time breakdown.")
    pl.add_argument("--profile-dir", default=None,
                    help="Capture a jax profiler trace of the run into this "
                         "directory.")
    pl.add_argument("--precision", choices=["exact", "int16", "bf16"],
                    default="exact",
                    help="Dense-plane storage: exact f32, int16 quantized "
                         "shifted grid (half the plane bytes, parity-clean), "
                         "or bf16 (outside the 1e-4 parity gate).")
    pl.add_argument("--plane-mode", choices=["shifted", "classic"],
                    default="shifted",
                    help="Dense scoring formulation (classic materializes "
                         "exact per-branch counts; shifted is the "
                         "single-reduce fast path).")
    pl.add_argument("--pair-plane", choices=["auto", "on", "off"],
                    default="auto",
                    help="(k+1)-mer pair plane: one row gather per two "
                         "windows when the combined plane fits device "
                         "memory.")
    pl.add_argument("--tile-payload", choices=["auto", "packed", "f32"],
                    default="auto",
                    help="Posting-tile cell layout (the big-tree path): "
                         "packed int32 (branch<<16 | quantized score; half "
                         "the gather bytes + exact int32 accumulate) or "
                         "bit-exact f32 pairs.")
    pl.add_argument("--coordinator", type=str, default=None,
                    help="Multi-process: coordinator address host:port "
                         "(rank 0 serves it); requires --num-processes and "
                         "--process-id.")
    pl.add_argument("--num-processes", type=int, default=None,
                    help="Multi-process: total process count.")
    pl.add_argument("--process-id", type=int, default=None,
                    help="Multi-process: this process's rank.")
    pl.add_argument("--local-devices", type=_device_ids, default=None,
                    help="Multi-process: comma-separated ids of the local "
                         "devices this process uses (several processes on "
                         "one host). Default: all local devices.")
    pl.add_argument("--collective-timeout", type=float, default=300.0,
                    help="Multi-process: seconds a device step may stall "
                         "before the watchdog exits the process for "
                         "supervised restart (resume from the jplace "
                         "sidecar with --resume).")
    pl.add_argument("input_file", type=_existing_path)

    df = sub.add_parser(
        "diff", help="Semantic diff of two jplace files.",
        description="Semantic diff of two jplace files (the parity oracle, "
                    "reference: scripts/jplace_diff.py).")
    df.add_argument("jplace1", type=_existing_path)
    df.add_argument("jplace2", type=_existing_path)
    df.add_argument("--only-best", action="store_true")

    pr = sub.add_parser(
        "probe", help="Diagnose an .ipk file's layout.",
        description="Diagnose an .ipk file's layout (field-by-field walk + "
                    "hexdumps): prints every field of the reconstructed "
                    "layout with its byte offset under both 64- and 32-bit "
                    "size_t conventions, the failure site, and landmark "
                    "scans (see io/ipk_boost.py::probe_ipk).")
    pr.add_argument("database", type=_existing_path)

    cv = sub.add_parser(
        "convert", help="Convert a database between .ipk and .eptk.",
        description="Convert a database between .ipk (reconstructed Boost "
                    "layout, UNVERIFIED -- see io/ipk_boost.py) and the "
                    "native .eptk format.")
    cv.add_argument("src", type=_existing_path)
    cv.add_argument("dst")

    st = sub.add_parser(
        "stats", help="Print database parameters.",
        description="Print database parameters (the driver's stdout block, "
                    "reference: main.cpp:285-292) without placing anything.")
    st.add_argument("database", type=_existing_path)

    bd = sub.add_parser(
        "build-db", formatter_class=fmt,
        help="Build a .eptk database from explicit phylo-k-mer scores.",
        description="Build a .eptk database from explicit phylo-k-mer "
                    "scores. Database construction from alignments is IPK's "
                    "job (out of scope for the reference placement tool "
                    "too, reference README.md:113); this command packages "
                    "externally computed phylo-k-mer scores.")
    bd.add_argument("--tree", dest="tree_file", required=True,
                    type=_existing_path, help="Reference tree (newick).")
    bd.add_argument("--entries", dest="entries_file", required=True,
                    type=_existing_path,
                    help="JSON file: {kmer: [[branch, log10_score], ...], ...}.")
    bd.add_argument("-k", "--kmer-size", type=int, required=True)
    bd.add_argument("--omega", type=float, default=1.5)
    bd.add_argument("-s", "--states", choices=["nucl", "amino"],
                    default="nucl")
    bd.add_argument("output")

    pp = sub.add_parser(
        "ppdiff", help="Two-implementation differential harness.",
        description="Two-implementation differential harness (the pattern "
                    "of reference: scripts/ppdiff.py).")
    pp.add_argument("--config", type=_existing_path, default=None,
                    help="JSON case config (default: built-in cases)")
    pp.add_argument("--workdir", default=None,
                    help="Work directory (default: a directory under the "
                         "system temp dir)")
    return ap


def main(argv: list[str] | None = None) -> int:
    """Run one ``epik`` subcommand; returns the process exit code."""
    args = _parser().parse_args(argv)
    return _COMMANDS[args.command](args)


def _cmd_place(a) -> int:
    if a.platform:
        import jax

        jax.config.update("jax_platforms", a.platform)
    if a.engine in ("jax", "sharded"):
        from ..utils.compile_cache import configure_compile_cache

        configure_compile_cache()
    return place_queries(
        a.database, a.states, a.omega, a.mu, a.outputdir, a.threads,
        a.max_ram, a.input_file, batch_size=a.batch_size,
        keep_at_most=a.keep_at_most, keep_factor=a.keep_factor,
        engine=a.engine, resume=a.resume, verbose=a.verbose,
        profile_dir=a.profile_dir, n_model=a.n_model, inflight=a.inflight,
        precision=a.precision, plane_mode=a.plane_mode,
        pair_plane=a.pair_plane, tile_payload=a.tile_payload,
        coordinator=a.coordinator, num_processes=a.num_processes,
        process_id=a.process_id, local_devices=a.local_devices,
        collective_timeout=a.collective_timeout,
    )


class _SkippingReader:
    """Reader adapter that skips the first n already-placed records (resume)."""

    def __init__(self, reader, skip: int):
        self._reader = reader
        self._skip = skip
        self._pending: list | None = None

    def next_batch(self):
        if self._pending is not None:
            out, self._pending = self._pending, None
            return out
        while True:
            batch = self._reader.next_batch()
            if not batch or self._skip == 0:
                return batch
            if len(batch) <= self._skip:
                self._skip -= len(batch)
                continue
            out = batch[self._skip :]
            self._skip = 0
            return out

    def bytes_read(self):
        return self._reader.bytes_read()


def make_invocation(argv: list[str]) -> str:
    """argv joined with a trailing space (reference: main.cpp:23-32)."""
    return "".join(a + " " for a in argv)


def make_output_filename(input_file: str, output_dir: str) -> str:
    """placements_<input filename>.jplace (reference: main.cpp:34-37)."""
    return os.path.join(output_dir, "placements_" + os.path.basename(input_file) + ".jplace")


def place_queries(database, states, omega, mu, outputdir, threads, max_ram,
                  input_file, batch_size=2000, keep_at_most=7, keep_factor=0.01,
                  engine="jax", invocation=None, resume=False, verbose=False,
                  profile_dir=None, n_model=1, inflight=3, precision="exact",
                  plane_mode="shifted", pair_plane="auto",
                  tile_payload="auto", coordinator=None, num_processes=None,
                  process_id=None, local_devices=None,
                  collective_timeout=300.0) -> int:
    """Full pipeline orchestration (reference: main.cpp:237-383)."""
    if not (0.0 <= mu <= 1.0):
        _err("Error: Mu has to a value in [0, 1]")
        return -1

    max_entries = None
    if max_ram:
        try:
            max_bytes = parse_human_readable(max_ram)
        except ValueError as e:
            _err(f"Error: {e}")
            return -1
        max_entries = max_bytes // PKDB_VALUE_SIZE
        if max_entries == 0:
            _err("Error: Memory limit is too low")
            return -1
        print(
            f"Max-RAM provided: will be loaded not more than "
            f"{to_human_readable(max_entries)} phylo-k-mers."
        )

    print(f"Loading database with mu={mu:g} and omega={omega:g}...")
    try:
        db = load(database, mu=mu, user_omega=omega, max_entries=max_entries)
    except ValueError as e:
        _err(f"Error: {e}")
        return -1

    if db.sequence_type != states:
        _err(
            f"Error: database is {db.sequence_type} but -s {states} was requested"
        )
        return -1

    print("Database parameters:")
    print(f"\tSequence type: {db.sequence_type}")
    print(f"\tk: {db.kmer_size}")
    print(f"\tomega: {db.omega:g}")
    print(f"\tPositions loaded: {'true' if db.positions_loaded else 'false'}")
    print("")
    print(
        f"Loaded {to_human_readable(db.get_num_entries_loaded())} of "
        f"{to_human_readable(db.get_num_entries_total())} phylo-k-mers. "
    )
    print("")

    tree = parse_newick(db.tree())
    if engine == "reference":
        from ..engine.reference import ReferencePlacer

        placer = ReferencePlacer(db, tree, keep_at_most=keep_at_most, keep_factor=keep_factor)
        engine_name = "scalar (oracle)"
    elif engine == "native":
        # CPU-only deployments: the C++ scalar placer with the reference's
        # -j/--threads OpenMP placement loop (place.cpp:218-229) as a full
        # engine -- no JAX device required
        from ..native import NativePlacer

        placer = NativePlacer(db, tree, keep_at_most=keep_at_most,
                              keep_factor=keep_factor,
                              threads=max(1, threads))
        engine_name = f"native C++ scalar (-j {max(1, threads)})"
    elif engine == "sharded":
        import jax

        from ..engine.placer import PlacerConfig
        from ..parallel.mesh import init_distributed, make_mesh
        from ..parallel.sharding import ShardedJaxPlacer

        if coordinator or num_processes:
            # multi-process launch: one CLI invocation per process, a shared
            # coordinator, one global mesh (SURVEY.md section 5.8 --
            # green-field vs the single-process reference)
            init_distributed(coordinator, num_processes=num_processes,
                             process_id=process_id,
                             initialization_timeout=collective_timeout,
                             local_device_ids=local_devices)
        mesh = make_mesh(n_model=n_model)
        cfg = PlacerConfig(host_threads=max(1, threads), precision=precision,
                           plane_mode=plane_mode, pair_plane=pair_plane,
                           tile_payload=tile_payload)
        placer = ShardedJaxPlacer(db, tree, mesh, keep_at_most=keep_at_most,
                                  keep_factor=keep_factor, config=cfg)
        engine_name = (
            f"jax/{jax.default_backend()} sharded mesh "
            f"{mesh.shape['data']}x{mesh.shape['model']}"
        )
    else:
        from ..engine.placer import JaxPlacer, PlacerConfig

        cfg = PlacerConfig(host_threads=max(1, threads), precision=precision,
                           plane_mode=plane_mode, pair_plane=pair_plane,
                           tile_payload=tile_payload)
        placer = JaxPlacer(db, tree, keep_at_most=keep_at_most,
                           keep_factor=keep_factor, config=cfg)
        import jax

        engine_name = (
            f"jax/{jax.default_backend()} ({len(jax.devices())} device(s)), "
            f"path: {placer.path_name}"
        )

    tree_as_newick = to_newick(tree, jplace_edges=True)
    jplace_filename = make_output_filename(input_file, outputdir)
    if invocation is None:
        invocation = make_invocation(sys.argv)
    total_fasta_size = os.path.getsize(input_file)

    writer = jplace_writer(jplace_filename, invocation, tree_as_newick, resume=resume)
    writer.start()
    if writer.resumed_reads:
        print(f"Resuming: {writer.resumed_reads} reads already placed.")

    print(f"Engine: {engine_name}")  # analog of print_intruction_set (main.cpp:50-63)
    print(f"Placing {input_file}...")

    bar = ProgressBar(total_fasta_size)
    begin = time.monotonic()

    # prefer the native C++ FASTA reader when the library is built
    # (the Python reader handles gzip; the native one does not)
    reader = None
    with open(input_file, "rb") as _probe:
        is_gzip = _probe.read(2) == b"\x1f\x8b"
    if not is_gzip:
        try:
            from ..native import NativeFastaReader, native_available

            if native_available():
                reader = NativeFastaReader(input_file, batch_size)
        except Exception:
            reader = None
    if reader is None:
        reader = batch_fasta(input_file, batch_size)
    if writer.resumed_reads:
        reader = _SkippingReader(reader, writer.resumed_reads)

    def progress(seq_per_second, num_seq_placed, bytes_read):
        bar.update(
            bytes_read,
            prefix=f"{to_human_readable(seq_per_second)} seq/s ",
            postfix=f"{num_seq_placed} / ?",
        )

    from ..engine.pipeline import run_pipeline

    # multi-host: a dead peer leaves this process blocked inside an XLA
    # collective; the watchdog turns that into a STALL_EXIT_CODE exit so a
    # supervisor can restart every rank with --resume (the per-batch
    # jplace sidecar makes restart cheap; parallel/mesh.py)
    dog = None
    if num_processes and num_processes > 1:
        from ..parallel.mesh import BatchWatchdog

        dog = BatchWatchdog(collective_timeout, rank=process_id)
        inner_place = placer.place

        class _Guarded:
            def place(self, batch):
                dog.arm(f"batch of {len(batch)}")
                try:
                    return inner_place(batch)
                finally:
                    dog.disarm()

        guarded = _Guarded()
        guarded_placer, placer = placer, guarded
    if profile_dir:
        import jax

        jax.profiler.start_trace(profile_dir)
    try:
        stats = run_pipeline(placer, reader, writer, progress=progress,
                             inflight=inflight)
    finally:
        if dog is not None:
            dog.stop()
        if profile_dir:
            import jax

            jax.profiler.stop_trace()
    writer.end()
    if verbose:
        print(f"Pipeline: {stats.summary()}")

    bar.update(reader.bytes_read(), prefix="Done. ",
               postfix=to_human_readable(stats.num_seq_placed))
    bar.finish()

    print(
        f"Placed {stats.num_seq_placed} sequences.\n"
        f"Average speed: {to_human_readable(stats.average_speed)} seq/s."
    )
    print(f"Output: {jplace_filename}")
    placement_time = int((time.monotonic() - begin) * 1000)
    print(f"Placement time: {humanize_time(placement_time)} ({placement_time} ms)")
    print("Done.")
    return 0


def _cmd_diff(a) -> int:
    from ..tools.jplace_diff import jplace_diff

    res = jplace_diff(a.jplace1, a.jplace2, only_best=a.only_best)
    for m in res.mismatches[:200]:
        print(m)
    print(f"\n{res.num_matches}/{res.num_seqs} placements match.")
    return 0 if res.clean else 1


def _cmd_probe(a) -> int:
    from ..io.ipk_boost import probe_ipk

    print(probe_ipk(a.database))
    return 0


def _cmd_convert(a) -> int:
    from ..io.db import load, save
    from ..io.ipk_boost import UnverifiedFormatError, read_ipk, write_ipk

    src, dst = a.src, a.dst
    if src.endswith(".eptk"):
        db = load(src)
    else:
        try:
            db = read_ipk(src)
        except UnverifiedFormatError as e:
            _err(f"Error reading {src}: {e}")
            _err(
                "Note: the .ipk reader implements a reconstructed layout; the "
                "i2l serialization source was unavailable. Re-export with IPK "
                "or use .eptk."
            )
            return 1
    if dst.endswith(".ipk"):
        write_ipk(db, dst)
    else:
        save(db, dst)
    print(
        f"Converted {src} -> {dst}: {db.num_kmers} k-mers, "
        f"{db.num_entries} entries, k={db.kmer_size}, {db.sequence_type}"
    )
    return 0


def _cmd_stats(a) -> int:
    db = load(a.database)
    print("Database parameters:")
    print(f"\tSequence type: {db.sequence_type}")
    print(f"\tk: {db.kmer_size}")
    print(f"\tomega: {db.omega:g}")
    print(f"\tPositions loaded: {'true' if db.positions_loaded else 'false'}")
    print(f"\tk-mers: {db.num_kmers}")
    print(f"\tEntries: {to_human_readable(db.get_num_entries_total())}")
    print(f"\tMax posting list: {db.max_posting_len()}")
    tree = parse_newick(db.tree())
    print(f"\tTree: {len(tree.leaves())} leaves, {tree.get_node_count()} nodes")
    return 0


def _cmd_build_db(a) -> int:
    import json

    from ..io.build import build_db
    from ..io.db import save

    with open(a.entries_file) as f:
        raw = json.load(f)
    entries = {k: [(int(b), float(sc)) for b, sc in v] for k, v in raw.items()}
    with open(a.tree_file) as f:
        newick = f.read().strip()
    db = build_db(entries, newick, kmer_size=a.kmer_size, omega=a.omega,
                  sequence_type=a.states)
    save(db, a.output)
    print(f"Wrote {a.output}: {db.num_kmers} k-mers, {db.num_entries} entries")
    return 0


def _cmd_ppdiff(a) -> int:
    from ..tools.ppdiff import main as ppdiff_main

    args = []
    if a.workdir:
        args += ["--workdir", a.workdir]
    if a.config:
        args += ["--config", a.config]
    return ppdiff_main(args)


_COMMANDS = {
    "place": _cmd_place,
    "diff": _cmd_diff,
    "probe": _cmd_probe,
    "convert": _cmd_convert,
    "stats": _cmd_stats,
    "build-db": _cmd_build_db,
    "ppdiff": _cmd_ppdiff,
}


if __name__ == "__main__":
    sys.exit(main())
