"""Parity verification on the live backend (the accelerator's gate).

Runs the built-in ppdiff differential cases (tools/ppdiff.py, meshes shrunk
to the available devices) plus a 300-read mixed workload -- db-derived
reads, ambiguity, duplicates, short and no-hit reads -- through every
single-device engine path and the 1x1 sharded engine, each diffed against
the scalar oracle (``ReferencePlacer``) with the project's acceptance
oracle (tools/jplace_diff.py: epsilon 1e-4 in probability space,
reference: scripts/jplace_diff.py:21,222).  On a GPU the f32 sums run in
another order than the oracle's sequential ones, so this is the gate for
any reduction-order divergence.

``chip_smoke.py`` calls :func:`verify`; on its own it prints one JSON line:

    {"verify": ..., "backend": ..., "cases_passed": N, "cases_total": N,
     "reads_matched": M, "reads_total": T, "ok": bool}

Usage: python -m epik_tpu.tools.verify [--workdir DIR]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile


def _mixed_case_reads(db, n=300):
    """Mixed workload: db-derived reads, mutations, ambiguity, quirk cases."""
    import numpy as np

    from ..core.alphabet import get_alphabet
    from ..io.build import random_reads

    alphabet = get_alphabet(db.sequence_type)
    rng = np.random.default_rng(99)
    reads = []
    for i in range(n - 20):
        parts = [
            alphabet.decode_key(int(db.keys[rng.integers(db.num_kmers)]), db.kmer_size)
            for _ in range(int(rng.integers(2, 16)))
        ]
        reads.append((f"q{i}", "".join(parts).encode()))
    reads += random_reads(10, length=80, seed=101, ambig_rate=0.1)
    # quirk cases: short reads (Q1), duplicates (Q8), no-hit (Q2/Q3)
    reads += [("short_a", b"AC"), ("short_b", b"A"),
              ("dup_1", b"ACGTACGTACGTACGT"), ("dup_2", b"ACGTACGTACGTACGT"),
              ("nohit", b"T" * 40)]
    return reads


def _diff_engines(tag, db, reads, engines, workdir, log):
    """Place ``reads`` with every engine, write jplace files and diff each
    against the first (the oracle); returns {name: (matched, total)}."""
    from ..core.tree import parse_newick, to_newick
    from ..io.jplace import jplace_writer
    from .jplace_diff import jplace_diff

    nwk = to_newick(parse_newick(db.tree()), jplace_edges=True)
    paths = {}
    for name, engine in engines:
        path = os.path.join(workdir, f"{tag}_{name}.jplace")
        w = jplace_writer(path, f"verify {tag} {name} ", nwk)
        w.start()
        w << engine.place(reads)
        w.end()
        paths[name] = path
    oracle = next(iter(paths.values()))
    out = {}
    for name in list(paths)[1:]:
        res = jplace_diff(oracle, paths[name])
        log(f"{tag} {name}: {res.num_matches}/{res.num_seqs} match")
        for m in res.mismatches[:5]:
            log(f"  {m}")
        out[name] = (res.num_matches, res.num_seqs)
    return out


def verify(workdir: str, log=print) -> dict:
    """Run the ppdiff cases and the mixed workloads; returns the summary
    (``ok`` is True only when every case and every read matched)."""
    import jax

    from ..core.tree import parse_newick
    from ..engine.placer import JaxPlacer, PlacerConfig
    from ..engine.reference import ReferencePlacer
    from ..io.build import random_db
    from ..parallel.mesh import make_mesh
    from ..parallel.sharding import ShardedJaxPlacer
    from .ppdiff import DEFAULT_CONFIG, run_case

    n_dev = len(jax.devices())
    os.makedirs(workdir, exist_ok=True)

    # --- built-in ppdiff cases (mesh shrunk to the available devices) --------
    cases_passed = 0
    cases = copy.deepcopy(DEFAULT_CONFIG["cases"])
    for case in cases:
        mesh = case.get("mesh")
        if mesh and mesh.get("n_data", 1) * mesh.get("n_model", 1) > n_dev:
            case["mesh"] = {"n_data": 1, "n_model": 1}
        clean, msg = run_case(case, workdir)
        log(("PASS " if clean else "FAIL ") + msg)
        cases_passed += int(clean)

    # --- 300-read mixed case: every engine path vs the scalar oracle ----------
    # the single-device placer on each of its paths (dense shifted with the
    # pair plane, classic, int16, posting tiles, CSR), and ShardedJaxPlacer
    # on a 1x1 mesh (its shard_map steps on one device)
    db = random_db(num_leaves=128, kmer_size=8, num_kmers=30000, seed=77)
    tree = parse_newick(db.tree())
    mesh11 = make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    tiles = PlacerConfig(dense_db="off")
    csr = PlacerConfig(dense_db="off", tokenize_where="host")
    engines = [
        ("oracle", ReferencePlacer(db, tree)),
        ("jax", JaxPlacer(db, tree)),
        ("jax_classic", JaxPlacer(db, tree,
                                  config=PlacerConfig(plane_mode="classic"))),
        ("jax_int16", JaxPlacer(db, tree,
                                config=PlacerConfig(precision="int16"))),
        ("jax_tiles", JaxPlacer(db, tree, config=tiles)),
        ("jax_csr", JaxPlacer(db, tree, config=csr)),
        ("sharded_1x1", ShardedJaxPlacer(db, tree, mesh11)),
        ("sharded_tiles_1x1", ShardedJaxPlacer(db, tree, mesh11, config=tiles)),
        ("sharded_csr_1x1", ShardedJaxPlacer(db, tree, mesh11, config=csr)),
    ]
    assert engines[4][1]._tiles_mode and not engines[5][1]._tiles_mode
    mixed = _diff_engines("mixed", db, _mixed_case_reads(db), engines,
                          workdir, log)

    # --- amino mixed case: device codes path (radix lookup) vs oracle --------
    amb_db = random_db(num_leaves=64, kmer_size=6, num_kmers=12000, seed=88,
                       sequence_type="amino")
    amb_tree = parse_newick(amb_db.tree())
    amb_engines = [
        ("oracle", ReferencePlacer(amb_db, amb_tree)),
        ("jax_amino", JaxPlacer(amb_db, amb_tree)),
        ("jax_amino_pair", JaxPlacer(amb_db, amb_tree,
                                     config=PlacerConfig(pair_plane="on"))),
    ]
    mixed.update(_diff_engines("amino", amb_db, _mixed_case_reads(amb_db),
                               amb_engines, workdir, log))

    matched = sum(m for m, _ in mixed.values())
    total = sum(t for _, t in mixed.values())
    return {
        "verify": "parity",
        "backend": jax.default_backend(),
        "cases_passed": cases_passed,
        "cases_total": len(cases),
        "reads_matched": matched,
        "reads_total": total,
        "mixed": {k: {"matched": m, "total": t} for k, (m, t) in mixed.items()},
        "ok": cases_passed == len(cases) and matched == total,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="parity verification")
    ap.add_argument("--workdir", default=None,
                    help="work directory (default: a fresh temp directory)")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="epik_verify_")
    summary = verify(workdir, log=lambda m: print(m, file=sys.stderr))
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
