"""Two-implementation differential harness (the reference's ppdiff pattern).

The reference's end-to-end test strategy runs two independent placement
implementations on the same inputs and semantically diffs their jplace
outputs, caching built databases between runs (reference:
scripts/ppdiff.py:77-92,235-255 -- there RAPPAS java vs RAPPAS2 C++; the
external tools are not cloneable, so the *pattern* is ported, not the code).

Here the implementation pairs are in-repo:

* ``jax``       -- the XLA engine (engine/placer.py)
* ``sharded``   -- the multi-device engine on a virtual mesh
* ``reference`` -- the faithful scalar oracle (engine/reference.py)
* ``native``    -- the C++ scalar placer scores (engine-level diff only)

Config-driven (JSON): each case declares a database fixture (seeded
synthetic or a file) and a query workload; databases are cached in the
work directory keyed by their config hash.

Determinism note: on CPU the XLA engine matches the scalar oracle exactly
on all built-in cases.  An accelerator may sum float32 in another order
than strict sequential addition, so reads whose 7th/8th-best branches are
near-ties could swap membership at the keep-at-most cut while every
reported score still agrees within the 1e-4 probability-space parity
tolerance.  The reference itself has unstable tie order
(std::partial_sort, reference: place.cpp:153-156).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile

import numpy as np

__all__ = ["run_case", "main", "DEFAULT_CONFIG"]

DEFAULT_CONFIG = {
    "cases": [
        {
            "name": "nucl-exact",
            "db": {"num_leaves": 64, "kmer_size": 8, "num_kmers": 20000, "seed": 1},
            "reads": {"n": 500, "from_db_kmers": True, "parts": 12, "seed": 2},
            "engines": ["reference", "jax"],
        },
        {
            "name": "nucl-ambiguous",
            "db": {"num_leaves": 48, "kmer_size": 6, "num_kmers": 4096, "seed": 3},
            "reads": {"n": 300, "length": 60, "ambig_rate": 0.08, "seed": 4},
            "engines": ["reference", "jax"],
        },
        {
            "name": "amino",
            "db": {"num_leaves": 32, "kmer_size": 4, "num_kmers": 4000, "seed": 5,
                    "sequence_type": "amino"},
            "reads": {"n": 200, "from_db_kmers": True, "parts": 5, "seed": 6},
            "engines": ["reference", "jax"],
        },
        {
            "name": "sharded-4x2",
            "db": {"num_leaves": 64, "kmer_size": 8, "num_kmers": 20000, "seed": 7},
            "reads": {"n": 400, "from_db_kmers": True, "parts": 10, "seed": 8},
            "engines": ["reference", "sharded"],
            "mesh": {"n_data": 4, "n_model": 2},
        },
    ]
}


def _case_hash(cfg: dict) -> str:
    return hashlib.sha256(json.dumps(cfg, sort_keys=True).encode()).hexdigest()[:16]


def _build_db(db_cfg: dict, workdir: str):
    from ..io.build import random_db
    from ..io.db import load, save

    key = _case_hash(db_cfg)
    path = os.path.join(workdir, f"db_{key}.eptk")
    if not os.path.exists(path):
        db = random_db(**db_cfg)
        save(db, path)
    return load(path)


def _make_reads(db, reads_cfg: dict):
    from ..core.alphabet import get_alphabet
    from ..io.build import random_reads

    rng = np.random.default_rng(reads_cfg.get("seed", 0))
    n = reads_cfg["n"]
    if reads_cfg.get("from_db_kmers"):
        alphabet = get_alphabet(db.sequence_type)
        parts = reads_cfg.get("parts", 10)
        out = []
        for i in range(n):
            idx = rng.integers(0, db.num_kmers, parts)
            s = "".join(alphabet.decode_key(int(db.keys[j]), db.kmer_size) for j in idx)
            out.append((f"q{i}", s.encode()))
        return out
    return random_reads(
        n,
        length=reads_cfg.get("length", 100),
        sequence_type=db.sequence_type,
        seed=reads_cfg.get("seed", 0),
        ambig_rate=reads_cfg.get("ambig_rate", 0.0),
    )


def _make_engine(name: str, db, tree, mesh_cfg=None):
    if name == "reference":
        from ..engine.reference import ReferencePlacer

        return ReferencePlacer(db, tree)
    if name == "jax":
        from ..engine.placer import JaxPlacer

        return JaxPlacer(db, tree)
    if name == "sharded":
        from ..parallel.mesh import make_mesh
        from ..parallel.sharding import ShardedJaxPlacer

        mesh = make_mesh(**(mesh_cfg or {}))
        return ShardedJaxPlacer(db, tree, mesh)
    raise ValueError(f"unknown engine {name!r}")


def run_case(case: dict, workdir: str) -> tuple[bool, str]:
    """Place with both engines, write jplace files, diff them."""
    from ..core.tree import parse_newick, to_newick
    from ..io.jplace import jplace_writer
    from .jplace_diff import jplace_diff

    os.makedirs(workdir, exist_ok=True)
    db = _build_db(case["db"], workdir)
    tree = parse_newick(db.tree())
    reads = _make_reads(db, case["reads"])
    nwk = to_newick(tree, jplace_edges=True)

    paths = []
    for engine_name in case["engines"]:
        engine = _make_engine(engine_name, db, tree, case.get("mesh"))
        out = engine.place(reads)
        path = os.path.join(workdir, f"{case['name']}_{engine_name}.jplace")
        w = jplace_writer(path, f"ppdiff {case['name']} {engine_name} ", nwk)
        w.start()
        w << out
        w.end()
        paths.append(path)

    res = jplace_diff(paths[0], paths[1])
    msg = f"{case['name']}: {res.num_matches}/{res.num_seqs} match"
    if not res.clean:
        msg += "\n  " + "\n  ".join(res.mismatches[:10])
    return res.clean, msg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="differential placement harness")
    ap.add_argument("--config", help="JSON config (default: built-in cases)")
    ap.add_argument("--workdir", default=None,
                    help="work directory (default: a fresh temp directory)")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="epik_ppdiff_")
    cfg = DEFAULT_CONFIG
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
    ok = True
    for case in cfg["cases"]:
        clean, msg = run_case(case, workdir)
        print(("PASS " if clean else "FAIL ") + msg)
        ok = ok and clean
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
