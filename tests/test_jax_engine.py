"""Differential tests: JAX device engine vs the faithful scalar oracle.

The two-implementation differential pattern of the reference's test strategy
(reference: scripts/ppdiff.py:235-255; SURVEY.md section 4).  Match criterion
mirrors jplace parity: same edges, |10**ll1 - 10**ll2| <= 1e-4
(reference: scripts/jplace_diff.py:21,222), plus count equality (counts are
integers and must agree exactly).
"""

import numpy as np
import pytest

from epik_tpu.core.tree import parse_newick
from epik_tpu.engine.placer import JaxPlacer
from epik_tpu.engine.reference import ReferencePlacer
from epik_tpu.io.build import build_db, random_db, random_reads

EPSILON = 1e-4
TREE = "((A:0.1,B:0.2):0.3,C:0.4):0.0;"


def assert_equivalent(out_ref, out_jax, check_wr=True):
    assert set(out_ref.sequence_map) == set(out_jax.sequence_map)
    ref_by_seq = {p.sequence: p for p in out_ref.placed_seqs}
    jax_by_seq = {p.sequence: p for p in out_jax.placed_seqs}
    assert set(ref_by_seq) == set(jax_by_seq)
    for seq, rp in ref_by_seq.items():
        jp = jax_by_seq[seq]
        r_edges = {p.branch_id: p for p in rp.placements}
        j_edges = {p.branch_id: p for p in jp.placements}
        assert set(r_edges) == set(j_edges), (
            f"edge sets differ for {seq!r}: ref={sorted(r_edges)} jax={sorted(j_edges)}"
        )
        for e, p_ref in r_edges.items():
            p_jax = j_edges[e]
            assert abs(10.0**p_ref.score - 10.0**p_jax.score) <= EPSILON, (
                f"{seq!r} edge {e}: ll {p_ref.score} vs {p_jax.score}"
            )
            if p_jax.count >= 0:  # shifted-plane mode reports counts as -1
                assert p_ref.count == p_jax.count, f"{seq!r} edge {e} count"
            if check_wr:
                assert p_ref.weight_ratio == pytest.approx(
                    p_jax.weight_ratio, rel=1e-3, abs=1e-6
                ), f"{seq!r} edge {e} wr"
            assert p_ref.distal_length == pytest.approx(p_jax.distal_length)
            assert p_ref.pendant_length == pytest.approx(p_jax.pendant_length)


def assert_jplace_close(out_ref, out_jax, eps=1e-4):
    """The project's acceptance-oracle semantics (tools/jplace_diff.py):
    score SETS almost-equal per sequence -- tolerates near-tie edge swaps
    at the keep-at-most cut, which f32 reordering can produce on fixtures
    with genuine ties (docs/QUIRKS.md)."""
    ref_by = {q.sequence: q.placements for q in out_ref.placed_seqs}
    jax_by = {q.sequence: q.placements for q in out_jax.placed_seqs}
    assert set(ref_by) == set(jax_by)
    for seq, rp in ref_by.items():
        sa = sorted(q.score for q in rp)
        sb = sorted(q.score for q in jax_by[seq])
        assert len(sa) == len(sb) and all(
            abs(x - y) <= eps for x, y in zip(sa, sb)
        ), f"{seq!r}: score sets diverge beyond the oracle epsilon"


def both_engines(db, **kw):
    tree = parse_newick(db.tree())
    return ReferencePlacer(db, tree, **kw), JaxPlacer(db, tree, **kw)


class TestToyDifferential:
    @pytest.fixture
    def db(self):
        return build_db(
            {"ACG": [(0, -1.0), (2, -2.0)], "CGT": [(1, -0.5)]},
            TREE,
            kmer_size=3,
        )

    def test_exact(self, db):
        ref, jax_p = both_engines(db)
        recs = [("r1", b"ACGT"), ("r2", b"TACGT"), ("r3", b"CGTACG")]
        assert_equivalent(ref.place(recs), jax_p.place(recs))

    def test_ambiguous(self, db):
        ref, jax_p = both_engines(db)
        recs = [("a", b"ACRT"), ("b", b"NCGT"), ("c", b"ANGT"), ("d", b"RYSWKM")]
        assert_equivalent(ref.place(recs), jax_p.place(recs))

    def test_fallback_and_short(self, db):
        ref, jax_p = both_engines(db)
        recs = [("nohit", b"TTTT"), ("lenk1", b"AC"), ("tiny", b"A"), ("empty", b"")]
        assert_equivalent(ref.place(recs), jax_p.place(recs))

    def test_dedup(self, db):
        ref, jax_p = both_engines(db)
        recs = [("x", b"ACGT"), ("y", b"ACGT"), ("z", b"ACGT")]
        out_r, out_j = ref.place(recs), jax_p.place(recs)
        assert out_j.sequence_map[b"ACGT"] == ["x", "y", "z"]
        assert_equivalent(out_r, out_j)

    def test_keep_at_most(self, db):
        ref, jax_p = both_engines(db, keep_at_most=2)
        recs = [("r", b"ACGT")]
        assert_equivalent(ref.place(recs), jax_p.place(recs))

    def test_keep_factor(self, db):
        ref, jax_p = both_engines(db, keep_factor=0.5)
        recs = [("r", b"ACGT")]
        assert_equivalent(ref.place(recs), jax_p.place(recs))


class TestRandomDifferential:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_reads(self, seed):
        db = random_db(num_leaves=24, kmer_size=6, num_kmers=2048, seed=seed)
        ref, jax_p = both_engines(db)
        # reads assembled from DB k-mers so most windows hit
        rng = np.random.default_rng(seed + 100)
        from epik_tpu.core.alphabet import DNA

        recs = []
        for i in range(40):
            parts = [
                DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 6)
                for _ in range(rng.integers(1, 8))
            ]
            recs.append((f"q{i}", "".join(parts).encode()))
        assert_equivalent(ref.place(recs), jax_p.place(recs))

    def test_random_with_ambiguity(self):
        db = random_db(num_leaves=24, kmer_size=6, num_kmers=2048, seed=9)
        ref, jax_p = both_engines(db)
        reads = random_reads(30, length=40, seed=5, ambig_rate=0.05)
        assert_equivalent(ref.place(reads), jax_p.place(reads))

    def test_pure_random_reads(self):
        # mostly misses: exercises correction with small C and the fallback
        db = random_db(num_leaves=16, kmer_size=8, num_kmers=512, seed=3)
        ref, jax_p = both_engines(db)
        reads = random_reads(30, length=60, seed=6)
        assert_equivalent(ref.place(reads), jax_p.place(reads))

    def test_amino(self):
        db = random_db(
            num_leaves=16, kmer_size=4, num_kmers=2000, seed=4, sequence_type="amino"
        )
        ref, jax_p = both_engines(db)
        from epik_tpu.core.alphabet import AMINO

        rng = np.random.default_rng(11)
        recs = []
        for i in range(25):
            parts = [
                AMINO.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 4)
                for _ in range(rng.integers(1, 6))
            ]
            recs.append((f"p{i}", "".join(parts).encode()))
        recs.append(("amb", b"ABCDEFX"))  # amino ambiguity codes
        assert_equivalent(ref.place(recs), jax_p.place(recs))

    def test_budget_overflow_retry(self):
        # tiny initial budget forces the grow-and-retry path
        db = random_db(num_leaves=24, kmer_size=6, num_kmers=2048, mean_posting_len=20.0, seed=8)
        from epik_tpu.engine.placer import PlacerConfig

        tree = parse_newick(db.tree())
        cfg = PlacerConfig(budget_headroom=0.01)
        jax_p = JaxPlacer(db, tree, config=cfg)
        ref = ReferencePlacer(db, tree)
        from epik_tpu.core.alphabet import DNA

        rng = np.random.default_rng(13)
        recs = [
            (
                f"q{i}",
                "".join(
                    DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 6)
                    for _ in range(6)
                ).encode(),
            )
            for i in range(10)
        ]
        assert_equivalent(ref.place(recs), jax_p.place(recs))


class TestMatmulAccumulate:
    """The f32 segment accumulate (ops/accumulate.py) and the CSR
    scatter-add path (dense planes off, host tokenize)."""

    def test_segment_accumulate_kernel(self):
        import jax.numpy as jnp

        from epik_tpu.ops.accumulate import segment_sums, trash_branch

        rng = np.random.default_rng(0)
        R, PP, B = 8, 512, 300
        trash = trash_branch(B)
        b = rng.integers(0, B, size=(R, PP)).astype(np.int32)
        s = rng.uniform(-2, 0, size=(R, PP)).astype(np.float32)
        nvalid = rng.integers(0, PP, size=R)
        for r in range(R):
            b[r, nvalid[r]:] = trash
            s[r, nvalid[r]:] = 0.0
        S = np.asarray(segment_sums(jnp.asarray(b), jnp.asarray(s), B))
        assert S.shape == (R, B)
        for r in range(R):
            expect_s = np.zeros(B, np.float32)
            for c in range(nvalid[r]):
                expect_s[b[r, c]] += s[r, c]
            np.testing.assert_allclose(S[r], expect_s, rtol=1e-5, atol=1e-5)

    def _matmul_placer(self, db, **kw):
        from epik_tpu.core.tree import parse_newick
        from epik_tpu.engine.placer import JaxPlacer, PlacerConfig

        tree = parse_newick(db.tree())
        cfg = PlacerConfig(dense_db="off", tokenize_where="host")
        p = JaxPlacer(db, tree, config=cfg, **kw)
        assert not p._dense_db and not p._tiles_mode
        return p

    def test_matches_oracle(self):
        db = random_db(num_leaves=24, kmer_size=6, num_kmers=2048, seed=23)
        from epik_tpu.core.tree import parse_newick

        ref = ReferencePlacer(db, parse_newick(db.tree()))
        jax_p = self._matmul_placer(db)
        rng = np.random.default_rng(24)
        from epik_tpu.core.alphabet import DNA

        recs = []
        for i in range(20):
            parts = [
                DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 6)
                for _ in range(rng.integers(1, 6))
            ]
            recs.append((f"q{i}", "".join(parts).encode()))
        recs += [("amb", b"ANGTCA"), ("nohit", b"TTTTTT"), ("short", b"AC")]
        assert_equivalent(ref.place(recs), jax_p.place(recs))

    def test_pp_overflow_retry(self):
        db = random_db(num_leaves=24, kmer_size=6, num_kmers=1024,
                       mean_posting_len=24.0, seed=26)
        from epik_tpu.core.tree import parse_newick
        from epik_tpu.engine.placer import JaxPlacer, PlacerConfig

        tree = parse_newick(db.tree())
        cfg = PlacerConfig(dense_db="off", tokenize_where="host",
                           budget_headroom=0.01)
        jax_p = JaxPlacer(db, tree, config=cfg)
        ref = ReferencePlacer(db, tree)
        rng = np.random.default_rng(27)
        from epik_tpu.core.alphabet import DNA

        recs = [
            (
                f"q{i}",
                "".join(
                    DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 6)
                    for _ in range(8)
                ).encode(),
            )
            for i in range(6)
        ]
        assert_equivalent(ref.place(recs), jax_p.place(recs))
        assert jax_p.overflow_retries > 0


class TestDenseDB:
    """Dense-plane database mode: row-gather accumulation."""

    def _dense_placer(self, db, **kw):
        from epik_tpu.engine.placer import JaxPlacer, PlacerConfig

        tree = parse_newick(db.tree())
        cfg = PlacerConfig(dense_db="on")
        return JaxPlacer(db, tree, config=cfg, **kw), tree

    def test_matches_oracle(self):
        db = random_db(num_leaves=24, kmer_size=6, num_kmers=2048, seed=33)
        jax_p, tree = self._dense_placer(db)
        assert jax_p._dense_db
        ref = ReferencePlacer(db, tree)
        rng = np.random.default_rng(34)
        from epik_tpu.core.alphabet import DNA

        recs = []
        for i in range(30):
            parts = [
                DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 6)
                for _ in range(rng.integers(1, 8))
            ]
            recs.append((f"q{i}", "".join(parts).encode()))
        recs += [("amb", b"ANGTCA" * 2), ("nohit", b"T" * 12), ("short", b"AC"),
                 ("manyN", b"NCGTNA" * 4)]
        assert_equivalent(ref.place(recs), jax_p.place(recs))

    def test_random_ambiguity(self):
        db = random_db(num_leaves=20, kmer_size=5, num_kmers=800, seed=35)
        jax_p, tree = self._dense_placer(db)
        ref = ReferencePlacer(db, tree)
        reads = random_reads(25, length=30, seed=36, ambig_rate=0.12)
        assert_equivalent(ref.place(reads), jax_p.place(reads))

    def test_amino_dense(self):
        db = random_db(num_leaves=12, kmer_size=4, num_kmers=900, seed=37,
                       sequence_type="amino")
        jax_p, tree = self._dense_placer(db)
        ref = ReferencePlacer(db, tree)
        from epik_tpu.core.alphabet import AMINO

        rng = np.random.default_rng(38)
        recs = [
            (
                f"p{i}",
                "".join(
                    AMINO.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 4)
                    for _ in range(4)
                ).encode(),
            )
            for i in range(12)
        ]
        recs.append(("ambX", b"ACDXFGHI"))
        assert_equivalent(ref.place(recs), jax_p.place(recs))

    def test_auto_selects_dense_for_small_db(self):
        from epik_tpu.engine.placer import JaxPlacer

        db = random_db(num_leaves=16, kmer_size=6, num_kmers=512, seed=39)
        tree = parse_newick(db.tree())
        p = JaxPlacer(db, tree)  # auto
        assert p._dense_db  # tiny planes always fit the default budget

    def test_off_switch(self):
        from epik_tpu.engine.placer import JaxPlacer, PlacerConfig

        db = random_db(num_leaves=16, kmer_size=6, num_kmers=512, seed=40)
        tree = parse_newick(db.tree())
        p = JaxPlacer(db, tree, config=PlacerConfig(dense_db="off"))
        assert not p._dense_db


class TestDeviceTokenize:
    """The device-tokenize fast path (raw bytes in, rows computed on chip)."""

    def test_fast_path_selected_for_dna(self):
        from epik_tpu.engine.placer import JaxPlacer, PlacerConfig

        db = random_db(num_leaves=16, kmer_size=6, num_kmers=512, seed=70)
        tree = parse_newick(db.tree())
        p = JaxPlacer(db, tree)
        assert p._fast_bytes  # DNA, k<=13, dense planes fit
        p_host = JaxPlacer(db, tree, config=PlacerConfig(tokenize_where="host"))
        assert not p_host._fast_bytes

    def test_not_selected_for_amino_or_large_k(self):
        from epik_tpu.engine.placer import JaxPlacer

        db = random_db(num_leaves=12, kmer_size=4, num_kmers=400, seed=71,
                       sequence_type="amino")
        tree = parse_newick(db.tree())
        assert not JaxPlacer(db, tree)._fast_bytes

    def test_matches_host_tokenize_and_oracle(self):
        from epik_tpu.engine.placer import JaxPlacer, PlacerConfig

        db = random_db(num_leaves=24, kmer_size=6, num_kmers=2048, seed=72)
        tree = parse_newick(db.tree())
        dev = JaxPlacer(db, tree)
        host = JaxPlacer(db, tree, config=PlacerConfig(tokenize_where="host"))
        ref = ReferencePlacer(db, tree)
        assert dev._fast_bytes and not host._fast_bytes
        reads = random_reads(40, length=35, seed=73, ambig_rate=0.10)
        # edge cases: short read, all-miss read, lowercase, mixed lengths,
        # a read with an invalid character, and a duplicate (quirk Q8)
        reads += [
            ("short", b"AC"),
            ("nohit", b"T" * 18),
            ("lower", b"acgtacgtacgt"),
            ("longer", b"ACGT" * 30),
            ("badchar", b"ACG-TACGTACG"),
            ("dup", reads[0][1]),
        ]
        out_dev = dev.place(reads)
        assert_equivalent(ref.place(reads), out_dev)
        assert_equivalent(host.place(reads), out_dev)

    def test_no_cuckoo_table_built_on_fast_path(self):
        from epik_tpu.engine.placer import JaxPlacer

        db = random_db(num_leaves=16, kmer_size=6, num_kmers=512, seed=74)
        tree = parse_newick(db.tree())
        p = JaxPlacer(db, tree)
        reads = random_reads(10, length=30, seed=75)
        p.place(reads)
        assert p._table is None  # lazy: never probed, never built

    def test_all_short_batch_falls_back(self):
        from epik_tpu.engine.placer import JaxPlacer

        db = random_db(num_leaves=16, kmer_size=6, num_kmers=512, seed=76)
        tree = parse_newick(db.tree())
        p = JaxPlacer(db, tree)
        ref = ReferencePlacer(db, tree)
        reads = [("a", b"ACG"), ("b", b"C")]  # every read shorter than k
        assert_equivalent(ref.place(reads), p.place(reads))


class TestHostThreads:
    def test_threaded_tokenize_matches(self):
        from epik_tpu.engine.placer import JaxPlacer, PlacerConfig

        db = random_db(num_leaves=16, kmer_size=6, num_kmers=512, seed=44)
        tree = parse_newick(db.tree())
        p1 = JaxPlacer(db, tree)
        p4 = JaxPlacer(db, tree, config=PlacerConfig(host_threads=4))
        reads = random_reads(40, length=30, seed=45, ambig_rate=0.05)
        assert_equivalent(p1.place(reads), p4.place(reads))


class TestBf16FastMode:
    def test_bf16_top_edges_close(self):
        from epik_tpu.engine.placer import JaxPlacer, PlacerConfig

        db = random_db(num_leaves=24, kmer_size=6, num_kmers=2048, seed=61)
        tree = parse_newick(db.tree())
        exact = JaxPlacer(db, tree, config=PlacerConfig(dense_db="on"))
        fast = JaxPlacer(db, tree, config=PlacerConfig(dense_db="on", precision="bf16"))
        rng = np.random.default_rng(62)
        from epik_tpu.core.alphabet import DNA

        recs = [
            (
                f"q{i}",
                "".join(
                    DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 6)
                    for _ in range(6)
                ).encode(),
            )
            for i in range(30)
        ]
        o1, o2 = exact.place(recs), fast.place(recs)
        agree = 0
        for p1, p2 in zip(o1.placed_seqs, o2.placed_seqs):
            if p1.placements and p2.placements:
                agree += p1.placements[0].branch_id == p2.placements[0].branch_id
                # scores agree to bf16 precision
                assert p1.placements[0].score == pytest.approx(
                    p2.placements[0].score, rel=2e-2, abs=2e-2
                )
        assert agree >= 28  # best edge stable for nearly all reads


class TestReviewRegressions:
    """Regression tests for the round-1 code-review findings."""

    def test_dense_zero_score_branch_not_dropped(self):
        # a stored log10 score of exactly 0.0 (P == 1) must still count as
        # present in the dense plane (review finding: the subnormal nudge
        # underflowed to -0.0)
        from epik_tpu.engine.placer import JaxPlacer, PlacerConfig

        db = build_db(
            {"ACGTA": [(0, 0.0), (2, -1.5)], "CGTAC": [(1, -0.5)]},
            TREE, kmer_size=5,
        )
        tree = parse_newick(db.tree())
        ref = ReferencePlacer(db, tree)
        dense = JaxPlacer(db, tree, config=PlacerConfig(dense_db="on"))
        recs = [("r", b"ACGTAC")]
        out_r = ref.place(recs)
        out_d = dense.place(recs)
        edges_r = {p.branch_id for p in out_r.placed_seqs[0].placements}
        edges_d = {p.branch_id for p in out_d.placed_seqs[0].placements}
        assert 0 in edges_d
        assert edges_r == edges_d
        # scores still within parity tolerance despite the -1e-37 nudge
        assert_equivalent(out_r, out_d)

    def test_device_fn_args_small_batch(self):
        # review finding: device_fn_args must stage a runnable CSR step
        # for a small batch
        import jax as _jax

        from epik_tpu.engine.placer import JaxPlacer, PlacerConfig

        db = random_db(num_leaves=16, kmer_size=6, num_kmers=512, seed=71)
        tree = parse_newick(db.tree())
        placer = JaxPlacer(db, tree, config=PlacerConfig(
            dense_db="off", tokenize_where="host"))
        fn, args = placer.device_fn_args([("a", b"ACGTACGTAC"), ("b", b"TTTACGTTTT")])
        out = _jax.jit(fn)(*args)
        _jax.block_until_ready(out)

    def test_config_not_clobbered(self):
        from epik_tpu.engine.placer import JaxPlacer, PlacerConfig
        from epik_tpu.parallel.mesh import make_mesh
        from epik_tpu.parallel.sharding import ShardedJaxPlacer

        db = random_db(num_leaves=16, kmer_size=6, num_kmers=512, seed=72)
        tree = parse_newick(db.tree())
        cfg = PlacerConfig(keep_at_most=3, keep_factor=0.5)
        p = JaxPlacer(db, tree, config=cfg)
        assert p.config.keep_at_most == 3 and p.config.keep_factor == 0.5
        # caller's object untouched
        assert cfg.keep_at_most == 3
        # explicit kwargs still win over the config copy
        p2 = JaxPlacer(db, tree, keep_at_most=2, config=cfg)
        assert p2.config.keep_at_most == 2 and cfg.keep_at_most == 3
        mesh = make_mesh(n_data=4, n_model=2)
        sp = ShardedJaxPlacer(db, tree, mesh, config=cfg)
        assert sp.config.keep_at_most == 3 and cfg.keep_at_most == 3

    def test_unpack_outputs_large_totals_exact(self):
        import jax.numpy as jnp

        from epik_tpu.engine.placer import _pack_outputs, unpack_outputs

        K, R = 7, 4
        outs = (
            jnp.zeros((R, K)), jnp.zeros((R, K), jnp.int32),
            jnp.zeros((R, K), jnp.int32), jnp.zeros((R, K)),
            jnp.zeros(R, jnp.int32), jnp.zeros(R, bool),
        )
        # a total above 2**24 must round-trip exactly (review finding:
        # single-f32 packing rounded and could skip the overflow retry)
        big = 16_777_219  # 2**24 + 3
        packed = _pack_outputs(outs, jnp.int32(big), jnp.int32(big + 1))
        *_, e_total, a_total = unpack_outputs(np.asarray(packed), K)
        assert e_total == big and a_total == big + 1


class TestShiftedPlane:
    """plane_mode="shifted": single-reduce scoring (counts reported as -1).

    The count term of the correction cancels algebraically when the plane
    stores s - log10(eps); scores must stay inside the 1e-4 probability-
    space gate vs the oracle on every fixture class (exact, ambiguous,
    no-match fallback, short reads)."""

    @pytest.fixture
    def db(self):
        return random_db(num_leaves=24, kmer_size=6, num_kmers=2048, seed=121)

    def _shifted_placer(self, db):
        from epik_tpu.engine.placer import PlacerConfig

        tree = parse_newick(db.tree())
        cfg = PlacerConfig(plane_mode="shifted", dense_db="on")
        p = JaxPlacer(db, tree, config=cfg)
        assert p._shifted, "fixture must take the shifted plane path"
        return p

    def test_matches_oracle_mixed(self, db):
        tree = parse_newick(db.tree())
        reads = random_reads(48, length=30, seed=122, ambig_rate=0.1)
        reads += [("nohit", b"T" * 25), ("short", b"AC"), ("amb", b"ANGTCA" * 4)]
        out_ref = ReferencePlacer(db, tree).place(reads)
        out_jax = self._shifted_placer(db).place(reads)
        assert_equivalent(out_ref, out_jax)

    def test_counts_are_sentinel(self, db):
        reads = random_reads(8, length=30, seed=123)
        out = self._shifted_placer(db).place(reads)
        counted = [
            p.count for ps in out.placed_seqs for p in ps.placements
        ]
        assert counted and all(c == -1 for c in counted)

    def test_boundary_scores_survive(self):
        """Stored scores of exactly 0.0 (P == 1) and exactly log10(eps)
        (the threshold boundary) must still place correctly."""
        import numpy as np

        from epik_tpu.core.scoring import log10_score_threshold
        from epik_tpu.engine.placer import PlacerConfig

        log_eps = float(np.float32(log10_score_threshold(1.5, 3, 4)))
        db = build_db(
            {"ACG": [(0, 0.0), (2, log_eps)], "CGT": [(1, -0.5)]},
            TREE, kmer_size=3,
        )
        tree = parse_newick(db.tree())
        cfg = PlacerConfig(plane_mode="shifted", dense_db="on")
        p = JaxPlacer(db, tree, config=cfg)
        assert p._shifted
        out_ref = ReferencePlacer(db, tree).place([("r", b"ACGT")])
        out_jax = p.place([("r", b"ACGT")])
        assert_equivalent(out_ref, out_jax)

    def test_below_threshold_scores_disable_shifted(self):
        """A database with stored scores below log10(eps) (impossible via
        the load contract, possible in hand-built fixtures) must fall back
        to classic scoring -- the shift only cancels above the threshold."""
        from epik_tpu.engine.placer import PlacerConfig

        db = build_db(
            {"ACG": [(0, 0.0), (2, -2.0)], "CGT": [(1, -0.5)]},
            TREE, kmer_size=3,
        )
        tree = parse_newick(db.tree())
        cfg = PlacerConfig(plane_mode="shifted", dense_db="on")
        p = JaxPlacer(db, tree, config=cfg)
        assert not p._shifted
        out_ref = ReferencePlacer(db, tree).place([("r", b"ACGT")])
        out_jax = p.place([("r", b"ACGT")])
        assert_equivalent(out_ref, out_jax)


class TestInt16Plane:
    """precision="int16": quantized shifted plane, exact int32 accumulation.

    Worst-case per-cell quantization error is (-log_eps)/64000 log10 units;
    summed over a read's windows and divided by k it stays far inside the
    1e-4 probability-space gate (and inside assert_equivalent's wr
    tolerance) on every fixture class."""

    def _placer(self, db):
        import jax.numpy as jnp

        from epik_tpu.engine.placer import PlacerConfig

        tree = parse_newick(db.tree())
        cfg = PlacerConfig(precision="int16", dense_db="on")
        p = JaxPlacer(db, tree, config=cfg)
        assert p._shifted and p._plane_q, "fixture must take the int16 plane"
        assert p._plane_s.dtype == jnp.int16
        return p

    def test_matches_oracle_mixed(self):
        db = random_db(num_leaves=24, kmer_size=6, num_kmers=2048, seed=141)
        tree = parse_newick(db.tree())
        reads = random_reads(48, length=30, seed=142, ambig_rate=0.1)
        reads += [("nohit", b"T" * 25), ("short", b"AC"), ("amb", b"ANGTCA" * 4)]
        out_ref = ReferencePlacer(db, tree).place(reads)
        out_jax = self._placer(db).place(reads)
        assert_equivalent(out_ref, out_jax)

    def test_boundary_scores_survive(self):
        """Exact 0.0 (P == 1) and exact log10(eps) stored scores quantize to
        the top / bottom (>= 1) of the grid and still place correctly."""
        import numpy as np

        from epik_tpu.core.scoring import log10_score_threshold

        log_eps = float(np.float32(log10_score_threshold(1.5, 3, 4)))
        db = build_db(
            {"ACG": [(0, 0.0), (2, log_eps)], "CGT": [(1, -0.5)]},
            TREE, kmer_size=3,
        )
        tree = parse_newick(db.tree())
        out_ref = ReferencePlacer(db, tree).place([("r", b"ACGT")])
        out_jax = self._placer(db).place([("r", b"ACGT")])
        assert_equivalent(out_ref, out_jax)

    def test_int16_implies_shifted_without_flag(self):
        """precision="int16" alone (plane_mode left classic) still routes to
        the shifted plane -- the quantized domain is [0, -log_eps]."""
        from epik_tpu.engine.placer import PlacerConfig

        db = random_db(num_leaves=24, kmer_size=6, num_kmers=2048, seed=143)
        tree = parse_newick(db.tree())
        cfg = PlacerConfig(precision="int16", plane_mode="classic", dense_db="on")
        p = JaxPlacer(db, tree, config=cfg)
        assert p._shifted and p._plane_q

    def test_long_read_no_overflow(self):
        """A long read (many windows) keeps the int32 accumulator exact and
        matches the oracle."""
        db = random_db(num_leaves=24, kmer_size=6, num_kmers=3000, seed=144)
        tree = parse_newick(db.tree())
        reads = random_reads(2, length=3000, seed=145)
        out_ref = ReferencePlacer(db, tree).place(reads)
        out_jax = self._placer(db).place(reads)
        assert_equivalent(out_ref, out_jax)

    def test_nanopore_length_mix(self):
        """A mixed 1.5-3 kb batch (nanopore-shaped, SURVEY.md section 5.7)
        matches the oracle through the default engine, and the coarse Lmax
        bucketing keeps the jit cache bounded across jittered batches."""
        from epik_tpu.engine.placer import _bucket_lmax
        from epik_tpu.io.build import reads_from_reference, reference_like_db

        # short regime keeps the 8-multiple; long regime coarsens to ~1/8
        assert _bucket_lmax(150) == 152 and _bucket_lmax(512) == 512
        for L in (513, 2000, 6345, 9999):
            b = _bucket_lmax(L)
            assert b >= L and b % 8 == 0 and (b - L) <= L / 7
        # jittered long batches share a bucket (bounded compile count)
        assert len({_bucket_lmax(L) for L in range(6000, 6400)}) <= 2

        db, ref = reference_like_db(num_leaves=24, kmer_size=6,
                                    ref_length=20_000, mean_posting_len=6.0,
                                    seed=146)
        tree = parse_newick(db.tree())
        reads = reads_from_reference(ref, 6, mutation_rate=0.05, seed=147,
                                     length_range=(1500, 3000))
        reads += [("tail", reads[0][1][:40])]  # short read in the same batch
        out_ref = ReferencePlacer(db, tree).place(reads)
        out_jax = self._placer(db).place(reads)
        assert_equivalent(out_ref, out_jax)


class TestPairPlane:
    """pair_plane: one (k+1)-mer row gather per two windows (bytes path).

    The pair table enumerates every suffix extension of every DB key, so a
    pair miss implies at most one of the two windows hits -- each 2-window
    slot needs exactly one gather and summed scores are identical up to one
    f32 rounding per pair cell."""

    def _fixture(self):
        from epik_tpu.io.build import reads_from_reference, reference_like_db

        db, ref = reference_like_db(num_leaves=48, kmer_size=8,
                                    ref_length=30_000, mean_posting_len=6.0,
                                    seed=31)
        tree = parse_newick(db.tree())
        reads = reads_from_reference(ref, 60, length=101, mutation_rate=0.05,
                                     seed=32)
        reads += reads_from_reference(ref, 10, length=80, mutation_rate=0.4,
                                      seed=33)
        reads += [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:]),
                  ("short", b"AC"), ("nohit", b"T" * 30)]
        return db, tree, reads

    def test_matches_oracle(self):
        """Acceptance at the project's own oracle semantics (jplace_diff):
        per-edge in probability space, with the score-set fallback that
        tolerates near-tie edge swaps at the keep-at-most cut (the pair
        cells round once at build, reordering f32 additions ~1e-6)."""
        db, tree, reads = self._fixture()
        p = JaxPlacer(db, tree)
        assert p._paired, "fixture must activate the pair plane"
        assert p._plane_s.shape[0] > db.num_kmers + 1
        out_ref = ReferencePlacer(db, tree).place(reads)
        assert_jplace_close(out_ref, p.place(reads))

    def test_zero_row_stays_at_n_keys(self):
        """Combined layout keeps the all-zero row at index n_keys so every
        miss sentinel (host rows matrix, direct table, padding) is valid."""
        db, tree, _ = self._fixture()
        p = JaxPlacer(db, tree)
        assert p._paired
        assert not np.asarray(p._plane_s[db.num_kmers]).any()

    def test_off_and_incompatible_modes(self):
        from epik_tpu.engine.placer import PlacerConfig

        db, tree, reads = self._fixture()
        off = JaxPlacer(db, tree, config=PlacerConfig(pair_plane="off"))
        assert not off._paired
        q = JaxPlacer(db, tree, config=PlacerConfig(precision="int16"))
        assert not q._paired  # int16 pair rows would overflow the grid
        tiny = JaxPlacer(db, tree, config=PlacerConfig(pair_plane_budget=(
            (db.num_kmers + 2) * 128 * 4)))
        assert tiny._dense_db and not tiny._paired  # combined over budget
        out_ref = ReferencePlacer(db, tree).place(reads)
        assert_jplace_close(out_ref, off.place(reads))

    def test_odd_window_count(self):
        """Odd W leaves a trailing single-window slot."""
        db, tree, _ = self._fixture()
        p = JaxPlacer(db, tree)
        assert p._paired
        reads = [("odd", b"ACGTACGTACGTACGT")]  # 16 chars, k=8 -> W=9 (odd)
        out_ref = ReferencePlacer(db, tree).place(reads)
        assert_equivalent(out_ref, p.place(reads))


class TestAminoCodesPath:
    """Generic-alphabet device path: on-device limb tokenization + radix-
    index lookup (ops/radix_lookup.py) -- the amino analog of the DNA
    bytes fast path."""

    def _fixture(self, k=6, seed=21):
        from epik_tpu.io.build import reads_from_reference, reference_like_db

        db, ref = reference_like_db(num_leaves=48, kmer_size=k,
                                    ref_length=20_000, mean_posting_len=6.0,
                                    sequence_type="amino", seed=seed)
        tree = parse_newick(db.tree())
        reads = reads_from_reference(ref, 60, length=90, mutation_rate=0.04,
                                     sequence_type="amino", seed=seed + 1)
        reads += [("amb", reads[0][1][:30] + b"X" + reads[0][1][31:]),
                  ("ambB", b"B" + reads[1][1][:50]),
                  ("short", b"AC"), ("nohit", b"W" * 40)]
        return db, tree, reads

    def test_matches_oracle(self):
        db, tree, reads = self._fixture()
        p = JaxPlacer(db, tree)
        assert p._fast_codes, "amino fixture must take the codes fast path"
        out_ref = ReferencePlacer(db, tree).place(reads)
        assert_equivalent(out_ref, p.place(reads))

    def test_k9_wide_keys(self):
        """k=9 amino keys are 39 bits: limb tokenization + shift > 16."""
        db, tree, reads = self._fixture(k=9, seed=41)
        p = JaxPlacer(db, tree)
        assert p._fast_codes and p._radix.shift > 16
        out_ref = ReferencePlacer(db, tree).place(reads)
        assert_equivalent(out_ref, p.place(reads))

    def test_matches_host_path(self):
        """Device codes path and forced host tokenize produce identical
        placements (same plane, same math, different lookup site)."""
        from epik_tpu.engine.placer import PlacerConfig

        db, tree, reads = self._fixture()
        dev = JaxPlacer(db, tree)
        host = JaxPlacer(db, tree, config=PlacerConfig(tokenize_where="host"))
        assert dev._fast_codes and not host._fast_codes
        assert_equivalent(host.place(reads), dev.place(reads))

    def test_pair_plane_opt_in_matches_unpaired(self):
        """The amino pair plane (pair radix over sorted (k+1)-mer keys,
        one row gather per two windows) measured SLOWER than unpaired on
        chip (round 4) and is opt-in; when forced on it must stay inside
        the oracle epsilon of the default path."""
        from epik_tpu.engine.placer import PlacerConfig

        db, tree, reads = self._fixture()
        p_pair = JaxPlacer(db, tree, config=PlacerConfig(pair_plane="on"))
        assert p_pair._paired_codes and p_pair._n_pairs > 0
        p_single = JaxPlacer(db, tree)
        assert p_single._fast_codes and not p_single._paired_codes
        out_pair = p_pair.place(reads)
        assert_jplace_close(p_single.place(reads), out_pair)
        assert_jplace_close(ReferencePlacer(db, tree).place(reads), out_pair)

    def test_radix_lookup_exact(self):
        """radix_lookup vs np.searchsorted on random uint64 keys."""
        import jax.numpy as jnp

        from epik_tpu.ops.radix_lookup import build_radix, radix_lookup

        rng = np.random.default_rng(3)
        key_bits = 39
        keys = np.unique(rng.integers(0, 1 << key_bits, 5000, dtype=np.uint64))
        idx = build_radix(keys, key_bits)
        queries = np.concatenate([
            keys[rng.integers(0, keys.size, 2000)],
            rng.integers(0, 1 << key_bits, 2000, dtype=np.uint64),
        ])
        a = (queries >> np.uint64(16)).astype(np.uint32)
        b = (queries & np.uint64(0xFFFF)).astype(np.uint32)
        assert not idx.packed  # shift 21 > 15: the classic probe path
        off, low = idx.device_arrays()
        got = np.asarray(radix_lookup(off, low, jnp.asarray(a), jnp.asarray(b),
                                      shift=idx.shift, n_probe=idx.max_bucket,
                                      n_keys=keys.size))
        pos = np.searchsorted(keys, queries)
        pos_c = np.minimum(pos, keys.size - 1)
        want = np.where(keys[pos_c] == queries, pos_c, keys.size)
        np.testing.assert_array_equal(got, want)

    def test_radix_lookup_packed_exact(self):
        """The packed 3-gather lookup (round 4) vs np.searchsorted; narrow
        keys so shift <= 15 and max_bucket <= 3 enable the packed gate."""
        import jax.numpy as jnp

        from epik_tpu.ops.radix_lookup import build_radix, radix_lookup_packed

        rng = np.random.default_rng(7)
        key_bits = 30
        keys = np.unique(rng.integers(0, 1 << key_bits, 20000,
                                      dtype=np.uint64))
        idx = build_radix(keys, key_bits, allow_split=False)
        assert idx.packed, (idx.shift, idx.max_bucket)
        queries = np.concatenate([
            keys[rng.integers(0, keys.size, 3000)],
            rng.integers(0, 1 << key_bits, 3000, dtype=np.uint64),
            keys[:2], keys[-2:],  # boundary positions incl. the pad word
        ])
        a = (queries >> np.uint64(16)).astype(np.uint32)
        b = (queries & np.uint64(0xFFFF)).astype(np.uint32)
        offc, low2 = idx.device_arrays()
        got = np.asarray(radix_lookup_packed(
            offc, low2, jnp.asarray(a), jnp.asarray(b),
            shift=idx.shift, off_bits=idx.off_bits, n_keys=keys.size))
        pos = np.searchsorted(keys, queries)
        pos_c = np.minimum(pos, keys.size - 1)
        want = np.where(keys[pos_c] == queries, pos_c, keys.size)
        np.testing.assert_array_equal(got, want)

    def test_radix_lookup_lp_exact(self):
        """The low-pair-overlap 2-gather lookup (round 5) vs
        np.searchsorted, at key widths spanning shift 0..11 (incl. the
        amino-k=8 width 35, where the third low's top bits spill into
        v1)."""
        import jax.numpy as jnp

        from epik_tpu.ops.radix_lookup import build_radix, radix_lookup_lp

        rng = np.random.default_rng(11)
        for key_bits, n_gen in ((35, 120000), (30, 20000), (18, 4000)):
            keys = np.unique(rng.integers(0, 1 << key_bits, n_gen,
                                          dtype=np.uint64))
            idx = build_radix(keys, key_bits)
            assert idx.lowpair, (key_bits, idx.lp_shift)
            if key_bits == 35:
                assert idx.lp_shift == 11  # exercises the spill-bit path
                counts = np.bincount((keys >> np.uint64(11)).astype(np.int64))
                assert counts.max() >= 3  # 3-key buckets present
            queries = np.concatenate([
                keys[rng.integers(0, keys.size, 3000)],
                rng.integers(0, 1 << key_bits, 3000, dtype=np.uint64),
                keys[:2], keys[-2:],
            ])
            a = (queries >> np.uint64(16)).astype(np.uint32)
            b = (queries & np.uint64(0xFFFF)).astype(np.uint32)
            v1, lp = idx.device_arrays()
            got = np.asarray(radix_lookup_lp(
                v1, lp, jnp.asarray(a), jnp.asarray(b),
                shift=idx.lp_shift, nb=idx.lp_nb, n_keys=keys.size))
            pos = np.searchsorted(keys, queries)
            pos_c = np.minimum(pos, keys.size - 1)
            want = np.where(keys[pos_c] == queries, pos_c, keys.size)
            np.testing.assert_array_equal(got, want)


class TestTilesPath:
    """Posting-tile plane (the big-tree fast path): one row gather per
    window from (n_keys+1, PT) tiles + the scatter-add accumulate
    (ops/accumulate.py).  The tiles gate opens on DB shape and memory
    alone: any DNA database whose dense plane is off takes it."""

    def _fixture(self):
        from epik_tpu.io.build import reads_from_reference, reference_like_db

        db, ref = reference_like_db(num_leaves=96, kmer_size=10,
                                    ref_length=40_000, mean_posting_len=6.0,
                                    seed=71)
        tree = parse_newick(db.tree())
        reads = reads_from_reference(ref, 50, length=121, mutation_rate=0.05,
                                     seed=72)
        reads += reads_from_reference(ref, 6, length=80, mutation_rate=0.4,
                                      seed=73)
        reads += [("short", b"AC"), ("nohit", b"T" * 30)]
        return db, tree, reads

    def _placer(self, db, tree, **kw):
        from epik_tpu.engine.placer import PlacerConfig

        cfg = PlacerConfig(dense_db="off", **kw)
        p = JaxPlacer(db, tree, config=cfg)
        assert p._tiles_mode, "fixture must take the tiles path"
        return p

    def test_matches_oracle(self):
        db, tree, reads = self._fixture()
        p = self._placer(db, tree)
        # the round-5 two-level split engages on this length distribution
        out = p.place(reads)
        assert p._tile_pt_ov > 0, (p._tile_pt, p._tile_pt_ov)
        out_ref = ReferencePlacer(db, tree).place(reads)
        assert_jplace_close(out_ref, out)

    def test_long_reads_leave_packed_tiles(self):
        """W * 64000 >= 2**31 (padded reads of 33.6k+ windows) would
        overflow the packed payload's int32 sums; such batches must take
        the classic CSR fallback and still match the oracle, while 400 bp
        reads stay on the tiles path."""
        from epik_tpu.io.build import reads_from_reference, reference_like_db

        db, ref = reference_like_db(num_leaves=48, kmer_size=10,
                                    ref_length=40_000, mean_posting_len=6.0,
                                    seed=75)
        tree = parse_newick(db.tree())
        p = self._placer(db, tree)
        reads = reads_from_reference(ref, 2, length=400,
                                     mutation_rate=0.05, seed=77)
        assert p._stage_bytes([s for _, s in reads]) is not None
        long_reads = reads_from_reference(ref, 2, length=34_000,
                                          mutation_rate=0.05, seed=76)
        assert p._stage_bytes([s for _, s in long_reads]) is None
        # probability space (the jplace_diff yardstick): f32 sums over 34k
        # windows legitimately differ ~1e-3 in log space between summation
        # orders at scores ~ -14000, which are identically 0 as
        # probabilities
        ref = ReferencePlacer(db, tree)
        want = {q.sequence: q.placements for q in ref.place(long_reads).placed_seqs}
        for q in p.place(long_reads).placed_seqs:
            sa = sorted(10.0 ** x.score for x in want[q.sequence])
            sb = sorted(10.0 ** x.score for x in q.placements)
            assert len(sa) == len(sb)
            assert all(abs(x - y) <= 1e-4 for x, y in zip(sa, sb))
        assert_jplace_close(ref.place(reads), p.place(reads))

    def test_two_level_overflow_retry(self):
        """A read whose windows hit overflow keys far beyond the static OV
        budget must be caught by the reported per-read count, re-dispatched
        with a bigger budget, and still match the oracle (round-5
        two-level tiles; exactness-by-retry like the CSR posting
        budgets)."""
        from epik_tpu.core.alphabet import DNA
        from epik_tpu.io.build import build_db

        rng = np.random.default_rng(201)
        k = 6
        hot = "".join("ACGT"[i] for i in rng.integers(0, 4, 80))
        entries = {}
        for w in range(len(hot) - k + 1):
            # 17 postings: len > any plausible PT_main, forcing overflow
            # scores above log10(eps) ~= -2.56 (the shift_ok load contract)
            entries.setdefault(hot[w : w + k], [
                (int(b), float(s)) for b, s in zip(
                    rng.permutation(60)[:17],
                    rng.uniform(-2.4, -0.5, 17))
            ])
        filler = set()
        while len(filler) < 2000:
            filler.add(DNA.decode_key(int(rng.integers(0, 4**k)), k))
        for f in filler:
            if f not in entries:
                entries[f] = [(int(rng.integers(0, 60)), -1.0)]
        nwk = "(" + ",".join(f"L{i}:0.1" for i in range(60)) + ");"
        db = build_db(entries, nwk, kmer_size=k)
        tree = parse_newick(db.tree())
        p = self._placer(db, tree)
        reads = [("hot", hot.encode()),
                 ("cold", DNA.decode_key(3, k).encode() * 10)]
        out = p.place(reads)
        assert p._tile_pt_ov > 0
        assert p.overflow_retries > 0, (
            "hot read failed to exceed the OV budget",
            p._tile_pt, p._tile_pt_ov)
        assert_jplace_close(ReferencePlacer(db, tree).place(reads), out)

    def test_amb_batch_splits_tiles_plus_csr(self):
        """A batch containing ambiguous reads SPLITS: clean reads stay on
        the tiles path, ambiguous reads take the classic CSR path, and the
        merged batch matches the oracle (round-4 rework of the old
        whole-batch CSR fallback)."""
        from epik_tpu.engine.placer import _SplitPending

        db, tree, reads = self._fixture()
        p = self._placer(db, tree)
        reads = reads[:8] + [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:]),
                             ("amb2", reads[1][1][:3] + b"R" + reads[1][1][4:])]
        pending = p.place_async(reads)
        assert isinstance(pending, _SplitPending)
        assert len(pending.idx_amb) == 2 and len(pending.idx_clean) == 8
        out_ref = ReferencePlacer(db, tree).place(reads)
        assert_jplace_close(out_ref, p.place_wait(pending))

    def test_all_amb_batch_falls_back_whole(self):
        """Every read ambiguous: no split, whole batch on the classic path."""
        db, tree, reads = self._fixture()
        p = self._placer(db, tree)
        amb = [("a1", reads[0][1][:40] + b"N" + reads[0][1][41:]),
               ("a2", reads[1][1][:10] + b"Y" + reads[1][1][11:])]
        out_ref = ReferencePlacer(db, tree).place(amb)
        assert_jplace_close(out_ref, p.place(amb))

    def test_threshold_boundary_score_places(self):
        """A posting at exactly log10(eps) shifts to the nudged epsilon and
        must still be reported (touched)."""
        db, tree, _ = self._fixture()
        import numpy as np

        # force one posting to the exact threshold
        db.scores[0] = np.float32(
            np.log10(np.float32(1.5 / 4) ** db.kmer_size)
        )
        p = self._placer(db, tree)
        from epik_tpu.core.alphabet import DNA

        read = DNA.decode_key(int(db.keys[0]), db.kmer_size).encode()
        out_ref = ReferencePlacer(db, tree).place([("r", read)])
        assert_jplace_close(out_ref, p.place([("r", read)]))

    def test_f32_payload_matches_oracle(self):
        """tile_payload='f32' (the bit-exact round-3 layout) stays live."""
        db, tree, reads = self._fixture()
        p = self._placer(db, tree, tile_payload="f32")
        assert not p._tile_packed
        out_ref = ReferencePlacer(db, tree).place(reads)
        assert_jplace_close(out_ref, p.place(reads))

    def test_packed_payload_selected_and_matches_f32(self):
        """Default 'auto' selects the packed int32 payload (branch ids fit
        15 bits) and its quantized scores stay inside the oracle epsilon
        of the exact-f32 payload."""
        db, tree, reads = self._fixture()
        p_packed = self._placer(db, tree)
        assert p_packed._tile_packed
        p_f32 = self._placer(db, tree, tile_payload="f32")
        assert_jplace_close(p_f32.place(reads), p_packed.place(reads))

    def test_pair_fused_tiles_match_unpaired(self):
        """Pair-fused tile rows (one gather per two windows) match the
        per-window packed path and the oracle."""
        db, tree, reads = self._fixture()
        p_pair = self._placer(db, tree, pair_plane="on")
        p_pair.place(reads[:2])  # trigger lazy tile build
        assert p_pair._tile_paired
        p_single = self._placer(db, tree)
        p_single.place(reads[:2])
        assert not p_single._tile_paired
        out_pair = p_pair.place(reads)
        assert_jplace_close(p_single.place(reads), out_pair)
        assert_jplace_close(ReferencePlacer(db, tree).place(reads), out_pair)

    def test_packed_rejects_wide_branch_ids(self):
        from epik_tpu.engine.placer import PlacerConfig
        from epik_tpu.io.build import random_db

        db = random_db(num_leaves=20000, kmer_size=10, num_kmers=64,
                       mean_posting_len=4.0, seed=75, unique_branches=False)
        tree = parse_newick(db.tree())
        with pytest.raises(ValueError, match="tile_payload"):
            JaxPlacer(db, tree, config=PlacerConfig(
                dense_db="off", tile_payload="packed"))

    def test_hot_kmer_disables_tiles(self):
        """max posting length > 128 falls back (tile width would blow up;
        round 5 raised the cap from 64 -- the two-level split keeps the
        main plane slim regardless of the max), while a 64 < max <= 128 DB
        now TAKES the tiles path and still matches the oracle."""
        from epik_tpu.engine.placer import PlacerConfig
        from epik_tpu.io.build import random_db

        db = random_db(num_leaves=80, kmer_size=8, num_kmers=512,
                       mean_posting_len=60.0, seed=74)
        max_plen = int(np.diff(db.row_off).max())
        assert 64 < max_plen <= 128
        tree = parse_newick(db.tree())
        p = JaxPlacer(db, tree, config=PlacerConfig(dense_db="off"))
        assert p._tiles_mode
        reads = random_reads(20, length=40, seed=75)
        out = p.place(reads)
        assert p._tile_pt_ov > 0  # heavy tail engages the two-level split
        assert_jplace_close(ReferencePlacer(db, tree).place(reads), out)

        lens = np.diff(db.row_off)
        hot = np.argmax(lens)
        import dataclasses
        extra = 130 - int(lens[hot])
        rng = np.random.default_rng(76)
        B = tree.get_node_count()
        ins = int(db.row_off[hot + 1])
        db2 = dataclasses.replace(
            db,
            row_off=np.concatenate(
                [db.row_off[: hot + 1], db.row_off[hot + 1 :] + extra]
            ),
            branches=np.insert(db.branches, ins,
                               rng.permutation(B)[:extra].astype(np.uint32)),
            scores=np.insert(db.scores, ins,
                             np.full(extra, -1.0, np.float32)),
            num_entries_total=db.num_entries_total + extra,
            num_entries_loaded=db.num_entries_loaded + extra,
        )
        assert int(np.diff(db2.row_off).max()) > 128
        p2 = JaxPlacer(db2, tree, config=PlacerConfig(dense_db="off"))
        assert not p2._tiles_mode


class TestClassicPlane:
    """plane_mode="classic" (exact per-branch counts) stays oracle-matched
    now that the default is shifted."""

    def test_matches_oracle_mixed(self):
        from epik_tpu.engine.placer import PlacerConfig

        db = random_db(num_leaves=24, kmer_size=6, num_kmers=2048, seed=131)
        tree = parse_newick(db.tree())
        reads = random_reads(48, length=30, seed=132, ambig_rate=0.1)
        reads += [("nohit", b"T" * 25), ("short", b"AC")]
        cfg = PlacerConfig(plane_mode="classic", dense_db="on")
        p = JaxPlacer(db, tree, config=cfg)
        assert not p._shifted
        out_ref = ReferencePlacer(db, tree).place(reads)
        out_jax = p.place(reads)
        assert_equivalent(out_ref, out_jax)
        counts = [q.count for ps in out_jax.placed_seqs for q in ps.placements]
        assert counts and all(c >= 0 for c in counts)


class TestComboTable:
    """device_tokenize_combo (one gather per slot) must reproduce
    device_tokenize_paired (three table passes) slot-for-slot, including
    mixed-validity slots: odd window counts, read tails, interior Ns."""

    def test_equivalence_random(self):
        import jax.numpy as jnp

        from epik_tpu.engine.placer import (
            build_combo_table,
            device_tokenize_combo,
            device_tokenize_paired,
            pack_reads,
        )
        from epik_tpu.core.alphabet import DNA
        from epik_tpu.io.build import reference_like_db

        db, ref = reference_like_db(num_leaves=32, kmer_size=5,
                                    ref_length=4_000, mean_posting_len=4.0,
                                    seed=13)
        k = 5
        n = db.num_kmers
        direct = np.full(4**k, n, np.int32)
        direct[db.keys.astype(np.int64)] = np.arange(n, dtype=np.int32)
        # pair tables from the same enumeration the placer uses
        from epik_tpu.engine.placer import enumerate_pairs

        pu, pv, key11 = enumerate_pairs(db.keys, k, direct, n)
        direct11 = np.full(4 ** (k + 1), -1, np.int32)
        direct11[key11] = n + 1 + np.arange(pu.shape[0], dtype=np.int32)
        combo = build_combo_table(direct, direct11, k, n)

        rng = np.random.default_rng(4)
        letters = np.frombuffer(b"ACGTN", np.uint8)
        seqs = []
        ref_arr = np.frombuffer(ref, np.uint8)
        for i in range(40):
            L = int(rng.integers(1, 40))  # odd/even W, len < k tails
            start = int(rng.integers(0, len(ref_arr) - 40))
            s = bytearray(ref_arr[start : start + L])
            if i % 3 == 0 and L > 4:  # interior invalid char
                s[int(rng.integers(1, L - 1))] = ord("N")
            if i % 5 == 0:
                s = bytearray(letters[rng.integers(0, 5, L)].tobytes())
            seqs.append(bytes(s))
        lens = np.array([len(s) for s in seqs], np.int64)
        Lmax = int(-(-lens.max() // 8) * 8)
        R = len(seqs)
        flat = np.frombuffer(b"".join(seqs), np.uint8)
        starts = np.concatenate([[0], np.cumsum(lens)])
        mat = np.zeros((R, Lmax), np.uint8)
        mat[np.repeat(np.arange(R), lens),
            np.arange(flat.size) - np.repeat(starts[:-1], lens)] = flat
        codes = DNA.char_code[mat]
        buf = pack_reads(codes, lens)

        rows_ref, lens_ref = device_tokenize_paired(
            jnp.asarray(buf), jnp.asarray(direct), jnp.asarray(direct11),
            k=k, Lmax=Lmax, num_kmers=n)
        rows_new, lens_new = device_tokenize_combo(
            jnp.asarray(buf), jnp.asarray(combo), k=k, Lmax=Lmax,
            num_kmers=n)
        np.testing.assert_array_equal(np.asarray(lens_new),
                                      np.asarray(lens_ref))
        np.testing.assert_array_equal(np.asarray(rows_new),
                                      np.asarray(rows_ref))


def test_enumerate_pairs_generic_matches_dna():
    """enumerate_pairs_generic (searchsorted, any sigma) and
    enumerate_pairs (direct table, DNA) must produce the same pair SET on
    a DNA database (order differs: generic sorts by pair key)."""
    from epik_tpu.engine.placer import enumerate_pairs, enumerate_pairs_generic
    from epik_tpu.io.build import random_db

    db = random_db(num_leaves=16, kmer_size=6, num_kmers=800, seed=17)
    n = db.num_kmers
    direct = np.full(4**6, n, np.int32)
    direct[db.keys.astype(np.int64)] = np.arange(n, dtype=np.int32)
    pu_a, pv_a, k11_a = enumerate_pairs(db.keys, 6, direct, n)
    pu_b, pv_b, k11_b = enumerate_pairs_generic(db.keys, 6, 4)
    a = sorted(zip(k11_a.tolist(), pu_a.tolist(), pv_a.tolist()))
    b = sorted(zip(k11_b.tolist(), pu_b.tolist(), pv_b.tolist()))
    assert len(a) > 0 and a == b
