"""Multi-device tests on a virtual 8-CPU mesh (SURVEY.md section 4:
"multi-device without a cluster").

Differential gate: the sharded placer must match the scalar oracle for every
mesh shape, including hash-sharded databases where ambiguous first-hit
selection crosses shard boundaries.
"""

import numpy as np
import pytest

import jax

from epik_tpu.core.alphabet import DNA
from epik_tpu.core.tree import parse_newick
from epik_tpu.engine.reference import ReferencePlacer
from epik_tpu.io.build import random_db, random_reads
from epik_tpu.parallel.mesh import make_mesh
from epik_tpu.parallel.sharding import ShardedJaxPlacer, shard_db_by_hash

from test_jax_engine import assert_equivalent


@pytest.fixture(scope="module")
def db():
    return random_db(num_leaves=24, kmer_size=6, num_kmers=2048, seed=21)


@pytest.fixture(scope="module")
def reads(db):
    rng = np.random.default_rng(50)
    recs = []
    for i in range(48):
        parts = [
            DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 6)
            for _ in range(rng.integers(1, 6))
        ]
        recs.append((f"q{i}", "".join(parts).encode()))
    # ambiguity + edge cases
    recs += [("amb1", b"ANGTCA" * 3), ("nohit", b"T" * 20), ("short", b"AC")]
    recs += random_reads(8, length=30, seed=51, ambig_rate=0.1)
    return recs


def test_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"


def test_shard_assignment_balanced(db):
    from epik_tpu.parallel.sharding import _shard_of_key

    s = _shard_of_key(db.keys, 4)
    counts = np.bincount(s, minlength=4)
    assert counts.sum() == db.num_kmers
    assert counts.min() > db.num_kmers / 4 * 0.7  # roughly balanced


def test_shard_db_roundtrip(db):
    """Every key must be findable in exactly its own shard's table."""
    import jax.numpy as jnp

    from epik_tpu.ops.hashtable import lookup

    sdb = shard_db_by_hash(db, 4)
    total_found = 0
    hi = (db.keys >> np.uint64(32)).astype(np.uint32)
    lo = (db.keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    for s in range(4):
        table = jnp.asarray(sdb.packed[s])
        found, off, length = lookup(
            table, int(sdb.seeds[s][0]), int(sdb.seeds[s][1]),
            jnp.asarray(hi), jnp.asarray(lo),
        )
        total_found += int(np.asarray(found).sum())
    assert total_found == db.num_kmers  # each key in exactly one shard


@pytest.mark.parametrize("n_data,n_model", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_mesh_shapes_match_oracle(db, reads, n_data, n_model):
    from epik_tpu.engine.placer import PlacerConfig

    tree = parse_newick(db.tree())
    mesh = make_mesh(n_data=n_data, n_model=n_model)
    # dense_db off + host tokenize: pin the CSR scatter path (dense and
    # tiles have their own tests)
    sharded = ShardedJaxPlacer(db, tree, mesh, config=PlacerConfig(
        dense_db="off", tokenize_where="host"))
    assert not sharded._dense_db and not sharded._tiles_mode
    ref = ReferencePlacer(db, tree)
    assert_equivalent(ref.place(reads), sharded.place(reads))


@pytest.mark.parametrize("n_data,n_model", [(4, 2), (1, 8)])
def test_csr_dense_accumulate_matches_oracle(db, reads, n_data, n_model):
    """The CSR path with on-device tokenization (the hash-sharded scatter
    when neither the dense plane nor the tiles fit their budget) must
    match the oracle; ambiguous reads take the host-staged CSR step."""
    from epik_tpu.engine.placer import PlacerConfig

    tree = parse_newick(db.tree())
    mesh = make_mesh(n_data=n_data, n_model=n_model)
    sharded = ShardedJaxPlacer(
        db, tree, mesh, config=PlacerConfig(dense_db_budget=1024),
    )
    assert not sharded._dense_db and not sharded._tiles_mode
    ref = ReferencePlacer(db, tree)
    assert_equivalent(ref.place(reads), sharded.place(reads))


def test_fewer_reads_than_shards(db):
    tree = parse_newick(db.tree())
    mesh = make_mesh(n_data=8, n_model=1)
    sharded = ShardedJaxPlacer(db, tree, mesh)
    ref = ReferencePlacer(db, tree)
    recs = [("only", b"ACGTAC" * 4)]
    assert_equivalent(ref.place(recs), sharded.place(recs))


def test_amino_sharded():
    db = random_db(num_leaves=16, kmer_size=4, num_kmers=1500, seed=31,
                   sequence_type="amino")
    tree = parse_newick(db.tree())
    mesh = make_mesh(n_data=2, n_model=4)
    sharded = ShardedJaxPlacer(db, tree, mesh)
    ref = ReferencePlacer(db, tree)
    from epik_tpu.core.alphabet import AMINO

    rng = np.random.default_rng(41)
    recs = [
        (
            f"p{i}",
            "".join(
                AMINO.decode_key(int(db.keys[rng.integers(db.num_kmers)]), 4)
                for _ in range(4)
            ).encode(),
        )
        for i in range(16)
    ]
    recs.append(("ambX", b"ACDXFGHI"))
    assert_equivalent(ref.place(recs), sharded.place(recs))


class TestShardedDense:
    """Dense-plane sharded mode on virtual meshes."""

    @pytest.mark.parametrize("n_data,n_model", [(4, 2), (2, 4)])
    def test_dense_matches_oracle(self, db, reads, n_data, n_model):
        from epik_tpu.engine.placer import PlacerConfig

        tree = parse_newick(db.tree())
        mesh = make_mesh(n_data=n_data, n_model=n_model)
        cfg = PlacerConfig(dense_db="on")
        sharded = ShardedJaxPlacer(db, tree, mesh, config=cfg)
        assert sharded._dense_db
        ref = ReferencePlacer(db, tree)
        assert_equivalent(ref.place(reads), sharded.place(reads))

    def test_auto_selects_dense(self, db):
        tree = parse_newick(db.tree())
        mesh = make_mesh(n_data=4, n_model=2)
        sharded = ShardedJaxPlacer(db, tree, mesh)
        assert sharded._dense_db  # small fixture always fits


def test_hot_shard_overflow_retry():
    """A skewed hash shard must overflow the uniform Pb budget, re-dispatch,
    and still match the oracle (VERDICT round-2 item 7).

    The CSR budget heuristic assumes posting mass is balanced across hash
    shards (Pb ~ E * est / n_model, sharding.py); this fixture concentrates
    128-entry posting lists on one shard's keys while every other key has a
    single posting, and the reads' windows hit ONLY hot keys.
    """
    from epik_tpu.engine.placer import PlacerConfig
    from epik_tpu.io.db import PhyloKmerDB
    from epik_tpu.parallel.sharding import _shard_of_key

    n_model = 4
    base = random_db(num_leaves=80, kmer_size=6, num_kmers=64, seed=77)
    rng = np.random.default_rng(78)
    B = parse_newick(base.tree()).get_node_count()

    keys = base.keys  # sorted unique 6-mer codes
    shard = _shard_of_key(keys, n_model)
    # ONE giant posting list: keeps avg_plen (and thus the uniform Pb
    # estimate) small while its owner shard carries ~50x the average mass
    hot = np.zeros(keys.shape[0], bool)
    hot[int(np.flatnonzero(shard == 0)[0])] = True
    lens = np.where(hot, min(B, 150), 1).astype(np.int64)
    row_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    total = int(row_off[-1])
    # unique branches within each posting list (the scalar accumulation
    # never sees duplicate branches per key in real DBs)
    branches = np.concatenate(
        [rng.permutation(B)[: n].astype(np.uint32) for n in lens]
    )
    db = PhyloKmerDB(
        sequence_type="nucl", kmer_size=6, omega=base.omega,
        tree_newick=base.tree_newick, keys=keys, row_off=row_off,
        branches=branches,
        scores=rng.uniform(-3.5, -0.5, size=total).astype(np.float32),
        version=base.version, num_entries_total=total,
        num_entries_loaded=total,
    )
    db.validate()

    hot_keys = keys[hot]
    recs = []
    for i in range(12):
        parts = [
            DNA.decode_key(int(hot_keys[rng.integers(hot_keys.shape[0])]), 6)
            for _ in range(4)
        ]
        # distinct tail per read: identical sequences dedup into ONE unique
        # read (sequence_map), which would keep the hot mass under budget
        parts.append(DNA.decode_key(i, 6))
        recs.append((f"hot{i}", "".join(parts).encode()))

    tree = parse_newick(db.tree())
    mesh = make_mesh(n_data=2, n_model=n_model)
    ref = ReferencePlacer(db, tree)
    want = ref.place(recs)
    # both CSR staging paths must detect the hot shard and retry: the
    # round-5 device-tokenize bytes path and the host-staged streams path
    for tok in ("device", "host"):
        sharded = ShardedJaxPlacer(
            db, tree, mesh,
            config=PlacerConfig(dense_db="off", tokenize_where=tok),
        )
        assert not sharded._dense_db
        assert_equivalent(want, sharded.place(recs))
        assert sharded.overflow_retries > 0, (
            f"fixture failed to overflow the uniform shard budget ({tok})"
        )


def test_sharded_pipeline_inflight(tmp_path):
    """run_pipeline drives ShardedJaxPlacer with inflight > 1 and the output
    matches the oracle-driven pipeline (VERDICT round-2 item 6)."""
    from test_pipeline import _ListReader, _write

    from epik_tpu.core.tree import to_newick
    from epik_tpu.engine.placer import PlacerConfig
    from epik_tpu.tools.jplace_diff import jplace_diff

    db = random_db(num_leaves=16, kmer_size=6, num_kmers=1024, seed=91)
    tree = parse_newick(db.tree())
    nwk = to_newick(tree, jplace_edges=True)
    reads = random_reads(60, length=30, seed=92, ambig_rate=0.05)
    batches = [reads[i : i + 16] for i in range(0, 60, 16)]

    mesh = make_mesh(n_data=4, n_model=2)
    cfg = PlacerConfig(host_threads=2)
    sharded = ShardedJaxPlacer(db, tree, mesh, config=cfg)
    s1 = _write(sharded, batches, tmp_path / "s.jplace", nwk)
    s2 = _write(ReferencePlacer(db, tree), batches, tmp_path / "r.jplace", nwk)
    assert s1.num_seq_placed == s2.num_seq_placed == 60
    res = jplace_diff(str(tmp_path / "s.jplace"), str(tmp_path / "r.jplace"))
    assert res.clean, res.mismatches[:3]


class TestShardedShifted:
    """Column-sharded shifted-plane mode (single reduce; counts == -1)."""

    @pytest.mark.parametrize("n_data,n_model", [(4, 2), (2, 4)])
    def test_shifted_matches_oracle(self, db, reads, n_data, n_model):
        from epik_tpu.engine.placer import PlacerConfig

        tree = parse_newick(db.tree())
        mesh = make_mesh(n_data=n_data, n_model=n_model)
        cfg = PlacerConfig(dense_db="on", plane_mode="shifted")
        sharded = ShardedJaxPlacer(db, tree, mesh, config=cfg)
        assert sharded._shifted
        ref = ReferencePlacer(db, tree)
        assert_equivalent(ref.place(reads), sharded.place(reads))


class TestShardedPairPlane:
    """Column-sharded (k+1)-mer pair plane: per-shard pair rows are the
    column slices of the global pair rows, so the single-chip identity
    (one gather per two windows) carries over shard by shard."""

    def _fixture(self):
        from epik_tpu.io.build import reads_from_reference, reference_like_db

        db, ref = reference_like_db(num_leaves=48, kmer_size=8,
                                    ref_length=30_000, mean_posting_len=6.0,
                                    seed=61)
        tree = parse_newick(db.tree())
        reads = reads_from_reference(ref, 40, length=101, mutation_rate=0.05,
                                     seed=62)
        reads += [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:]),
                  ("short", b"AC"), ("nohit", b"T" * 30)]
        return db, tree, reads

    @pytest.mark.parametrize("n_data,n_model", [(4, 2), (2, 4), (8, 1)])
    def test_paired_matches_oracle(self, n_data, n_model):
        from test_jax_engine import assert_jplace_close

        db, tree, reads = self._fixture()
        mesh = make_mesh(n_data=n_data, n_model=n_model)
        sharded = ShardedJaxPlacer(db, tree, mesh)
        assert sharded._paired, "fixture must activate the sharded pair plane"
        ref = ReferencePlacer(db, tree)
        assert_jplace_close(ref.place(reads), sharded.place(reads))

    def test_sharded_tiles_matches_oracle(self):
        """Column-sharded posting-tile mode (the big-tree path across
        devices): per-shard local tiles + the scatter-add accumulate
        against the scalar oracle, incl. the CSR fallback for ambiguous
        batches."""
        from test_jax_engine import assert_jplace_close

        from epik_tpu.engine.placer import PlacerConfig

        db, tree, reads = self._fixture()
        reads_clean = [r for r in reads if r[0] not in ("amb",)]
        mesh = make_mesh(n_data=4, n_model=2)
        cfg = PlacerConfig(dense_db="off")
        sharded = ShardedJaxPlacer(db, tree, mesh, config=cfg)
        assert sharded._tiles_mode, "fixture must activate sharded tiles"
        ref = ReferencePlacer(db, tree)
        assert_jplace_close(ref.place(reads_clean), sharded.place(reads_clean))
        # the round-5 two-level split engages on this length distribution
        # (overflow keys permuted to rows [0, n_ov) via the shared direct
        # table; the extra result column drives the exactness retry)
        assert sharded._tile_pt_ov > 0 and sharded._tile_n_ov > 0
        # ambiguous batch falls back to the hash-sharded CSR path
        amb_batch = reads[:6] + [("amb2", reads[0][1][:30] + b"N" + reads[0][1][31:])]
        assert_jplace_close(ref.place(amb_batch), sharded.place(amb_batch))

    def test_pair_off_budget(self):
        from epik_tpu.engine.placer import PlacerConfig

        db, tree, reads = self._fixture()
        mesh = make_mesh(n_data=4, n_model=2)
        off = ShardedJaxPlacer(db, tree, mesh,
                               config=PlacerConfig(pair_plane="off"))
        assert not off._paired
        tiny = ShardedJaxPlacer(db, tree, mesh, config=PlacerConfig(
            pair_plane_budget=(db.num_kmers + 2) * 128 * 4))
        assert tiny._dense_db and not tiny._paired
