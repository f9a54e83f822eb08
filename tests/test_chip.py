"""Placement on the accelerator itself (chip-marked: skips on the CPU
backend).  Run on a machine with a GPU with
``EPIK_TESTS_ON_DEVICE=1 python -m pytest tests -m chip``."""

import pytest

from epik_tpu.core.tree import parse_newick
from epik_tpu.engine.placer import JaxPlacer, PlacerConfig
from epik_tpu.engine.reference import ReferencePlacer
from epik_tpu.io.build import reads_from_reference, reference_like_db

from test_jax_engine import assert_jplace_close

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("mode", ["dense", "tiles", "csr"])
def test_device_paths_match_oracle(accelerator, mode):
    db, ref = reference_like_db(num_leaves=96, kmer_size=10,
                                ref_length=40_000, mean_posting_len=6.0,
                                seed=71)
    tree = parse_newick(db.tree())
    cfg = {"dense": PlacerConfig(),
           "tiles": PlacerConfig(dense_db="off"),
           "csr": PlacerConfig(dense_db="off", tokenize_where="host")}[mode]
    placer = JaxPlacer(db, tree, config=cfg)
    assert (placer._tiles_mode, placer._dense_db) == {
        "dense": (False, True), "tiles": (True, False),
        "csr": (False, False)}[mode]
    reads = reads_from_reference(ref, 200, length=150, mutation_rate=0.02,
                                 seed=72)
    reads += [("short", b"AC"), ("nohit", b"T" * 30),
              ("amb", reads[0][1][:40] + b"N" + reads[0][1][41:])]
    assert_jplace_close(ReferencePlacer(db, tree).place(reads),
                        placer.place(reads))
