"""Device bring-up: compile cache location, memory budgets from the
device, path gates decided by observables, no matrix products in the
placement steps, multi-process device binding, and the chip smoke
script's refusal to run without an accelerator."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from epik_tpu.core.tree import parse_newick
from epik_tpu.engine import placer as placer_mod
from epik_tpu.engine.placer import JaxPlacer, PlacerConfig, device_memory_budgets
from epik_tpu.io.build import reads_from_reference, reference_like_db
from epik_tpu.utils.compile_cache import DEFAULT_CACHE_DIR, configure_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GiB = 1 << 30


class TestCompileCache:
    def test_env_set_leaves_config_alone(self, monkeypatch):
        before = jax.config.jax_compilation_cache_dir
        jax.config.update("jax_compilation_cache_dir", "/sentinel")
        try:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/from/env")
            assert configure_compile_cache() == "/from/env"
            assert jax.config.jax_compilation_cache_dir == "/sentinel"
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_env_unset_uses_checkout_dir(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert configure_compile_cache() == DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == DEFAULT_CACHE_DIR
        assert DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


class TestMemoryBudgets:
    def test_shares_of_reported_pool(self):
        pool = 63_763_120_128  # an 80 GB card at JAX's default 75% share
        dense, pair, cap = device_memory_budgets(_FakeDevice({"bytes_limit": pool}))
        assert dense == int(pool * 6 / 16)
        assert pair == int(pool * 10 / 16)
        assert cap == int(pool * 14 / 16)

    @pytest.mark.parametrize("stats", [None, {}, "cpu"])
    def test_default_pool_without_stats(self, stats):
        dev = jax.devices()[0] if stats == "cpu" else _FakeDevice(stats)
        assert device_memory_budgets(dev) == (6 * GiB, 10 * GiB, 14 * GiB)

    def test_tiles_gate_follows_device_memory(self, monkeypatch):
        """The same DB takes the dense plane on a roomy device and the
        posting tiles on a small one -- no platform switch involved."""
        db, _ = reference_like_db(num_leaves=64, kmer_size=8,
                                  ref_length=8_000, mean_posting_len=6.0,
                                  seed=3)
        tree = parse_newick(db.tree())
        roomy = JaxPlacer(db, tree)
        assert roomy._dense_db and not roomy._tiles_mode
        plane = (db.num_kmers + 1) * tree.get_node_count() * 4
        pool = int(plane * 16 / 6) - 1  # dense share just below the plane
        monkeypatch.setattr(placer_mod, "device_memory_budgets",
                            lambda device=None: (int(pool * 6 / 16),
                                                 int(pool * 10 / 16),
                                                 int(pool * 14 / 16)))
        small = JaxPlacer(db, tree)
        assert not small._dense_db and small._tiles_mode
        assert small.config.dense_db_budget == int(pool * 6 / 16)
        assert small.path_name == "posting-tiles packed device-tokenize"


class TestNoMatrixProducts:
    """f32 matrix products may run in TF32 on a GPU; the placement steps
    have none, so that precision question cannot arise.  A change that
    adds one must pin precision=HIGHEST and update this test."""

    @pytest.mark.parametrize("mode", ["dense", "tiles"])
    def test_lowered_step_has_no_dot_general(self, mode):
        db, ref = reference_like_db(num_leaves=48, kmer_size=8,
                                    ref_length=6_000, mean_posting_len=6.0,
                                    seed=5)
        tree = parse_newick(db.tree())
        cfg = PlacerConfig() if mode == "dense" else PlacerConfig(dense_db="off")
        p = JaxPlacer(db, tree, config=cfg)
        assert p._paired if mode == "dense" else p._tiles_mode
        reads = reads_from_reference(ref, 8, length=150, mutation_rate=0.02,
                                     seed=6)
        fn, args = p.device_fn_args(reads)
        text = jax.jit(fn).lower(*args).as_text()
        assert "dot_general" not in text and "convolution" not in text


def test_init_distributed_binds_local_devices(monkeypatch):
    from epik_tpu.parallel import mesh

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    mesh.init_distributed("localhost:1234", num_processes=2, process_id=1,
                          initialization_timeout=30, local_device_ids=[2, 3])
    assert seen == {"coordinator_address": "localhost:1234",
                    "num_processes": 2, "process_id": 1,
                    "initialization_timeout": 30, "local_device_ids": [2, 3]}


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_accelerator(where, tmp_path):
    """On the CPU backend, and in a directory holding only the script, the
    smoke run exits non-zero and never prints an ok result."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = str(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
