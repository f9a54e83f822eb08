"""Unit tests: cuckoo hash table and ragged expansion (device ops)."""

import jax.numpy as jnp
import numpy as np

from epik_tpu.ops.expand import ragged_expand
from epik_tpu.ops.hashtable import BUCKET, build_table, lookup


class TestCuckoo:
    def _roundtrip(self, n, seed):
        rng = np.random.default_rng(seed)
        keys = rng.choice(1 << 40, size=n, replace=False).astype(np.uint64)
        keys.sort()
        offs = np.arange(n, dtype=np.uint32) * 3
        lens = (1 + np.arange(n) % 7).astype(np.uint32)
        t = build_table(keys, offs, lens)
        hi = jnp.asarray((keys >> np.uint64(32)).astype(np.uint32))
        lo = jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        found, off, length = lookup(t.device_arrays(), t.seed1, t.seed2, hi, lo)
        assert bool(jnp.all(found)), "all inserted keys must be found"
        np.testing.assert_array_equal(np.asarray(off), offs)
        np.testing.assert_array_equal(np.asarray(length), lens)
        return t, keys

    def test_small(self):
        self._roundtrip(10, 0)

    def test_forces_eviction(self):
        # high load factor: nb*BUCKET slots, n close to capacity
        t, keys = self._roundtrip(10000, 1)
        capacity = t.num_buckets * BUCKET
        assert 10000 / capacity > 0.5  # actually exercises eviction paths

    def test_misses(self):
        rng = np.random.default_rng(2)
        keys = rng.choice(1 << 40, size=1000, replace=False).astype(np.uint64)
        t = build_table(keys, np.zeros(1000, np.uint32), np.ones(1000, np.uint32))
        probe = rng.choice(1 << 40, size=500, replace=False).astype(np.uint64)
        in_set = np.isin(probe, keys)
        hi = jnp.asarray((probe >> np.uint64(32)).astype(np.uint32))
        lo = jnp.asarray((probe & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        found, _, length = lookup(t.device_arrays(), t.seed1, t.seed2, hi, lo)
        np.testing.assert_array_equal(np.asarray(found), in_set)
        # misses must report zero-length posting lists
        assert bool(jnp.all(jnp.where(jnp.asarray(~in_set), length == 0, True)))

    def test_empty_table(self):
        t = build_table(np.empty(0, np.uint64), np.empty(0, np.uint32), np.empty(0, np.uint32))
        found, _, length = lookup(
            t.device_arrays(), t.seed1, t.seed2, jnp.zeros(4, jnp.uint32), jnp.zeros(4, jnp.uint32)
        )
        assert not bool(jnp.any(found))

    def test_sentinel_never_matches(self):
        t, _ = self._roundtrip(100, 3)
        s = jnp.full(8, 0xFFFFFFFF, jnp.uint32)
        found, _, length = lookup(t.device_arrays(), t.seed1, t.seed2, s, s)
        assert not bool(jnp.any(found))


class TestRaggedExpand:
    def test_basic(self):
        lens = jnp.array([2, 0, 3, 1], jnp.int32)
        win, elem, total = ragged_expand(lens, 8)
        assert int(total) == 6
        assert win.tolist() == [0, 0, 2, 2, 2, 3, -1, -1]
        assert elem.tolist() == [0, 1, 0, 1, 2, 0, 0, 0]

    def test_exact_budget(self):
        win, elem, total = ragged_expand(jnp.array([3, 3], jnp.int32), 6)
        assert int(total) == 6
        assert win.tolist() == [0, 0, 0, 1, 1, 1]

    def test_overflow_reports_total(self):
        win, elem, total = ragged_expand(jnp.array([5, 5], jnp.int32), 4)
        assert int(total) == 10  # caller must grow the budget
        assert win.tolist() == [0, 0, 0, 0]

    def test_all_zero(self):
        win, elem, total = ragged_expand(jnp.zeros(5, jnp.int32), 4)
        assert int(total) == 0
        assert win.tolist() == [-1, -1, -1, -1]

    def test_leading_zeros(self):
        win, _, _ = ragged_expand(jnp.array([0, 0, 2], jnp.int32), 4)
        assert win.tolist() == [2, 2, -1, -1]

    def test_random_against_numpy(self):
        rng = np.random.default_rng(0)
        for _ in range(20):
            lens = np.zeros(40, dtype=np.int64)  # fixed W: one compile total
            w = rng.integers(1, 40)
            lens[:w] = rng.integers(0, 6, size=w)
            expect = [(i, j) for i, l in enumerate(lens) for j in range(l)]
            budget = 256  # fixed: avoids one XLA compile per distinct shape
            win, elem, total = ragged_expand(jnp.asarray(lens, jnp.int32), budget)
            assert int(total) == len(expect)
            got = [(int(w), int(e)) for w, e in zip(win, elem) if w >= 0]
            assert got == expect


def _finish_numpy(Sq, m, *, scale, K, k, log_eps):
    """Numpy reference of the shifted finish (correction + LWR + top-K,
    ties to the lowest branch index): returns (scores, idx, log_sum, n,
    zero_sum) per read."""
    Sp = Sq.astype(np.float64) / scale
    touched = Sq > 0
    corrected = np.where(touched, (Sp + m[:, None] * log_eps) / k, -np.inf)
    B = Sq.shape[1]
    n = touched.sum(axis=1)
    npl = m * log_eps / k
    n_not = B - n
    max_c = corrected.max(axis=1)
    max_t = np.maximum(max_c, np.where(n_not > 0, npl, -np.inf))
    terms = np.where(touched, 10.0 ** (corrected - max_t[:, None]), 0.0)
    sum10 = terms.sum(axis=1) + n_not * np.where(n_not > 0, 10.0 ** (npl - max_t), 0.0)
    log_sum = max_t + np.log10(sum10)
    zero_sum = (max_c < -323.6) & ((npl < -323.6) | (n_not <= 0))
    idx = np.argsort(-corrected, axis=1, kind="stable")[:, :K]
    return np.take_along_axis(corrected, idx, axis=1), idx, log_sum, n, zero_sum


class TestPackedAccumulate:
    """ops/accumulate.py (the tiles path's XLA scatter-add accumulate)
    against a numpy scatter oracle, and the accumulate + XLA finish
    against a numpy reference finish."""

    def _mk(self, R, PP, B, seed=0, frac_trash=0.3):
        from epik_tpu.ops.accumulate import trash_branch

        rng = np.random.default_rng(seed)
        b = rng.integers(0, B, (R, PP)).astype(np.int32)
        q = rng.integers(1, 64001, (R, PP)).astype(np.int32)
        trash = trash_branch(B)
        mask = rng.random((R, PP)) < frac_trash
        b[mask] = trash
        q[mask] = 0
        return (b << 16) | q, b, q, trash

    def _finish(self, g, m, *, B, K, k, log_eps, scale):
        """Accumulate + finish exactly as the tiles step does."""
        from epik_tpu.engine.placer import (
            _pack_outputs_slim,
            finish_scores_shifted,
        )
        from epik_tpu.ops.accumulate import segment_sums_packed

        Sq = segment_sums_packed(jnp.asarray(g), B)
        Sp = Sq.astype(jnp.float32) / jnp.float32(scale)
        outs = finish_scores_shifted(Sp, jnp.asarray(m), B=B, K=K, k=k,
                                     log_eps=log_eps)
        return np.asarray(Sq), np.asarray(_pack_outputs_slim(outs))

    def _check(self, got, Sq, m, *, K, k, log_eps, scale):
        scores, idx, log_sum, n, zero_sum = _finish_numpy(
            Sq, m.astype(np.float64), scale=scale, K=K, k=k, log_eps=log_eps)
        np.testing.assert_allclose(got[:, :K], scores, rtol=1e-5, atol=1e-5)
        live = np.isfinite(scores)
        # indices agree on LIVE entries (-inf slots are dropped by the
        # host's n_eff cut, assemble_arrays)
        np.testing.assert_array_equal(got[:, K:2 * K][live], idx[live])
        np.testing.assert_allclose(got[:, 2 * K], log_sum, rtol=1e-5)
        np.testing.assert_array_equal(got[:, 2 * K + 1], n)
        np.testing.assert_array_equal(got[:, 2 * K + 2], zero_sum)

    def test_sums_match_numpy(self):
        from epik_tpu.ops.accumulate import segment_sums_packed, trash_branch

        R, PP, B = 16, 1024, 300
        g, b, q, trash = self._mk(R, PP, B)
        got = np.asarray(segment_sums_packed(jnp.asarray(g), B))
        want = np.zeros((R, trash_branch(B) + 1), np.int64)
        for r in range(R):
            np.add.at(want[r], b[r], q[r])
        # EXACT integer sums (int32 accumulate)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want[:, :B])

    def test_fused_topk_matches_xla_finish(self):
        """Accumulate + XLA finish (the tiles step's tail) against the
        numpy reference finish, including a read with NO touched branch
        (all trash) and one with fewer than K."""
        R, PP, B, K, k = 16, 1024, 300, 7, 10
        log_eps, scale = -4.26, 15023.0
        g, b, q, trash = self._mk(R, PP, B, seed=3)
        g[0] = np.int32(trash << 16)
        g[1, 8:] = np.int32(trash << 16)
        m = np.full(R, 141.0, np.float32)
        Sq, got = self._finish(g, m, B=B, K=K, k=k, log_eps=log_eps,
                               scale=scale)
        self._check(got, Sq, m, K=K, k=k, log_eps=log_eps, scale=scale)

    def test_fused_topk_fast_path_fallback_cases(self):
        """Top-K tie-breaking and clustered winners: branches that share
        a column residue mod 128 holding the three largest sums, an exact
        tie at the K-th boundary (the lower branch index must win, like
        the reference's ordering), and a clean spread -- against the numpy
        reference finish."""
        from epik_tpu.ops.accumulate import trash_branch

        R, PP, B, K, k = 24, 512, 300, 7, 10
        log_eps, scale = -4.26, 15023.0
        trash = trash_branch(B)
        g = np.full((R, PP), np.int32(trash << 16), np.int32)
        rng = np.random.default_rng(9)

        def put(r, pairs):
            for j, (br, q) in enumerate(pairs):
                g[r, j] = (br << 16) | q

        # branches 5, 133, 261 share a residue mod 128; largest sums
        put(0, [(5, 60000), (133, 59000), (261, 58000)]
               + [(i * 3 + 7, 1000 + i) for i in range(8)])
        # exact tie at the K-th boundary (branches 10 and 138)
        put(8, [(10, 5000), (138, 5000)]
               + [(20 + i, 50000 - 100 * i) for i in range(6)])
        # clean spread (distinct residues)
        put(16, [(i * 5 + 2, 40000 - 500 * i) for i in range(12)])
        for r in list(range(1, 8)) + list(range(9, 16)) + list(range(17, 24)):
            put(r, [(int(x), int(y)) for x, y in zip(
                rng.integers(0, B, 10), rng.integers(1, 64001, 10))])

        m = np.full(R, 141.0, np.float32)
        Sq, got = self._finish(g, m, B=B, K=K, k=k, log_eps=log_eps,
                               scale=scale)
        self._check(got, Sq, m, K=K, k=k, log_eps=log_eps, scale=scale)
        # the tie at the cut keeps branch 10, never 138
        assert 10 in got[8, K:2 * K] and 138 not in got[8, K:2 * K]
