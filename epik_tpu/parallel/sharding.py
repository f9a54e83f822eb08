"""Multi-device placement: data-parallel reads x column-sharded database.

Distribution (green-field vs the reference, which is a single
OpenMP process -- SURVEY.md sections 2 and 5.8):

* **data axis**: unique reads of a batch split into contiguous groups, one
  per data shard; no communication -- the analog of the reference's OpenMP
  parallel-for over reads (reference: epik/src/epik/place.cpp:218-229).
* **model axis**, dense mode (the default): the dense score plane is
  partitioned by **branch columns** -- each model shard holds the full
  k-mer rows for a contiguous slice of tree branches.  The window row
  stream is replicated over the model axis (it is tiny next to the plane),
  so the exact row-gather sums *and* the ambiguous first-hit are entirely
  local to each shard -- the only collectives are per-read scalars for the
  LWR normalization (``psum``/``pmax``) and an ``all_gather`` of
  K top-k candidates per read.  Communication volume per batch is
  O(R * K * n_model) floats, independent of tree size.  This is also what
  makes 10k+-taxa trees fit: per-shard plane bytes shrink linearly in the
  model-axis size.
* **model axis**, CSR mode (databases too large for dense planes even
  sharded): the k-mer table is partitioned by key hash; every shard looks
  up the full replicated key stream against its own cuckoo table (a key
  misses everywhere but its owner), the dense per-(read, branch) partial
  score/count matrices merge with ``psum``, and the ambiguous first-hit
  merges as ``pmin`` over processing order plus an owner-masked ``psum``.

Everything below runs inside ``shard_map`` over a ('data', 'model') mesh;
kernels are module-level ``jax.jit`` functions keyed only on static shape
parameters (never on the placer instance), so placers sharing a mesh and
geometry share compilations.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ..core.alphabet import get_alphabet
from ..core.scoring import score_threshold
from ..core.tree import PhyloTree
from ..engine.placer import (
    HostStaging,
    _ORDER_INF,
    _apply_amb,
    _POW10_ZERO,
    _U64,
    PlacerConfig,
    _bucket,
    _bucket_lmax,
    _Pending,
    _pack_outputs,
    _pack_outputs_slim,
    _pack_outputs_slim_totals,
    _window_count_f32,
    accumulate_amb_firsthit,
    accumulate_exact,
    assemble_arrays,
    device_memory_budgets,
    dense_sums_from_rows,
    dense_sums_shifted,
    _tokenize_core,
    build_combo_table,
    device_tokenize_combo,
    device_tokenize_packed,
    enumerate_pairs,
    finish_scores,
    pack_reads,
    unpack_outputs,
    unpack_outputs_slim,
)
from ..engine.types import PlacedCollection
from ..io.db import PhyloKmerDB
from ..ops.accumulate import segment_sums, segment_sums_packed, trash_branch
from ..ops.hashtable import build_table
from .mesh import DATA_AXIS, MODEL_AXIS

__all__ = ["ShardedJaxPlacer", "shard_db_by_hash", "shard_db_columns"]

_SENTINEL_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _shard_of_key(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Stable hash-based shard assignment (balanced, key-range-free)."""
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    with np.errstate(over="ignore"):
        x = lo ^ (hi * np.uint32(0x9E3779B9))
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
    return (x % np.uint32(n_shards)).astype(np.int64)


# ---------------------------------------------------------------------------
# database partitioning
# ---------------------------------------------------------------------------


def shard_db_columns(db: PhyloKmerDB, n_model: int, num_branches: int,
                     shifted: bool = False, log_eps: float = 0.0):
    """Column-sharded dense score planes: [n_model, n_keys+1, bwl] float32.

    Shard ``s`` owns global branch columns [s*bwl, (s+1)*bwl); ``bwl`` is
    the per-shard width, a 128 multiple (aligned row gathers).  Absent
    (key, branch) cells are exactly 0.0; stored scores of exactly 0.0
    (P == 1) are nudged to a tiny normal negative float32 so presence stays
    ``!= 0`` (devices may flush subnormals).  The last plane row is the all-zero
    miss row.  One vectorized scatter builds all shards.

    ``shifted``: cells hold s - log10(eps) instead (> 0 present; the
    single-reduce mode, engine/placer.py::PlacerConfig.plane_mode).
    """
    bwl = -(-num_branches // (128 * n_model)) * 128
    n_keys = db.num_kmers
    lens = np.diff(db.row_off)
    rows_pp = np.repeat(np.arange(n_keys, dtype=np.int64), lens.astype(np.int64))
    br = db.branches.astype(np.int64)
    if shifted:
        sp = (db.scores.astype(np.float64) - float(log_eps)).astype(np.float32)
        sc = np.where(sp <= 0.0, np.float32(1e-37), sp)
    else:
        sc = np.where(db.scores == 0.0, np.float32(-1e-37), db.scores).astype(np.float32)
    shard = br // bwl
    planes = np.zeros((n_model, n_keys + 1, bwl), np.float32)
    planes[shard, rows_pp, br - shard * bwl] = sc
    return planes, bwl


def shard_tiles_columns(db: PhyloKmerDB, n_model: int, B: int,
                        log_eps: float):
    """Column-sharded posting tiles for the big-tree mode.

    Shard m keeps, per key, only the postings whose branch falls in its
    block [m*bwl, (m+1)*bwl), re-based to local ids, trash-padded to a
    common PT (the max per-shard local posting count).

    Layout follows the single-device engine: PACKED int32 cells
    ``(local_branch << 16) | q`` (q = shifted score on a 64000-step grid)
    whenever the per-shard branch block fits 15 bits -- halves the gather
    bytes and makes the accumulate an exact int32 sum
    (engine/placer.py::PlacerConfig.tile_payload).  Per-shard blocks are
    B/n_model wide, so the gate virtually always holds; the f32
    interleaved-pair layout remains as fallback.

    Returns (tiles, bwl, PT, scale): tiles int32[n_model, n_keys+1, PT]
    with quantization ``scale`` when packed, or uint32[n_model, n_keys+1,
    2*PT] with scale == 0.0 (the f32 layout marker)."""
    n_keys = db.num_kmers
    bwl = -(-B // (128 * n_model)) * 128
    lens = np.diff(db.row_off)
    rows_pp = np.repeat(np.arange(n_keys, dtype=np.int64), lens)
    br = db.branches.astype(np.int64)
    shard = br // bwl
    shifted = (db.scores.astype(np.float64) - float(log_eps)).astype(np.float32)

    counts = np.zeros((n_model, n_keys), np.int64)
    np.add.at(counts, (shard, rows_pp), 1)
    max_cnt = max(int(counts.max()), 1)
    PT = -(-max_cnt // 8) * 8
    packed = trash_branch(bwl) < (1 << 15)
    # two-level split (the sharded analog of the single-device
    # build): per-shard posting counts have SMALLER means but similar
    # maxes, so single-level padding is even worse here.  Main plane at
    # the cost knee; overflow keys (ANY shard over PT_main) permuted to
    # rows [0, n_ov) so the step's membership test stays arithmetic --
    # the permutation is common to all shards via the shared direct
    # table.  Packed payload only (the f32 fallback keeps single-level).
    perm = np.arange(n_keys, dtype=np.int64)
    PT_OV = 0
    n_ov = 0
    frac_over = 0.0
    if packed and PT > 8 and n_keys:
        key_max = counts.max(axis=0)
        best, best_cost = PT, float(PT)
        for cand in range(8, PT, 8):
            fo = float((key_max > cand).mean())
            ptov = -(-(max_cnt - cand) // 8) * 8
            cost = cand + 2.0 * fo * ptov
            if cost < best_cost - 0.5:
                best, best_cost = cand, cost
        if best < PT and bool((key_max > best).any()):
            PT_main = best
            PT_OV = -(-(max_cnt - PT_main) // 8) * 8
            frac_over = float((key_max > PT_main).mean())
            ov_keys = np.flatnonzero(key_max > PT_main)
            n_ov = ov_keys.shape[0]
            perm = np.empty(n_keys, np.int64)
            perm[ov_keys] = np.arange(n_ov)
            perm[np.flatnonzero(key_max <= PT_main)] = np.arange(
                n_ov, n_keys
            )
            PT = PT_main
    if packed:
        span = max(float(-log_eps), 1e-6)
        scale = 64000.0 / span
        q = np.clip(np.rint(shifted.astype(np.float64) * scale),
                    1, 64000).astype(np.int64)
        tiles = np.full((n_model, n_keys + 1, PT),
                        np.int32(trash_branch(bwl) << 16), np.int32)
    else:
        scale = 0.0
        shifted = np.where(shifted <= 0.0, np.float32(1e-37), shifted)
        sbits = shifted.view(np.uint32)
        tiles = np.empty((n_model, n_keys + 1, 2 * PT), np.uint32)
        tiles[:, :, 0::2] = np.uint32(trash_branch(bwl))
        tiles[:, :, 1::2] = np.float32(0.0).view(np.uint32)
    tiles_ov = None
    if PT_OV:
        tiles_ov = np.full((n_model, n_ov + 1, PT_OV),
                           np.int32(trash_branch(bwl) << 16), np.int32)
    for m in range(n_model):
        mask = shard == m
        rows_m = rows_pp[mask]  # nondecreasing (rows_pp sorted)
        cm = counts[m]
        starts = np.concatenate([[0], np.cumsum(cm)])[:-1]
        cols = np.arange(rows_m.size, dtype=np.int64) - np.repeat(starts, cm)
        local = br[mask] - m * bwl
        if packed:
            vals = ((local << 16) | q[mask]).astype(np.int32)
            main = cols < PT
            tiles[m, perm[rows_m[main]], cols[main]] = vals[main]
            if PT_OV:
                ov = ~main
                tiles_ov[m, perm[rows_m[ov]] + 1, cols[ov] - PT] = vals[ov]
        else:
            tiles[m, rows_m, 2 * cols] = local.astype(np.uint32)
            tiles[m, rows_m, 2 * cols + 1] = sbits[mask]
    return tiles, bwl, PT, scale, tiles_ov, PT_OV, n_ov, frac_over, perm


@dataclasses.dataclass
class _ShardedDB:
    """Stacked per-shard cuckoo tables + posting arrays (leading model axis)."""

    packed: np.ndarray  # [n_model, nb, 4*BUCKET] uint32 (packed cuckoo rows)
    postings: np.ndarray  # [n_model, Pmax, 2] uint32 rows [branch | score bits]
    row_off: np.ndarray  # [n_model, rows_pad] int32 local CSR offsets
    seeds: list[tuple[int, int]]
    avg_plen: float


def shard_db_by_hash(db: PhyloKmerDB, n_model: int) -> _ShardedDB:
    """Partition the CSR database by key hash (the big-DB mode).

    Fully vectorized: postings are permuted once by a stable argsort over
    the per-posting shard id (stable => within a shard, postings keep the
    ascending-key order that the local CSR expects).
    """
    lens_all = np.diff(db.row_off).astype(np.int64)
    shard_ids = _shard_of_key(db.keys, n_model)

    post_shard = np.repeat(shard_ids, lens_all)
    perm = np.argsort(post_shard, kind="stable")
    branches_sorted = db.branches[perm]
    scores_sorted = db.scores[perm]
    post_counts = np.bincount(post_shard, minlength=n_model).astype(np.int64)
    post_starts = np.concatenate([[0], np.cumsum(post_counts)])

    key_counts = np.bincount(shard_ids, minlength=n_model)
    max_n = max(1, int(key_counts.max()) if db.num_kmers else 1)

    # identical table geometry across shards (required for stacking)
    from ..ops.hashtable import BUCKET, _next_pow2

    nb_target = _next_pow2(max(1, int(np.ceil(max_n / (BUCKET * 0.85)))))

    per_shard = []
    tables = []
    for s in range(n_model):
        sel = shard_ids == s
        keys = db.keys[sel]
        lens = lens_all[sel]
        local_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        branches = branches_sorted[post_starts[s] : post_starts[s + 1]]
        scores = scores_sorted[post_starts[s] : post_starts[s + 1]]
        per_shard.append((keys, local_off, branches, scores))
        tables.append(
            build_table(keys, np.arange(keys.shape[0], dtype=np.uint32), lens,
                        min_buckets=nb_target)
        )

    p_max = max(1, max(x[2].shape[0] for x in per_shard))
    rows_pad = max(len(x[1]) for x in per_shard)
    stack = lambda f: np.stack([f(i) for i in range(n_model)])

    def pack_postings(i):
        br, sc = per_shard[i][2], per_shard[i][3]
        pp = np.stack(
            [br.astype(np.uint32), sc.astype(np.float32).view(np.uint32)], axis=1
        )
        return np.pad(pp, ((0, p_max - pp.shape[0]), (0, 0)))

    return _ShardedDB(
        packed=stack(lambda i: tables[i].packed()),
        postings=stack(pack_postings),
        row_off=stack(
            lambda i: np.pad(
                per_shard[i][1].astype(np.int32),
                (0, rows_pad - len(per_shard[i][1])),
                mode="edge",
            )
        ),
        seeds=[(t.seed1, t.seed2) for t in tables],
        avg_plen=float(lens_all.mean()) if lens_all.size else 1.0,
    )


# ---------------------------------------------------------------------------
# sharded finish: correction + LWR + distributed top-k
# ---------------------------------------------------------------------------


def finish_scores_cols(S, C, m_f32, *, B, K, k, log_eps):
    """Column-sharded correction + LWR + two-stage top-k.

    ``S``/``C`` are (R, bwl) local branch-column slices (padded columns are
    never touched -> corrected = -inf there).  Semantics match
    engine/placer.py::finish_scores (reference: place.cpp:417-422,164-184);
    collectives: per-read scalar ``psum``/``pmax`` for the LWR sum (quirk
    Q4), then a K-candidate ``all_gather`` + re-top-k.  For tied scores the
    candidate layout (shards in column order, each shard's candidates in
    ascending local index) preserves the single-device lowest-index-first
    tie-break of ``lax.top_k``.
    """
    f32 = jnp.float32
    log_eps = f32(log_eps)
    touched = C > 0

    diff = m_f32[:, None] - C.astype(f32)
    diff = jnp.where(diff < 0, f32(_U64), diff)  # quirk Q1 family
    corrected = (S + diff * log_eps) / f32(k)
    corrected = jnp.where(touched, corrected, f32(-jnp.inf))
    return _lwr_topk_cols(corrected, touched, m_f32, C,
                          B=B, K=K, k=k, log_eps=log_eps)


def finish_scores_cols_shifted(Sp, m_f32, *, B, K, k, log_eps):
    """Column-sharded finish from SHIFTED row sums S' = S - C*log_eps
    (engine/placer.py::finish_scores_shifted, sharded analog).  Per-branch
    counts are never materialized (reported as -1)."""
    f32 = jnp.float32
    log_eps = f32(log_eps)
    touched = Sp > 0
    corrected = (Sp + m_f32[:, None] * log_eps) / f32(k)
    corrected = jnp.where(touched, corrected, f32(-jnp.inf))
    return _lwr_topk_cols(corrected, touched, m_f32, None,
                          B=B, K=K, k=k, log_eps=log_eps)


def _lwr_topk_cols(corrected, touched, m_f32, C, *, B, K, k, log_eps):
    """Shared column-sharded LWR + distributed top-k tail."""
    f32 = jnp.float32
    log_eps = f32(log_eps)
    neg_inf = f32(-jnp.inf)

    n = jax.lax.psum(jnp.sum(touched, axis=1).astype(jnp.int32), MODEL_AXIS)
    npl_exp = m_f32 * log_eps / f32(k)
    n_not = f32(B) - n.astype(f32)
    max_c = jax.lax.pmax(jnp.max(corrected, axis=1), MODEL_AXIS)
    max_t = jnp.maximum(max_c, jnp.where(n_not > 0, npl_exp, neg_inf))
    ln10 = f32(math.log(10.0))
    terms = jnp.where(touched, jnp.exp((corrected - max_t[:, None]) * ln10), 0.0)
    sum10 = jax.lax.psum(jnp.sum(terms, axis=1), MODEL_AXIS) + n_not * jnp.exp(
        jnp.where(n_not > 0, (npl_exp - max_t) * ln10, neg_inf)
    )
    log_sum = max_t + jnp.log(sum10) / ln10
    zero_sum = (max_c < f32(_POW10_ZERO)) & (
        (npl_exp < f32(_POW10_ZERO)) | (n_not <= 0)
    )

    R, bwl = corrected.shape
    Kl = min(K, bwl)
    s_l, i_l = jax.lax.top_k(corrected, Kl)
    c_l = (jnp.full(i_l.shape, -1, jnp.int32) if C is None
           else jnp.take_along_axis(C, i_l, axis=1))
    col0 = jax.lax.axis_index(MODEL_AXIS).astype(jnp.int32) * jnp.int32(bwl)
    i_g = i_l.astype(jnp.int32) + col0
    cand_s = jax.lax.all_gather(s_l, MODEL_AXIS)  # (n_model, R, Kl)
    cand_i = jax.lax.all_gather(i_g, MODEL_AXIS)
    cand_c = jax.lax.all_gather(c_l, MODEL_AXIS)
    nm = cand_s.shape[0]
    cand_s = jnp.moveaxis(cand_s, 0, 1).reshape(R, nm * Kl)
    cand_i = jnp.moveaxis(cand_i, 0, 1).reshape(R, nm * Kl)
    cand_c = jnp.moveaxis(cand_c, 0, 1).reshape(R, nm * Kl)
    topk_scores, sel = jax.lax.top_k(cand_s, K)
    topk_idx = jnp.take_along_axis(cand_i, sel, axis=1)
    topk_counts = jnp.take_along_axis(cand_c, sel, axis=1)
    wr = jnp.exp((topk_scores - log_sum[:, None]) * ln10)
    wr = jnp.where(zero_sum[:, None] | (topk_scores < f32(_POW10_ZERO)), 0.0, wr)
    # log_sum appended for the slim result pack (engine/placer.py::
    # _pack_outputs_slim layout; the classic full pack slices outs[:6])
    return topk_scores, topk_idx, topk_counts, wr, n, zero_sum, log_sum


# ---------------------------------------------------------------------------
# device kernels (module-level jit: shared across placer instances)
# ---------------------------------------------------------------------------


# Local ambiguous first-hit contribution (quirks Q6/Q7) is the shared
# engine/placer.py::_apply_amb -- column sharding makes it collective-free:
# each branch column is owned by exactly one shard, and the shard sees the
# full replicated key stream.


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "R", "B", "bwl", "K", "Amax", "k", "Lmax", "num_kmers",
        "log_eps", "eps", "shifted",
    ),
)
def _sharded_dense_bytes_step(
    plane_cols, direct, buf, arows, *,
    mesh, R: int, B: int, bwl: int, K: int, Amax: int, k: int, Lmax: int,
    num_kmers: int, log_eps: float, eps: float, shifted: bool = False,
):
    """Column-sharded dense step with ON-DEVICE tokenization.

    The host ships one packed uint8 buffer per batch (engine/placer.py::
    pack_reads); tokenization + direct-table row resolution run redundantly
    on every model shard (cheap elementwise work) against the replicated
    buffer,
    then each shard row-gathers only its own branch columns.
    """

    def block(plane, direct, buf, arows):
        rows, lens = device_tokenize_packed(
            buf, direct, k=k, Lmax=Lmax, num_kmers=num_kmers
        )
        m_f32 = _window_count_f32(lens, k)
        W = rows.shape[1]
        Wp = -(-W // 16) * 16  # chunked-gather width contract
        rows = jnp.pad(rows, ((0, 0), (0, Wp - W)), constant_values=num_kmers)
        if shifted:
            Sp = dense_sums_shifted(plane, rows, R=R, B=bwl, Wmax=Wp)
            if Amax > 0:
                Sp, _ = _apply_amb(Sp, None, plane, arows, R=R, B=bwl,
                                   Amax=Amax, k=k, eps=eps, log_eps=log_eps,
                                   shifted=True)
            outs = finish_scores_cols_shifted(Sp, m_f32, B=B, K=K, k=k,
                                              log_eps=log_eps)
            return _pack_outputs_slim(outs)[None]
        S, C = dense_sums_from_rows(plane, rows, R=R, B=bwl, Wmax=Wp)
        if Amax > 0:
            S, C = _apply_amb(S, C, plane, arows, R=R, B=bwl, Amax=Amax,
                              k=k, eps=eps, log_eps=log_eps, shifted=False)
        outs = finish_scores_cols(S, C, m_f32, B=B, K=K, k=k, log_eps=log_eps)
        zero = jnp.int32(0)
        return _pack_outputs(outs, zero, zero)[None]

    return jax.shard_map(
        block,
        mesh=mesh,
        in_specs=(P(None, MODEL_AXIS), P(), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )(plane_cols, direct, buf, arows)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "R", "B", "bwl", "K", "Amax", "k", "Lmax", "num_kmers",
        "log_eps", "eps",
    ),
)
def _sharded_dense_paired_step(
    plane_cols, combo, buf, arows, *,
    mesh, R: int, B: int, bwl: int, K: int, Amax: int, k: int, Lmax: int,
    num_kmers: int, log_eps: float, eps: float,
):
    """Column-sharded dense step over the PAIR plane (shifted-only).

    Identical collective structure to :func:`_sharded_dense_bytes_step`;
    the per-shard row gather runs over ceil(W/2) pair slots (each shard's
    pair rows are the column-slices of the global pair rows, so the sums
    compose per column exactly as in the single-chip engine).  Slot rows
    resolve through the unified combo table (one element gather per slot,
    engine/placer.py::device_tokenize_combo)."""

    def block(plane, combo, buf, arows):
        rows, lens = device_tokenize_combo(
            buf, combo, k=k, Lmax=Lmax, num_kmers=num_kmers
        )
        m_f32 = _window_count_f32(lens, k)
        Wp = rows.shape[1]
        Wpad = -(-Wp // 16) * 16
        rows = jnp.pad(rows, ((0, 0), (0, Wpad - Wp)), constant_values=num_kmers)
        Sp = dense_sums_shifted(plane, rows, R=R, B=bwl, Wmax=Wpad)
        if Amax > 0:
            Sp, _ = _apply_amb(Sp, None, plane, arows, R=R, B=bwl,
                               Amax=Amax, k=k, eps=eps, log_eps=log_eps,
                               shifted=True)
        outs = finish_scores_cols_shifted(Sp, m_f32, B=B, K=K, k=k,
                                          log_eps=log_eps)
        return _pack_outputs_slim(outs)[None]

    return jax.shard_map(
        block,
        mesh=mesh,
        in_specs=(P(None, MODEL_AXIS), P(), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )(plane_cols, combo, buf, arows)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "R", "B", "bwl", "K", "k", "Lmax", "num_kmers", "PT",
        "log_eps", "eps", "tile_scale", "PT_OV", "OV", "N_OV",
    ),
)
def _sharded_tiles_bytes_step(
    tiles_cols, direct, buf, tiles_ov=None, *,
    mesh, R: int, B: int, bwl: int, K: int, k: int, Lmax: int,
    num_kmers: int, PT: int, log_eps: float, eps: float,
    tile_scale: float = 0.0,
    PT_OV: int = 0, OV: int = 0, N_OV: int = 0,
):
    """Column-sharded posting-TILE step: the big-tree mode across devices.

    Each model shard owns the branch block [m*bwl, (m+1)*bwl) and keeps
    per-key tiles of ONLY its local postings (branch ids re-based to the
    block).  Tokenization runs redundantly per shard (cheap elementwise
    work against the replicated packed buffer); each shard row-gathers its
    own tiles and sums them per (read, branch) (ops/accumulate.py); the
    merge is the same O(R*K*n_model) collective tail as the dense sharded
    mode (finish_scores_cols_shifted).  ``tile_scale`` > 0 selects the
    packed int32 payload with its exact int32 accumulate
    (shard_tiles_columns).  Engine analog:
    engine/placer.py::_place_batch_tiles_bytes."""

    def block(tiles, direct, buf, tiles_ov=None):
        tiles = tiles[0]
        i32 = jnp.int32
        f32 = jnp.float32
        rows, lens = device_tokenize_packed(
            buf, direct, k=k, Lmax=Lmax, num_kmers=num_kmers
        )
        m_f32 = _window_count_f32(lens, k)
        W = rows.shape[1]
        if tile_scale > 0.0:
            g = tiles[rows].reshape(R, W * PT)
            cnt_ov = None
            if PT_OV > 0:
                # two-level tiles (shared design with the single-device
                # engine): overflow keys sit at rows [0, N_OV) via the
                # direct-table permutation, overflow windows compact to a
                # static OV budget by top_k, and the true per-read count
                # rides an extra result column for the host's
                # exactness-by-retry
                ovr = jnp.where(rows < i32(N_OV), rows + 1, 0)
                cnt_ov = jnp.sum((ovr > 0).astype(i32), axis=1)
                tov = tiles_ov[0]
                gov = tov[jax.lax.top_k(ovr, OV)[0]].reshape(R, OV * PT_OV)
                g = jnp.concatenate([g, gov], axis=1)
            Sp = segment_sums_packed(g, bwl).astype(f32) / f32(tile_scale)
            outs = finish_scores_cols_shifted(Sp, m_f32, B=B, K=K, k=k,
                                              log_eps=log_eps)
            pack = _pack_outputs_slim(outs)
            if cnt_ov is not None:
                pack = jnp.concatenate(
                    [pack, cnt_ov.astype(f32)[:, None]], axis=1
                )
            return pack[None]
        g = tiles[rows].reshape(R, W * PT, 2)
        b = g[..., 0].astype(i32)
        s = jax.lax.bitcast_convert_type(g[..., 1], f32)
        Sp = segment_sums(b, s, bwl)
        outs = finish_scores_cols_shifted(Sp, m_f32, B=B, K=K, k=k,
                                          log_eps=log_eps)
        return _pack_outputs_slim(outs)[None]

    specs = (P(MODEL_AXIS), P(), P(DATA_AXIS))
    args = (tiles_cols, direct, buf)
    if PT_OV > 0:
        specs = specs + (P(MODEL_AXIS),)
        args = args + (tiles_ov,)
    return jax.shard_map(
        block,
        mesh=mesh,
        in_specs=specs,
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )(*args)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "R", "B", "bwl", "K", "Wmax", "Amax", "k",
                     "log_eps", "eps", "shifted"),
)
def _sharded_dense_rows_step(
    plane_cols, rows, arows, m_f32, *,
    mesh, R: int, B: int, bwl: int, K: int, Wmax: int, Amax: int, k: int,
    log_eps: float, eps: float, shifted: bool = False,
):
    """Column-sharded dense step with HOST-side key->row lookup (any
    alphabet / k; the sharded analog of placer.py::_place_batch_dense_rows)."""

    def block(plane, rows, arows, m):
        if shifted:
            Sp = dense_sums_shifted(plane, rows, R=R, B=bwl, Wmax=Wmax)
            if Amax > 0:
                Sp, _ = _apply_amb(Sp, None, plane, arows, R=R, B=bwl,
                                   Amax=Amax, k=k, eps=eps, log_eps=log_eps,
                                   shifted=True)
            outs = finish_scores_cols_shifted(Sp, m, B=B, K=K, k=k,
                                              log_eps=log_eps)
            return _pack_outputs_slim(outs)[None]
        S, C = dense_sums_from_rows(plane, rows, R=R, B=bwl, Wmax=Wmax)
        if Amax > 0:
            S, C = _apply_amb(S, C, plane, arows, R=R, B=bwl, Amax=Amax,
                              k=k, eps=eps, log_eps=log_eps, shifted=False)
        outs = finish_scores_cols(S, C, m, B=B, K=K, k=k, log_eps=log_eps)
        zero = jnp.int32(0)
        return _pack_outputs(outs, zero, zero)[None]

    return jax.shard_map(
        block,
        mesh=mesh,
        in_specs=(P(None, MODEL_AXIS), P(DATA_AXIS), P(DATA_AXIS),
                  P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )(plane_cols, rows, arows, m_f32)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "R", "B", "K", "Pb", "PAb", "k", "log_eps",
                     "eps"),
)
def _sharded_csr_step(
    seed1, seed2, t_packed, db_post, row_off,
    e_hi, e_lo, e_read, a_hi, a_lo, a_read, a_order, m_f32, *,
    mesh, R: int, B: int, K: int, Pb: int, PAb: int, k: int,
    log_eps: float, eps: float,
):
    """Hash-sharded CSR step (big-DB mode): per-shard posting scatter-adds
    merged with psum over the model axis; ambiguous first-hit merged with
    pmin + owner-masked psum (each key lives on exactly one shard)."""

    def block(seed1, seed2, t_packed, db_post, row_off,
              e_hi, e_lo, e_read, a_hi, a_lo, a_read, a_order, m):
        table = t_packed[0]
        s1 = seed1[0, 0]
        s2 = seed2[0, 0]
        S, C, e_total = accumulate_exact(
            table, db_post[0], row_off[0], e_hi[0], e_lo[0], e_read[0],
            R=R, B=B, P=Pb, seed1=s1, seed2=s2,
        )
        first, V, a_total = accumulate_amb_firsthit(
            table, db_post[0], row_off[0], a_hi[0], a_lo[0], a_read[0], a_order[0],
            R=R, B=B, PA=PAb, k=k, seed1=s1, seed2=s2, eps=eps,
        )
        S = jax.lax.psum(S, MODEL_AXIS)
        C = jax.lax.psum(C, MODEL_AXIS)
        first_g = jax.lax.pmin(first, MODEL_AXIS)
        hit = first_g < _ORDER_INF
        owner = (first == first_g) & hit
        V_g = jax.lax.psum(jnp.where(owner, V, 0.0), MODEL_AXIS)
        S = S + jnp.where(hit, V_g, 0.0)
        C = C + hit.astype(jnp.int32)
        outs = finish_scores(S, C, m[0], B=B, K=K, k=k, log_eps=log_eps)
        e_tot = jax.lax.pmax(e_total, MODEL_AXIS)
        a_tot = jax.lax.pmax(a_total, MODEL_AXIS)
        # slim pack + totals row: counts are not in the jplace
        # format and wr derives from (scores, log_sum) host-side, so the
        # CSR wire carries 2K+3 columns like the dense shifted paths
        return _pack_outputs_slim_totals(outs, e_tot, a_tot)[None]

    spec_model = P(MODEL_AXIS)
    spec_data = P(DATA_AXIS)
    return jax.shard_map(
        block,
        mesh=mesh,
        in_specs=(spec_model,) * 5 + (spec_data,) * 8,
        out_specs=spec_data,
        check_vma=False,
    )(
        seed1[:, None], seed2[:, None], t_packed, db_post, row_off,
        e_hi, e_lo, e_read, a_hi, a_lo, a_read, a_order, m_f32,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "R", "B", "K", "Pb", "k", "Lmax", "log_eps",
                     "eps"),
)
def _sharded_csr_bytes_step(
    seed1, seed2, t_packed, db_post, row_off, buf, *,
    mesh, R: int, B: int, K: int, Pb: int, k: int, Lmax: int,
    log_eps: float, eps: float,
):
    """Hash-sharded CSR step with ON-DEVICE tokenization.

    Clean DNA batches ship only the packed read buffer (the same native
    one-pass staging as the dense/tile sharded paths,
    ``eh_pack_reads``); window keys, their 32/32 halves, and the sorted
    read-id stream are derived on every shard from the replicated
    buffer.  Invalid windows take the all-ones sentinel key, which
    misses the cuckoo table exactly like the host path's padding
    (``_pad_split``).  Ambiguous batches fall back to the host-staged
    :func:`_sharded_csr_step` (quirks Q6/Q7 need the expansion
    streams)."""

    def block(seed1, seed2, t_packed, db_post, row_off, buf):
        i32 = jnp.int32
        u32 = jnp.uint32
        f32 = jnp.float32
        table = t_packed[0]
        s1 = seed1[0, 0]
        s2 = seed2[0, 0]
        key, ok, _c, lens = _tokenize_core(buf, k=k, Lmax=Lmax)
        W = key.shape[1]
        e_hi = jnp.where(ok, u32(0), u32(0xFFFFFFFF)).reshape(-1)
        e_lo = jnp.where(ok, key, u32(0xFFFFFFFF)).reshape(-1)
        e_read = jax.lax.broadcasted_iota(i32, (R, W), 0).reshape(-1)
        S, C, e_total = accumulate_exact(
            table, db_post[0], row_off[0], e_hi, e_lo, e_read,
            R=R, B=B, P=Pb, seed1=s1, seed2=s2,
        )
        S = jax.lax.psum(S, MODEL_AXIS)
        C = jax.lax.psum(C, MODEL_AXIS)
        m_f32 = _window_count_f32(lens, k)
        outs = finish_scores(S, C, m_f32, B=B, K=K, k=k, log_eps=log_eps)
        e_tot = jax.lax.pmax(e_total, MODEL_AXIS)
        return _pack_outputs_slim_totals(outs, e_tot, jnp.int32(0))[None]

    return jax.shard_map(
        block,
        mesh=mesh,
        in_specs=(P(MODEL_AXIS),) * 5 + (P(DATA_AXIS),),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )(seed1[:, None], seed2[:, None], t_packed, db_post, row_off, buf)


# ---------------------------------------------------------------------------
# the placer
# ---------------------------------------------------------------------------


class ShardedJaxPlacer(HostStaging):
    """Multi-device placer: same ``place``/``place_async``/``place_wait``
    surface as JaxPlacer, so the in-flight batch pipeline
    (engine/pipeline.py) drives both identically.  Host staging (native
    tokenizer + threaded key->row lookup) is shared with JaxPlacer via
    HostStaging -- an n-device data axis multiplies device throughput, so the
    host side must not fall back to single-threaded pure-Python paths."""

    def __init__(
        self,
        db: PhyloKmerDB,
        tree: PhyloTree,
        mesh,
        keep_at_most: int | None = None,
        keep_factor: float | None = None,
        config: PlacerConfig | None = None,
    ):
        self.db = db
        self.tree = tree
        self.mesh = mesh
        self.n_data = mesh.shape[DATA_AXIS]
        self.n_model = mesh.shape[MODEL_AXIS]
        # copy: never mutate a caller-supplied config; explicit kwargs win
        self.config = dataclasses.replace(config) if config else PlacerConfig()
        if keep_at_most is not None:
            self.config.keep_at_most = keep_at_most
        if keep_factor is not None:
            self.config.keep_factor = keep_factor
        self.alphabet = get_alphabet(db.sequence_type)
        self.k = db.kmer_size
        self.B = tree.get_node_count()
        self._init_staging()
        #: CSR budget-overflow re-dispatches (observability; tests assert on it)
        self.overflow_retries = 0
        self.eps = np.float32(score_threshold(db.omega, self.k, self.alphabet.sigma))
        self.log_eps = np.float32(np.log10(self.eps))
        num, tot = tree.tree_index()
        self.distal = tree.branch_lengths / 2.0
        mean = np.where(num > 1, tot / np.maximum(num, 1), 0.0)
        self.pendant = mean + self.distal

        cfg = self.config
        # memory budgets: unset ones are shares of the (local) device's pool
        dense_budget, pair_budget, _ = device_memory_budgets()
        if cfg.dense_db_budget is None:
            cfg.dense_db_budget = dense_budget
        if cfg.pair_plane_budget is None:
            cfg.pair_plane_budget = pair_budget
        bwl = -(-self.B // (128 * self.n_model)) * 128
        # per-DEVICE plane bytes decide fit: column sharding divides the
        # plane by n_model, which is what lets big trees go dense
        plane_bytes = (db.num_kmers + 1) * bwl * 4
        cfgd = cfg.dense_db
        self._dense_db = cfgd == "on" or (
            cfgd == "auto" and plane_bytes <= cfg.dense_db_budget
        )

        # shifted single-reduce mode: same validity guard as JaxPlacer
        # (all stored scores >= log10(eps) -- the load contract, quirk Q10)
        self._shifted = (
            self._dense_db
            and cfg.plane_mode == "shifted"
            and cfg.precision == "exact"
            and (db.scores.size == 0
                 or float(db.scores.min()) >= float(self.log_eps))
        )
        self._paired = False
        self._dev_combo = None
        self._tiles_mode = False
        self._tile_scale = 0.0
        self._tile_pt = 0
        self._tile_pt_ov = 0
        self._tile_n_ov = 0
        self._tile_frac_over = 0.0
        self._dev_direct = None
        self._dev_tiles = None
        self._dev_tiles_ov = None
        if self._dense_db:
            planes, self._bwl = shard_db_columns(
                db, self.n_model, self.B,
                shifted=self._shifted, log_eps=float(self.log_eps),
            )
            self._fast_bytes = (
                cfg.tokenize_where in ("auto", "device")
                and self.alphabet.sigma == 4
                and self.k <= 13
            )
            self._dev_direct = None
            direct = None
            if self._fast_bytes:
                direct = np.full(4**self.k, db.num_kmers, dtype=np.int32)
                direct[db.keys.astype(np.int64)] = np.arange(
                    db.num_kmers, dtype=np.int32
                )
                self._dev_direct = jax.device_put(direct, NamedSharding(mesh, P()))
            # (k+1)-mer pair plane, column-sharded: each shard's pair rows
            # are the column slices of the global pair rows (sums compose
            # per column), so the single-chip identity carries over shard
            # by shard.  Budget is PER-DEVICE bytes, like the dense gate.
            if (
                self._fast_bytes
                and self._shifted
                and cfg.pair_plane in ("auto", "on")
                and self.k + 1 <= 13
                and db.num_kmers > 0
            ):
                n_keys = db.num_kmers
                pu, pv, key11 = enumerate_pairs(db.keys, self.k, direct, n_keys)
                n_pairs = int(pu.shape[0])
                paired_bytes = (n_keys + 1 + n_pairs) * self._bwl * 4
                if n_pairs > 0 and (
                    paired_bytes <= cfg.pair_plane_budget
                    or cfg.pair_plane == "on"
                ):
                    d11 = np.full(4 ** (self.k + 1), -1, dtype=np.int32)
                    d11[key11] = n_keys + 1 + np.arange(n_pairs, dtype=np.int32)
                    self._dev_combo = jax.device_put(
                        build_combo_table(direct, d11, self.k, n_keys),
                        NamedSharding(mesh, P()),
                    )
                    full = np.zeros(
                        (self.n_model, n_keys + 1 + n_pairs, self._bwl),
                        planes.dtype,
                    )
                    full[:, : n_keys + 1] = planes
                    CH = 1 << 16
                    for s in range(0, n_pairs, CH):
                        full[:, n_keys + 1 + s : n_keys + 1 + s + CH] = (
                            planes[:, pu[s : s + CH]] + planes[:, pv[s : s + CH]]
                        )
                    planes = full
                    self._paired = True
            # 2D column-sharded layout (N, n_model*bwl): shard m's columns
            # are [m*bwl, (m+1)*bwl).  With a stacked (n_model, N, bwl)
            # layout and plane[0] inside shard_map, the leading unit dim
            # survives into the gather's operand layout; the 2D form keeps
            # the single-device gather shape.
            plane2d = np.ascontiguousarray(
                planes.transpose(1, 0, 2).reshape(planes.shape[1], -1)
            )
            del planes
            self._plane_cols = jax.device_put(
                plane2d, NamedSharding(mesh, P(None, MODEL_AXIS))
            )
            self._sdb = None
        else:
            self._fast_bytes = False
            sdb = shard_db_by_hash(db, self.n_model)
            self._sdb = sdb
            spec_m = NamedSharding(mesh, P(MODEL_AXIS))
            self._dev_packed = jax.device_put(sdb.packed, spec_m)
            self._dev_postings = jax.device_put(sdb.postings, spec_m)
            self._dev_row_off = jax.device_put(sdb.row_off, spec_m)
            self._seed1 = np.array([s[0] for s in sdb.seeds], dtype=np.uint32)
            self._seed2 = np.array([s[1] for s in sdb.seeds], dtype=np.uint32)
            # posting-TILE mode (big trees across devices): column-sharded
            # tiles + per-shard accumulate; CSR stays resident as the
            # ambiguous-batch fallback.  Same gates as the engine's
            # single-device tiles mode (engine/placer.py).
            lens = np.diff(db.row_off)
            max_plen = int(lens.max()) if lens.size else 0
            shift_ok = (db.scores.size == 0
                        or float(db.scores.min()) >= float(self.log_eps))
            if (
                cfg.tokenize_where in ("auto", "device")
                and cfg.precision == "exact"
                and self.alphabet.sigma == 4
                and self.k <= 13
                and shift_ok
                and db.num_kmers > 0
                and 0 < max_plen <= 128
            ):
                (tiles, bwl_t, PT, t_scale, tiles_ov, PT_OV, n_ov,
                 frac_over, perm) = shard_tiles_columns(
                    db, self.n_model, self.B, float(self.log_eps)
                )
                if tiles.nbytes // self.n_model <= cfg.dense_db_budget:
                    self._tiles_mode = True
                    self._tile_pt = PT
                    self._tile_scale = t_scale
                    self._tile_pt_ov = PT_OV
                    self._tile_n_ov = n_ov
                    self._tile_frac_over = frac_over
                    self._bwl = bwl_t
                    self._dev_tiles = jax.device_put(tiles, spec_m)
                    self._dev_tiles_ov = (
                        jax.device_put(tiles_ov, spec_m)
                        if tiles_ov is not None else None
                    )
                    # the two-level permutation (overflow keys -> rows
                    # [0, n_ov)) rides in the shared direct table
                    direct = np.full(4**self.k, db.num_kmers, dtype=np.int32)
                    direct[db.keys.astype(np.int64)] = perm.astype(np.int32)
                    self._dev_direct = jax.device_put(
                        direct, NamedSharding(mesh, P())
                    )

    def _padded_batch_geometry(self, R_true: int) -> int:
        """Per-data-shard read count, bucketed to bound the jit cache."""
        per = -(-R_true // self.n_data)
        gran = 256 if R_true > 2048 else 64
        return -(-per // gran) * gran

    # -- placement surface ---------------------------------------------------

    def place(self, records: list[tuple[str, bytes]]) -> PlacedCollection:
        """Synchronous place (reference surface: place.cpp:201)."""
        return self.place_wait(self.place_async(records))

    def place_async(self, records: list[tuple[str, bytes]]):
        """Tokenize + dispatch WITHOUT blocking on device results."""
        cfg = self.config
        sequence_map: dict[bytes, list[str]] = {}
        for header, seq in records:
            sequence_map.setdefault(seq, []).append(header)
        seqs = list(sequence_map.keys())
        if not seqs:
            return _Pending(sequence_map, [], None, None, None, None)

        if self._dense_db:
            return self._place_async_dense(sequence_map, seqs)
        if self._tiles_mode:
            pending = self._place_async_tiles(sequence_map, seqs)
            if pending is not None:
                return pending
        return self._place_async_csr(sequence_map, seqs)

    def _place_async_tiles(self, sequence_map, seqs):
        """Column-sharded posting-tile dispatch (big trees); returns None
        for batches the mode cannot take (ambiguity, len < k) -- the CSR
        path handles those."""
        cfg = self.config
        R_true = len(seqs)
        R_loc = self._padded_batch_geometry(R_true)
        R_tot = self.n_data * R_loc
        K = min(cfg.keep_at_most, self.B)
        lens_arr = np.fromiter((len(s) for s in seqs), np.int64, count=R_true)
        m_signed = lens_arr - self.k + 1
        Lmax_true = int(lens_arr.max())
        if not (self.k <= Lmax_true <= 0xFFFF):
            return None
        Lmax = _bucket_lmax(Lmax_true)
        # packed-tile exactness gate (same as the single-device engine,
        # engine/placer.py::_stage_bytes): per-(read, branch) integer sums
        # are bounded by W * 64000 and must fit the int32 accumulator --
        # longer reads take the CSR fallback
        if self._tile_scale > 0.0 and (Lmax - self.k + 1) * 64000 >= (1 << 31):
            return None
        flat = np.frombuffer(b"".join(seqs), np.uint8)
        starts = np.concatenate([[0], np.cumsum(lens_arr)])
        mat = np.zeros((R_tot, Lmax), np.uint8)
        mat[np.repeat(np.arange(R_true), lens_arr),
            np.arange(flat.size) - np.repeat(starts[:-1], lens_arr)] = flat
        codes = self.alphabet.char_code[mat]
        if ((codes >= 0x80) & (codes != 0xFF)).any():
            return None  # ambiguity: the CSR fallback handles quirks Q6/Q7
        lens_pad = np.zeros(R_tot, np.int64)
        lens_pad[:R_true] = lens_arr
        buf = pack_reads(codes, lens_pad)
        if self._tile_pt_ov > 0:
            W = Lmax - self.k + 1
            OV = min(W, _bucket(
                max(8, int(W * self._tile_frac_over * 2.0) + 4), 8))

            def fn_ov(OV_, _W=W):
                return functools.partial(
                    _sharded_tiles_bytes_step,
                    mesh=self.mesh, R=R_loc, B=self.B, bwl=self._bwl, K=K,
                    k=self.k, Lmax=Lmax, num_kmers=self.db.num_kmers,
                    PT=self._tile_pt, tile_scale=float(self._tile_scale),
                    PT_OV=self._tile_pt_ov, OV=min(OV_, _W),
                    N_OV=self._tile_n_ov,
                    log_eps=float(self.log_eps), eps=float(self.eps),
                )

            arrays = (self._dev_tiles, self._dev_direct, buf,
                      self._dev_tiles_ov)
            out = fn_ov(OV)(*arrays)
            return _Pending(sequence_map, seqs, m_signed, out,
                            ("tiles_ov", OV, fn_ov, arrays),
                            (None, R_true, K))
        out = _sharded_tiles_bytes_step(
            self._dev_tiles, self._dev_direct, buf,
            mesh=self.mesh, R=R_loc, B=self.B, bwl=self._bwl, K=K,
            k=self.k, Lmax=Lmax, num_kmers=self.db.num_kmers,
            PT=self._tile_pt, tile_scale=float(self._tile_scale),
            log_eps=float(self.log_eps), eps=float(self.eps),
        )
        return _Pending(sequence_map, seqs, m_signed, out, None, (None, R_true, K))

    # -- dense (column-sharded) dispatch --------------------------------------

    def _place_async_dense(self, sequence_map, seqs):
        cfg = self.config
        R_true = len(seqs)
        R_loc = self._padded_batch_geometry(R_true)
        R_tot = self.n_data * R_loc
        K = min(cfg.keep_at_most, self.B)

        lens_arr = np.fromiter((len(s) for s in seqs), np.int64, count=R_true)
        m_signed = lens_arr - self.k + 1  # host copy for assembly (quirk Q1)
        Lmax_true = int(lens_arr.max())

        if self._fast_bytes and self.k <= Lmax_true <= 0xFFFF:
            Lmax = _bucket_lmax(Lmax_true)
            # one native staging pass (pack + char-code map + ambiguity
            # scan; HostStaging._pack_reads_fast)
            buf, amb_mask = self._pack_reads_fast(seqs, lens_arr, Lmax,
                                                  R_tot)
            if amb_mask.any():
                idxs = np.flatnonzero(amb_mask)
                tok = self._tokenize([seqs[i] for i in idxs])
                a_keys = tok.amb_keys
                a_read = idxs[tok.amb_read] if a_keys.size else tok.amb_read
                apr = int(np.bincount(a_read, minlength=R_tot).max()) if a_keys.size else 0
                Amax = _bucket(apr, 8) if a_keys.size else 0
                arows = self._rows_matrix(a_keys, a_read, R_tot, Amax)
            else:
                Amax = 0
                arows = np.zeros((R_tot, 0), np.int32)
            if self._paired:
                out = _sharded_dense_paired_step(
                    self._plane_cols, self._dev_combo,
                    buf, arows,
                    mesh=self.mesh, R=R_loc, B=self.B, bwl=self._bwl, K=K,
                    Amax=Amax, k=self.k, Lmax=Lmax,
                    num_kmers=self.db.num_kmers,
                    log_eps=float(self.log_eps), eps=float(self.eps),
                )
            else:
                out = _sharded_dense_bytes_step(
                    self._plane_cols, self._dev_direct, buf, arows,
                    mesh=self.mesh, R=R_loc, B=self.B, bwl=self._bwl, K=K,
                    Amax=Amax, k=self.k, Lmax=Lmax, num_kmers=self.db.num_kmers,
                    log_eps=float(self.log_eps), eps=float(self.eps),
                    shifted=self._shifted,
                )
            return _Pending(sequence_map, seqs, m_signed, out, None, (None, R_true, K))

        # host tokenize + host lookup (any alphabet / k; also len<k batches)
        tokens = self._tokenize(seqs)
        wpr = int(np.bincount(tokens.exact_read, minlength=R_tot).max()) if tokens.exact_read.size else 1
        apr = int(np.bincount(tokens.amb_read, minlength=R_tot).max()) if tokens.amb_read.size else 1
        Wmax = max(16, -(-wpr // 16) * 16)
        Amax = _bucket(apr, 8) if tokens.amb_keys.size else 0
        rows = self._rows_matrix(tokens.exact_keys, tokens.exact_read, R_tot, Wmax)
        arows = self._rows_matrix(tokens.amb_keys, tokens.amb_read, R_tot, Amax)
        m_f32 = np.where(
            m_signed >= 0,
            m_signed.astype(np.float32),
            np.float32(float(_U64)) + m_signed.astype(np.float32),
        ).astype(np.float32)
        m_pad = np.zeros(R_tot, np.float32)
        m_pad[:R_true] = m_f32
        out = _sharded_dense_rows_step(
            self._plane_cols, rows, arows, m_pad,
            mesh=self.mesh, R=R_loc, B=self.B, bwl=self._bwl, K=K,
            Wmax=Wmax, Amax=Amax, k=self.k,
            log_eps=float(self.log_eps), eps=float(self.eps),
            shifted=self._shifted,
        )
        return _Pending(sequence_map, seqs, m_signed, out, None, (None, R_true, K))

    # -- CSR (hash-sharded) dispatch -------------------------------------------

    def _place_async_csr(self, sequence_map, seqs):
        cfg = self.config
        R_true = len(seqs)
        R_loc = self._padded_batch_geometry(R_true)
        R_tot = self.n_data * R_loc
        K = min(cfg.keep_at_most, self.B)
        nd = self.n_data

        # device-tokenize fast path: clean DNA batches ship only
        # the packed byte buffer, like the dense/tile sharded paths
        if (
            self._sdb is not None
            and cfg.tokenize_where in ("auto", "device")
            and self.alphabet.sigma == 4
            and self.k <= 16
        ):
            lens_arr = np.fromiter((len(s) for s in seqs), np.int64,
                                   count=R_true)
            Lmax_true = int(lens_arr.max())
            if self.k <= Lmax_true <= 0xFFFF:
                Lmax = _bucket_lmax(Lmax_true)
                buf, amb_mask = self._pack_reads_fast(seqs, lens_arr, Lmax,
                                                      R_tot)
                if not amb_mask.any():
                    W = Lmax - self.k + 1
                    est = max(1, int(self._sdb.avg_plen
                                     * cfg.budget_headroom))
                    Pb = _bucket(
                        max(1, R_loc * W * est // max(1, self.n_model)),
                        cfg.min_bucket,
                    )
                    inputs = (
                        jnp.asarray(self._seed1), jnp.asarray(self._seed2),
                        self._dev_packed, self._dev_postings,
                        self._dev_row_off, buf,
                    )
                    out = _sharded_csr_bytes_step(
                        *inputs, mesh=self.mesh, R=R_loc, B=self.B, K=K,
                        Pb=Pb, k=self.k, Lmax=Lmax,
                        log_eps=float(self.log_eps), eps=float(self.eps),
                    )
                    m_signed = lens_arr - self.k + 1
                    return _Pending(
                        sequence_map, seqs, m_signed, out,
                        (Pb, 0, "bytes", Lmax), (inputs, R_true, K),
                    )

        groups = [seqs[g * R_loc : (g + 1) * R_loc] for g in range(nd)]
        toks = [self._tokenize(g) for g in groups]
        m_signed = np.concatenate(
            [t.seq_lengths - self.k + 1 for t in toks]
        ) if any(t.seq_lengths.size for t in toks) else np.empty(0, np.int64)

        E = _bucket(max(t.exact_keys.shape[0] for t in toks), cfg.min_bucket)
        A = _bucket(max(t.amb_keys.shape[0] for t in toks), cfg.min_bucket)
        est = max(1, int(self._sdb.avg_plen * cfg.budget_headroom))
        # each model shard owns ~1/n_model of the postings
        Pb = _bucket(max(1, E * est // max(1, self.n_model)), cfg.min_bucket)
        PAb = _bucket(max(1, A * est // max(1, self.n_model)), cfg.min_bucket)

        def pad_group(t):
            e_hi, e_lo = _pad_split(t.exact_keys, E)
            a_hi, a_lo = _pad_split(t.amb_keys, A)
            ms = t.seq_lengths - self.k + 1
            m_f32 = np.where(
                ms >= 0,
                ms.astype(np.float32),
                np.float32(float(_U64)) + ms.astype(np.float32),
            ).astype(np.float32)
            m_pad = np.zeros(R_loc, np.float32)
            m_pad[: m_f32.shape[0]] = m_f32
            return (
                e_hi, e_lo, _pad_i32(t.exact_read, E, R_loc),
                a_hi, a_lo, _pad_i32(t.amb_read, A, R_loc),
                _pad_i32(t.amb_order, A, _ORDER_INF), m_pad,
            )

        padded = [pad_group(t) for t in toks]
        stacked = tuple(np.stack([p[i] for p in padded]) for i in range(8))
        inputs = (
            jnp.asarray(self._seed1), jnp.asarray(self._seed2),
            self._dev_packed, self._dev_postings, self._dev_row_off,
        ) + stacked
        out = _sharded_csr_step(
            *inputs, mesh=self.mesh, R=R_loc, B=self.B, K=K, Pb=Pb, PAb=PAb,
            k=self.k, log_eps=float(self.log_eps), eps=float(self.eps),
        )
        return _Pending(
            sequence_map, seqs, m_signed, out, (Pb, PAb), (inputs, R_true, K)
        )

    # -- wait + assembly ---------------------------------------------------------

    @staticmethod
    def _fetch(out) -> np.ndarray:
        """Device->host fetch that works single- and multi-process.

        On a multi-host mesh the result array spans non-addressable devices;
        ``process_allgather`` exchanges the data-axis shards so EVERY
        process sees the full batch (each rank can then run its own
        assembly/writer; multi-host init: parallel/mesh.py::init_distributed).
        """
        if getattr(out, "is_fully_addressable", True):
            return np.asarray(out)
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(out, tiled=True))

    def place_wait(self, pending: _Pending) -> PlacedCollection:
        if pending.out is None:
            return PlacedCollection(sequence_map=pending.sequence_map, placed_seqs=[])
        cfg = self.config
        inputs, R_true, K = pending.redo
        R_loc = self._padded_batch_geometry(R_true)

        if pending.budgets is not None and pending.budgets[0] == "tiles_ov":
            # two-level sharded tiles: the last result column carries each
            # read's true overflow-window count; a read above the static
            # OV budget re-dispatches with a bigger budget (exactness by
            # retry, shared design with the single-chip engine)
            _, OV, fn_ov, arrays = pending.budgets
            out = pending.out
            while True:
                arr = self._fetch(out)
                ovmax = int(arr[:, :, -1].max()) if arr.size else 0
                if ovmax <= OV:
                    break
                self.overflow_retries += 1
                OV = _bucket(ovmax, 8)  # fn_ov clamps to the window count
                out = fn_ov(OV)(*arrays)
            flat = arr[:, :, :-1].reshape(self.n_data * R_loc, -1)[:R_true]
            return self._assemble_flat(pending, flat, K)
        if pending.budgets is None:  # dense mode: no overflow retries
            # one transfer: (n_data, R_loc, 2K+3) slim (shifted paths) or
            # (n_data, R_loc+1, 4K+2) full incl. a totals row (classic)
            arr = self._fetch(pending.out)
            if arr.shape[2] == 2 * K + 3:
                flat = arr.reshape(self.n_data * R_loc, -1)[:R_true]
            else:
                flat = arr[:, :-1, :].reshape(self.n_data * R_loc, -1)[:R_true]
            return self._assemble_flat(pending, flat, K)

        Pb, PAb, *kind = pending.budgets
        bytes_mode = bool(kind) and kind[0] == "bytes"
        out = pending.out
        while True:
            arr = self._fetch(out)
            totals = arr[:, -1, :]
            e_tot = max(
                (int(t[0]) << 20) + int(t[1]) for t in totals
            )
            a_tot = max(
                (int(t[2]) << 20) + int(t[3]) for t in totals
            )
            if e_tot <= Pb and a_tot <= PAb:
                break
            # budget overflow: grow the static bucket and re-dispatch the
            # SAME already-stacked host arrays (no restaging).  The uniform
            # Pb estimate assumes balanced posting mass across hash shards;
            # a hot shard (skewed posting lengths) lands here.
            self.overflow_retries += 1
            Pb = _bucket(int(e_tot), cfg.min_bucket) if e_tot > Pb else Pb
            PAb = _bucket(int(a_tot), cfg.min_bucket) if a_tot > PAb else PAb
            if bytes_mode:
                out = _sharded_csr_bytes_step(
                    *inputs, mesh=self.mesh, R=R_loc, B=self.B, K=K,
                    Pb=Pb, k=self.k, Lmax=kind[1],
                    log_eps=float(self.log_eps), eps=float(self.eps),
                )
            else:
                out = _sharded_csr_step(
                    *inputs, mesh=self.mesh, R=R_loc, B=self.B, K=K, Pb=Pb,
                    PAb=PAb, k=self.k, log_eps=float(self.log_eps),
                    eps=float(self.eps),
                )
        flat = arr[:, :-1, :].reshape(self.n_data * R_loc, -1)[:R_true]
        return self._assemble_flat(pending, flat, K)

    def _assemble_flat(self, pending, body: np.ndarray, K: int):
        """Array-backed jplace rows from the flattened body: the slim
        (R_true, 2K+3) pack of the shifted paths or the full (R_true,
        4K+2) pack (shared vectorized assembly: engine/placer.py)."""
        if body.shape[1] == 2 * K + 3:
            (scores_k, idx_k, counts_k, wr_k, n_touched, zero_sum,
             _, _) = unpack_outputs_slim(body, K)
            counts_k = counts_k.astype(np.int64)
        else:
            scores_k = body[:, 0:K]
            wr_k = body[:, K : 2 * K].astype(np.float64)
            idx_k = body[:, 2 * K : 3 * K].astype(np.int32)
            counts_k = body[:, 3 * K : 4 * K].astype(np.int64)
            n_touched = body[:, 4 * K].astype(np.int32)
            zero_sum = body[:, 4 * K + 1] != 0
        return assemble_arrays(
            pending.seqs, pending.sequence_map, pending.m_signed,
            scores_k, idx_k, counts_k, wr_k, n_touched, zero_sum, K,
            distal=self.distal, pendant=self.pendant, log_eps=self.log_eps,
            k=self.k, B=self.B, keep_at_most=self.config.keep_at_most,
            keep_factor=self.config.keep_factor,
        )


def _pad_split(keys: np.ndarray, size: int):
    padded = np.full(size, _SENTINEL_KEY, dtype=np.uint64)
    padded[: keys.shape[0]] = keys
    return (
        (padded >> np.uint64(32)).astype(np.uint32),
        (padded & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )


def _pad_i32(arr: np.ndarray, size: int, fill: int):
    padded = np.full(size, fill, dtype=np.int32)
    padded[: arr.shape[0]] = arr
    return padded
