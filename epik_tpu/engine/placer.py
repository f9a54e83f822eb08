"""Placement engine: the jit-compiled lookup/score/top-k pipeline.

This replaces the reference's hot loop -- the per-read OpenMP ``place_seq``
with its hash-map probes and scalar scatter-adds (reference:
epik/src/epik/place.cpp:201-275,320-440) -- with one static-shaped XLA
program over a whole batch:

    host: dedup + tokenize           (core/kmers.py; quirk Q8)
    device:
      1. cuckoo lookup of all window keys        (ops/hashtable.py)
      2. ragged expansion of posting lists       (ops/expand.py)
      3. dense segment scatter-add of (read, branch) scores and counts
         -- the analog of intrinsic.h's SIMD update_vector
      4. ambiguous first-hit selection via scatter-min over processing
         order (quirks Q6/Q7 in closed form: only the first expanded key
         touching a branch contributes (10**s + (k-1)*eps)/k)
      5. score correction, LWR logsumexp over all branches (quirk Q4),
         top-k selection
    host: fallback fabrication (quirk Q2/Q3), keep-factor filter,
          distal/pendant gather, jplace row assembly

Numerics: scores accumulate in float32 like the reference; the LWR sum
uses a log-sum-exp (exact in the regime where the reference's double
``pow(10, s)`` underflows -- differences are far below the 1e-4
probability-space parity tolerance, scripts/jplace_diff.py:21,222).
The reference's double-pow underflow-to-zero behavior (quirk Q3) is
reproduced via an explicit exponent cutoff at -323.6 (the point where
``pow(10, x)`` rounds to 0.0 in IEEE double).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.alphabet import get_alphabet
from ..core.kmers import tokenize_batch
from ..core.scoring import score_threshold
from ..core.tree import PhyloTree
from ..io.db import PhyloKmerDB
from ..ops.accumulate import segment_sums, segment_sums_packed, trash_branch
from ..ops.expand import ragged_expand
from ..ops.hashtable import build_table, lookup
from .types import ArrayPlacedCollection, PlacedCollection

__all__ = ["JaxPlacer", "PlacerConfig"]

_U64 = 1 << 64
#: exponent below which IEEE-double 10**x rounds to exactly 0.0
#: (reference computes pow in double: place.h:29, place.cpp:39-48)
_POW10_ZERO = -323.6
_SENTINEL_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)

#: shares of the device memory pool (``memory_stats()["bytes_limit"]``)
#: given to the dense plane, to the combined (base + pair) plane, and the
#: hard cap of a forced (``pair_plane="on"``) combined plane; the rest is
#: the step's working set
_DENSE_SHARE, _PAIR_SHARE, _PAIR_CAP_SHARE = 6 / 16, 10 / 16, 14 / 16
#: pool assumed when a device reports no memory statistics (the CPU
#: backend): 16 GiB, i.e. budgets of 6, 10 and 14 GiB
_DEFAULT_POOL = 16 << 30


def device_memory_budgets(device=None) -> tuple[int, int, int]:
    """(dense_db_budget, pair_plane_budget, pair_plane_cap) in bytes: fixed
    shares of the device's memory pool, or of 16 GiB when the device
    reports none.  ``device`` defaults to the first local device."""
    dev = device if device is not None else jax.local_devices()[0]
    stats = dev.memory_stats()
    pool = int(stats["bytes_limit"]) if stats and "bytes_limit" in stats else _DEFAULT_POOL
    return (int(pool * _DENSE_SHARE), int(pool * _PAIR_SHARE),
            int(pool * _PAIR_CAP_SHARE))


@dataclasses.dataclass
class PlacerConfig:
    keep_at_most: int = 7  # reference default: main.cpp:219
    keep_factor: float = 0.01  # reference default: main.cpp:220
    #: posting-budget headroom over the average posting length estimate
    budget_headroom: float = 2.0
    #: minimum padded stream size (keeps zero-size arrays out of XLA)
    min_bucket: int = 16
    #: dense-database mode: store the DB as dense (num_keys+1, B) score +
    #: indicator planes so the hot loop is contiguous row gathers ("auto" =
    #: on when the planes fit dense_db_budget bytes; "on"/"off" force)
    dense_db: str = "auto"
    #: bytes for the dense plane (and for the posting tiles); None = a
    #: share of device memory (:func:`device_memory_budgets`)
    dense_db_budget: int | None = None
    #: host worker threads for tokenization (the reference's -j surface,
    #: main.cpp:213; the C++ tokenizer releases the GIL so threads scale)
    host_threads: int = 1
    #: dense-plane precision: "exact" keeps float32 scores (bit-parity with
    #: the scalar accumulation); "bf16" halves the gathered bytes at ~0.4%
    #: relative score error -- top-edge rankings are almost always
    #: unchanged but log-likelihoods drift beyond the 1e-4 parity
    #: tolerance, so it is opt-in; "int16" (requires/implies the shifted
    #: plane) also halves the gathered bytes but quantizes s - log10(eps)
    #: onto a uniform 32000-step grid instead: worst-case per-cell error is
    #: (-log_eps)/64000 (~3.3e-5 log10 units at k=10 nucl defaults, ~150x
    #: tighter than bf16's relative rounding), accumulation is EXACT int32
    #: arithmetic, and one f32 divide at the end recovers log10 units --
    #: parity-clean on the mixed verify gate where bf16 is not
    precision: str = "exact"
    #: key->row lookup placement for the dense single-device path: "host"
    #: resolves keys with a threaded binary search over the sorted key array
    #: on the CPU (overlapped with device compute by the in-flight batch
    #: loop) instead of the device cuckoo lookup; "device" keeps the
    #: on-device cuckoo lookup; "auto" = host
    lookup_where: str = "auto"
    #: window tokenization placement for the dense path: "device" ships the
    #: raw read bytes (one small uint8 array) and computes window keys with
    #: shifted adds + a direct-address key->row table on the device -- the
    #: host does no per-window work at all.  Requires DNA (sigma=4) and
    #: k <= 13 (direct table = 4**k int32).  Reads containing ambiguous
    #: characters still produce their ambiguity stream on the host (the
    #: rare path).  "host" forces the classic host tokenizer; "auto" =
    #: device when supported.
    tokenize_where: str = "auto"
    #: dense-plane scoring formulation:
    #: * "classic" -- plane holds the stored log10 scores; the device derives
    #:   per-branch counts C from the same gather (``g != 0``) and computes
    #:   corrected = (S + (m - C) * log_eps) / k.  Exact per-branch counts
    #:   come out for free in the results.
    #: * "shifted" -- plane holds s - log10(eps) (> 0 where present, 0
    #:   absent), so the count term cancels algebraically:
    #:   corrected = (S' + m * log_eps) / k with S' the plain row sum, and
    #:   touched == S' > 0.  The per-window count reduce disappears
    #:   entirely -- the hot loop is ONE gather + ONE reduce.  Scores stay
    #:   within ~1e-5 log10 units of classic (each stored cell rounds
    #:   s - log_eps once to f32), far inside the 1e-4 probability-space
    #:   parity gate; per-branch counts are NOT computed (reported as -1;
    #:   the jplace format never serializes counts, jplace.cpp:121-140).
    #: "shifted" is the default; "classic" remains for exact per-branch
    #: counts.
    plane_mode: str = "shifted"
    #: (k+1)-mer PAIR plane for the shifted device-tokenize path: halves
    #: the number of rows gathered.  "auto"/"on" precompute one plane row
    #: per (k+1)-mer whose prefix AND suffix k-mers are both in the DB (row
    #: = f32 sum of the two shifted rows) and gather ONE row per two
    #: windows.  Key identity (holds for any DB and any read, by
    #: enumeration of all 4 suffix extensions): a pair MISS implies at most
    #: one of the two windows hits, so every 2-window slot needs exactly
    #: one gather -- the row count halves unconditionally, no dynamic
    #: compaction.  Requires the bytes fast path (DNA, k <= 12 so the
    #: 4**(k+1) direct table fits), shifted mode, f32 plane, and the
    #: combined plane within pair_plane_budget; "auto" silently falls back
    #: when any condition fails, "off" disables.
    pair_plane: str = "auto"
    #: bytes for the COMBINED (base + pair) plane; None = a share of device
    #: memory (:func:`device_memory_budgets`).  Separate from
    #: dense_db_budget: the pair count is DB-dependent (reference-contiguous
    #: DBs pair ~1.2x the key count; dense random key sets up to 4x).
    pair_plane_budget: int | None = None
    #: posting-tile payload (the big-tree path):
    #: * "packed" -- each tile cell is ONE int32 ``(branch << 16) | q`` with
    #:   q the shifted score on a 64000-step grid (per-cell error
    #:   (-log_eps)/128000, ~3.3e-5 log10 units at k=10 nucl defaults --
    #:   2x tighter than the int16 dense plane, which is parity-clean on
    #:   the verify gate).  Halves the tile gather bytes, and the int32
    #:   accumulate (ops/accumulate.py) is exact and independent of the
    #:   order of the adds.  Requires branch ids < 2**15.
    #: * "f32" -- (branch u32, score-bits u32) pairs: bit-exact stored
    #:   scores, f32 accumulate.
    #: * "auto" -- packed when branch ids fit, else f32.
    tile_payload: str = "auto"


def _bucket(n: int, lo: int) -> int:
    """Round up to a power of two (bounded jit-cache growth)."""
    return 1 << max(lo.bit_length() - 1, (max(n, 1) - 1).bit_length())


def _bucket_lmax(lmax_true: int) -> int:
    """Bucketed padded read length for the jit cache.

    Short reads (the reference's amplicon/Illumina regime) keep the tight
    8-multiple.  Long reads (nanopore, 2-10 kb) would otherwise compile a
    fresh program for nearly every FASTA batch -- there the granularity is
    1/16 of the magnitude (<= 12.5% window padding, ~16 cache entries per
    octave of read length)."""
    if lmax_true <= 512:
        return -(-lmax_true // 8) * 8
    gran = 1 << (lmax_true.bit_length() - 4)
    return -(-lmax_true // gran) * gran


@functools.partial(jax.jit, donate_argnums=(0,))
def _plane_fill(plane, start, vals):
    """In-place (donated) row-range write used by the pair-plane build."""
    return jax.lax.dynamic_update_slice(plane, vals, (start, jnp.int32(0)))


def enumerate_pairs_generic(keys: np.ndarray, k: int, sigma: int):
    """Generic-alphabet pair enumeration (no direct table): for each key u
    and each of the ``sigma`` suffix extensions c, the (k+1)-mer pair
    exists iff v = (u mod sigma**(k-1))*sigma + c is also a key -- found by
    binary search over the sorted key array.  Returns (pu, pv, key11)
    SORTED by key11 (the pair radix index requires sorted keys and its row
    answers are positions in that order)."""
    keys = keys.astype(np.uint64)
    n = keys.shape[0]
    suf_core = (keys % np.uint64(sigma ** (k - 1))) * np.uint64(sigma)
    pu_l, pv_l, k11_l = [], [], []
    for c in range(sigma):
        v = suf_core + np.uint64(c)
        pos = np.searchsorted(keys, v)
        pos_c = np.minimum(pos, max(n - 1, 0))
        m = keys[pos_c] == v
        pu_l.append(np.flatnonzero(m).astype(np.int32))
        pv_l.append(pos_c[m].astype(np.int32))
        k11_l.append(keys[m] * np.uint64(sigma) + np.uint64(c))
    pu = np.concatenate(pu_l)
    pv = np.concatenate(pv_l)
    key11 = np.concatenate(k11_l)
    order = np.argsort(key11, kind="stable")
    return pu[order], pv[order], key11[order]


def enumerate_pairs(keys: np.ndarray, k: int, direct: np.ndarray, n_keys: int):
    """Enumerate every (k+1)-mer whose prefix and suffix k-mers are both
    DB keys: for each key u and each of the 4 suffix extensions c, the
    pair exists iff v = (u mod 4**(k-1))*4 + c is also a key.  Returns
    (pu, pv, key11): prefix row, suffix row, and the (k+1)-mer code of
    each pair (vectorized; ~20 ms per 400k keys)."""
    keys = keys.astype(np.uint64)
    suf_core = (keys % np.uint64(4 ** (k - 1))) * np.uint64(4)
    pu_l, pv_l, k11_l = [], [], []
    for c in range(4):
        v = suf_core + np.uint64(c)
        vr = direct[v.astype(np.int64)]
        m = vr != n_keys
        pu_l.append(np.flatnonzero(m).astype(np.int32))
        pv_l.append(vr[m].astype(np.int32))
        k11_l.append((keys[m] * np.uint64(4) + np.uint64(c)).astype(np.int64))
    return (
        np.concatenate(pu_l),
        np.concatenate(pv_l),
        np.concatenate(k11_l),
    )


@functools.partial(
    jax.jit,
    static_argnames=("R", "B", "K", "P", "PA", "k", "seed1", "seed2"),
)
def _place_batch_device(
    table,
    db_postings,
    row_off,
    e_hi,
    e_lo,
    e_read,
    a_hi,
    a_lo,
    a_read,
    a_order,
    m_f32,
    *,
    R: int,
    B: int,
    K: int,
    P: int,
    PA: int,
    k: int,
    seed1: int,
    seed2: int,
    log_eps,
    eps,
):
    """One fused batch placement step (single device): XLA scatter-add
    over a flat posting budget P.  The overflow scalar returned as e_total
    is the total posting count (the host retries with a bigger P)."""
    S, C, e_total = accumulate_exact(
        table, db_postings, row_off, e_hi, e_lo, e_read,
        R=R, B=B, P=P, seed1=seed1, seed2=seed2,
    )
    first, V, a_total = accumulate_amb_firsthit(
        table, db_postings, row_off, a_hi, a_lo, a_read, a_order,
        R=R, B=B, PA=PA, k=k, seed1=seed1, seed2=seed2, eps=eps,
    )
    hit = first < _ORDER_INF
    S = S + jnp.where(hit, V, 0.0)
    C = C + hit.astype(jnp.int32)
    outs = finish_scores(S, C, m_f32, B=B, K=K, k=k, log_eps=log_eps)
    return _pack_outputs(outs, e_total, a_total)


#: "no ambiguous hit" marker for the first-order matrix
_ORDER_INF = 2**31 - 1


def _unpack_postings(pair):
    """(…, 2) uint32 -> (branch int32, score float32)."""
    b = pair[..., 0].astype(jnp.int32)
    sc = jax.lax.bitcast_convert_type(pair[..., 1], jnp.float32)
    return b, sc


def accumulate_exact(table, db_postings, row_off, e_hi, e_lo, e_read, *,
                     R, B, P, seed1, seed2):
    """Exact path: lookup -> ragged expand -> dense (R,B) scatter-add.

    The analog of the posting-list walk + SIMD update_vector
    (reference: place.cpp:349-371, intrinsic.h)."""
    f32 = jnp.float32
    _, e_row, e_len = lookup(table, seed1, seed2, e_hi, e_lo)
    e_off = row_off[e_row.astype(jnp.int32)]
    win, elem, e_total = ragged_expand(e_len.astype(jnp.int32), P)
    valid = win >= 0
    sw = jnp.maximum(win, 0)
    p_idx = jnp.clip(e_off[sw].astype(jnp.int32) + elem, 0, db_postings.shape[0] - 1)
    pb, ps = _unpack_postings(db_postings[p_idx])
    pr = jnp.where(valid, e_read[sw], jnp.int32(R))  # row R = trash row

    S = jnp.zeros((R + 1, B), f32).at[pr, pb].add(jnp.where(valid, ps, 0.0))[:R]
    C = jnp.zeros((R + 1, B), jnp.int32).at[pr, pb].add(valid.astype(jnp.int32))[:R]
    return S, C, e_total


def accumulate_amb_firsthit(table, db_postings, row_off, a_hi, a_lo, a_read,
                            a_order, *, R, B, PA, k, seed1, seed2, eps):
    """Ambiguous path (quirks Q6/Q7) in shard-composable form.

    Returns per-(read, branch):
      first: min processing order of any local posting hitting the pair
             (_ORDER_INF when none);
      V:     the contribution of that first posting,
             (10**score + (k-1)*eps) / k in probability units (quirk Q6).

    For a hash-sharded database the global combine is
    ``first_g = pmin(first); V_g = psum(where(first == first_g, V, 0))`` --
    each expanded key lives on exactly one shard, so the argmin is unique
    (SURVEY.md section 5.8).
    """
    f32 = jnp.float32
    eps = f32(eps)
    _, a_row, a_len = lookup(table, seed1, seed2, a_hi, a_lo)
    a_off = row_off[a_row.astype(jnp.int32)]
    awin, aelem, a_total = ragged_expand(a_len.astype(jnp.int32), PA)
    avalid = awin >= 0
    asw = jnp.maximum(awin, 0)
    ap_idx = jnp.clip(a_off[asw].astype(jnp.int32) + aelem, 0, db_postings.shape[0] - 1)
    ab, as_ = _unpack_postings(db_postings[ap_idx])
    ar = jnp.where(avalid, a_read[asw], jnp.int32(R))
    aord = jnp.where(avalid, a_order[asw], jnp.int32(_ORDER_INF))

    first = jnp.full((R + 1, B), _ORDER_INF, jnp.int32).at[ar, ab].min(aord)
    sel = avalid & (aord == first[ar, ab])
    pow10 = jnp.exp(as_ * f32(math.log(10.0)))
    contrib = (pow10 + f32(k - 1) * eps) / f32(k)
    V = jnp.zeros((R + 1, B), f32).at[ar, ab].add(jnp.where(sel, contrib, 0.0))
    return first[:R], V[:R], a_total


def _lwr_topk(corrected, touched, m_f32, C, *, B, K, k, log_eps):
    """Shared LWR + top-k tail over the per-(read, branch) corrected scores.

    ``C`` supplies per-branch counts for the top-k rows; None reports -1
    (the shifted-plane path never materializes counts; counts are not part
    of the jplace format, reference: jplace.cpp:121-140)."""
    f32 = jnp.float32
    log_eps = f32(log_eps)
    neg_inf = f32(-jnp.inf)

    # ---- LWR normalization over ALL branches (quirk Q4) ----------------------
    n = jnp.sum(touched, axis=1).astype(jnp.int32)
    npl_exp = m_f32 * log_eps / f32(k)  # f32, matching sum_scores (place.cpp:175)
    n_not = f32(B) - n.astype(f32)
    max_c = jnp.max(corrected, axis=1)
    max_t = jnp.maximum(max_c, jnp.where(n_not > 0, npl_exp, neg_inf))
    ln10 = f32(math.log(10.0))
    terms = jnp.where(touched, jnp.exp((corrected - max_t[:, None]) * ln10), 0.0)
    sum10 = jnp.sum(terms, axis=1) + n_not * jnp.exp(
        jnp.where(n_not > 0, (npl_exp - max_t) * ln10, neg_inf)
    )
    log_sum = max_t + jnp.log(sum10) / ln10
    # quirk Q3: the reference's double pow underflows to exact 0
    zero_sum = (max_c < f32(_POW10_ZERO)) & (
        (npl_exp < f32(_POW10_ZERO)) | (n_not <= 0)
    )

    # ---- top-k ---------------------------------------------------------------
    topk_scores, topk_idx = jax.lax.top_k(corrected, K)
    if C is None:
        topk_counts = jnp.full(topk_idx.shape, -1, jnp.int32)
    else:
        topk_counts = jnp.take_along_axis(C, topk_idx, axis=1)
    wr = jnp.exp((topk_scores - log_sum[:, None]) * ln10)
    wr = jnp.where(zero_sum[:, None] | (topk_scores < f32(_POW10_ZERO)), 0.0, wr)
    return (
        topk_scores,
        topk_idx.astype(jnp.int32),
        topk_counts,
        wr,
        n,
        zero_sum,
        log_sum,
    )


def finish_scores(S, C, m_f32, *, B, K, k, log_eps):
    """Correction + LWR + top-k on the merged (R, B) score/count matrices."""
    f32 = jnp.float32
    log_eps = f32(log_eps)
    touched = C > 0

    # ---- score correction (place.cpp:417-422) --------------------------------
    diff = m_f32[:, None] - C.astype(f32)
    # size_t wraparound emulation: C > m only happens via ambiguity fan-out;
    # float32(2**64 - small) == float32(2**64) (quirk Q1 family)
    diff = jnp.where(diff < 0, f32(_U64), diff)
    corrected = (S + diff * log_eps) / f32(k)
    corrected = jnp.where(touched, corrected, f32(-jnp.inf))
    return _lwr_topk(corrected, touched, m_f32, C, B=B, K=K, k=k, log_eps=log_eps)


def finish_scores_shifted(Sp, m_f32, *, B, K, k, log_eps):
    """Correction + LWR + top-k from the SHIFTED row sums S' = S - C*log_eps.

    With the plane holding s - log10(eps) per present cell the count term of
    the correction cancels: corrected = (S' + m*log_eps)/k, and touched is
    simply S' > 0 (every shifted cell is > 0 by construction).  Per-branch
    counts are never materialized (reported as -1)."""
    f32 = jnp.float32
    log_eps = f32(log_eps)
    touched = Sp > 0
    corrected = (Sp + m_f32[:, None] * log_eps) / f32(k)
    corrected = jnp.where(touched, corrected, f32(-jnp.inf))
    return _lwr_topk(corrected, touched, m_f32, None, B=B, K=K, k=k, log_eps=log_eps)


@functools.partial(
    jax.jit,
    static_argnames=(
        "R", "B", "K", "Wmax", "Amax", "k", "seed1", "seed2",
    ),
)
def _place_batch_device_densedb(
    table,
    plane_s,
    e_hi,
    e_lo,
    a_hi,
    a_lo,
    m_f32,
    *,
    R: int,
    B: int,
    K: int,
    Wmax: int,
    Amax: int,
    k: int,
    seed1: int,
    seed2: int,
    log_eps,
    eps,
):
    """Dense-database placement step with the on-device cuckoo lookup.

    When (num_keys+1) x B fits the device-memory budget, the database is stored as two
    dense planes -- ``plane_s`` float32 scores (0 where a branch is absent)
    (absent cells exactly 0.0; presence == nonzero) -- and the whole hot loop
    becomes **contiguous row gathers + reductions** instead of random element
    gathers: per read, S = sum of its windows' score rows, C = sum of the
    indicator rows.  This is numerically *identical* to the scalar
    accumulation (adding 0.0 is exact; rows are summed in window order,
    reference: place.cpp:349-371) and removes every budget-overflow retry.

    The ambiguous first-hit (quirks Q6/Q7) also goes dense: keys are laid
    out per read in processing order as columns, so the first expanded key
    containing a branch is simply the argmin column with a set indicator.

    Keys are shaped (R, Wmax)/(R, Amax), padded with sentinel keys that miss
    the table; misses map to the all-zero row.
    """
    S, C = dense_exact_sums(
        table, plane_s, e_hi, e_lo, R=R, B=B, Wmax=Wmax,
        seed1=seed1, seed2=seed2,
    )
    first, sel_score = dense_amb_firsthit(
        table, plane_s, a_hi, a_lo, R=R, B=B, Amax=Amax,
        seed1=seed1, seed2=seed2,
    )
    hit = first < _ORDER_INF
    f32 = jnp.float32
    pow10 = jnp.exp(sel_score * f32(math.log(10.0)))
    V = (pow10 + f32(k - 1) * f32(eps)) / f32(k)
    S = S + jnp.where(hit, V, 0.0)
    C = C + hit.astype(jnp.int32)

    zero = jnp.int32(0)
    outs = finish_scores(S, C, m_f32, B=B, K=K, k=k, log_eps=log_eps)
    return _pack_outputs(outs, zero, zero)


@functools.partial(
    jax.jit,
    static_argnames=("R", "B", "K", "Wmax", "Amax", "k", "shifted",
                     "plane_scale"),
)
def _place_batch_dense_rows(
    plane_s,
    rows,
    arows,
    m_f32,
    *,
    R: int,
    B: int,
    K: int,
    Wmax: int,
    Amax: int,
    k: int,
    log_eps,
    eps,
    shifted: bool = False,
    plane_scale: float = 1.0,
):
    """Dense-database step with HOST-side key lookup.

    The host resolves the window keys with a threaded binary search over
    the sorted key array, and that work overlaps device compute in the
    in-flight batch loop.  So this path ships precomputed plane row
    indices and the device does only bandwidth-bound work: row gathers,
    reductions, correction/LWR/top-k.

    ``Amax == 0`` (a batch with no ambiguous windows -- the common case for
    real DNA reads) statically elides the whole ambiguity stage.
    """
    if shifted:
        Sp = dense_sums_shifted(plane_s, rows, R=R, B=B, Wmax=Wmax)
        if plane_scale != 1.0:
            Sp = Sp.astype(jnp.float32) / jnp.float32(plane_scale)
        if Amax > 0:
            Sp, _ = _apply_amb(Sp, None, plane_s, arows, R=R, B=B, Amax=Amax,
                               k=k, eps=eps, log_eps=log_eps, shifted=True,
                               plane_scale=plane_scale)
        outs = finish_scores_shifted(Sp, m_f32, B=B, K=K, k=k, log_eps=log_eps)
        return _pack_outputs_slim(outs)
    S, C = dense_sums_from_rows(plane_s, rows, R=R, B=B, Wmax=Wmax)
    if Amax > 0:
        S, C = _apply_amb(S, C, plane_s, arows, R=R, B=B, Amax=Amax,
                          k=k, eps=eps, log_eps=log_eps, shifted=False)

    zero = jnp.int32(0)
    outs = finish_scores(S, C, m_f32, B=B, K=K, k=k, log_eps=log_eps)
    return _pack_outputs(outs, zero, zero)


@functools.partial(
    jax.jit,
    static_argnames=(
        "R", "B", "K", "Amax", "k", "Lmax", "num_kmers",
        "shifted", "plane_scale",
    ),
)
def _place_batch_dense_bytes(
    plane_s,
    direct,
    buf,
    arows,
    *,
    R: int,
    B: int,
    K: int,
    Amax: int,
    k: int,
    Lmax: int,
    num_kmers: int,
    log_eps,
    eps,
    shifted: bool = False,
    plane_scale: float = 1.0,
):
    """Dense-database step with ON-DEVICE tokenization (the fastest path).

    The host ships ONE packed uint8 buffer (2-bit codes + bad-bits + read
    lengths, see :func:`pack_reads`); window keys, key->row resolution
    (direct-address table), the per-read window counts and the row-gather
    sums all happen on the device.  This removes the per-window host work
    entirely and shrinks the per-batch host-to-device transfer ~10x versus
    precomputed row matrices.
    """
    rows, lens = device_tokenize_packed(
        buf, direct, k=k, Lmax=Lmax, num_kmers=num_kmers
    )
    # correction term uses the size_t-wrapped window count (quirk Q1); len
    # < k (incl. len-0 padding rows) wraps like the reference's size_t
    # underflow; padding rows beyond the true batch are sliced off on fetch
    m_f32 = _window_count_f32(lens, k)
    W = rows.shape[1]
    Wp = -(-W // 16) * 16  # chunked-gather (w_ch=16) width contract
    rows = jnp.pad(rows, ((0, 0), (0, Wp - W)), constant_values=num_kmers)
    if shifted:
        Sp = dense_sums_shifted(plane_s, rows, R=R, B=B, Wmax=Wp)
        if plane_scale != 1.0:
            Sp = Sp.astype(jnp.float32) / jnp.float32(plane_scale)
        if Amax > 0:
            Sp, _ = _apply_amb(Sp, None, plane_s, arows, R=R, B=B, Amax=Amax,
                               k=k, eps=eps, log_eps=log_eps, shifted=True,
                               plane_scale=plane_scale)
        outs = finish_scores_shifted(Sp, m_f32, B=B, K=K, k=k, log_eps=log_eps)
        return _pack_outputs_slim(outs)
    S, C = dense_sums_from_rows(plane_s, rows, R=R, B=B, Wmax=Wp)
    if Amax > 0:
        S, C = _apply_amb(S, C, plane_s, arows, R=R, B=B, Amax=Amax,
                          k=k, eps=eps, log_eps=log_eps, shifted=False)

    zero = jnp.int32(0)
    outs = finish_scores(S, C, m_f32, B=B, K=K, k=k, log_eps=log_eps)
    return _pack_outputs(outs, zero, zero)


@functools.partial(
    jax.jit,
    static_argnames=(
        "R", "B", "K", "Amax", "k", "Lmax", "num_kmers",
    ),
)
def _place_batch_dense_paired(
    plane_s,
    combo,
    buf,
    arows,
    *,
    R: int,
    B: int,
    K: int,
    Amax: int,
    k: int,
    Lmax: int,
    num_kmers: int,
    log_eps,
    eps,
):
    """Dense shifted step over the PAIR plane (PlacerConfig.pair_plane).

    Same contract as :func:`_place_batch_dense_bytes` in shifted mode, but
    the row gather runs over ceil(W/2) pair slots instead of W windows --
    the gathered row count halves -- and slot rows resolve through the
    unified combo table (ONE element gather per slot,
    :func:`device_tokenize_combo`).
    """
    rows, lens = device_tokenize_combo(
        buf, combo, k=k, Lmax=Lmax, num_kmers=num_kmers
    )
    m_f32 = _window_count_f32(lens, k)
    Wp = rows.shape[1]
    Wpad = -(-Wp // 16) * 16
    rows = jnp.pad(rows, ((0, 0), (0, Wpad - Wp)), constant_values=num_kmers)
    Sp = dense_sums_shifted(plane_s, rows, R=R, B=B, Wmax=Wpad)
    if Amax > 0:
        Sp, _ = _apply_amb(Sp, None, plane_s, arows, R=R, B=B, Amax=Amax,
                           k=k, eps=eps, log_eps=log_eps, shifted=True)
    outs = finish_scores_shifted(Sp, m_f32, B=B, K=K, k=k, log_eps=log_eps)
    return _pack_outputs_slim(outs)


def dense_exact_sums(table, plane_s, e_hi, e_lo, *, R, B, Wmax, seed1, seed2,
                     w_ch=16):
    """Per-read (S, C) sums from the dense score plane (shard-composable:
    psum both).

    A single f32 plane serves both roles: absent (branch, key) cells hold
    exactly 0.0 and presence is ``gathered != 0`` -- stored scores of
    exactly 0.0 (P(kmer|branch) == 1) are nudged to the smallest negative
    subnormal at plane build, which is far below every tolerance.  This
    halves the gather traffic versus a separate indicator plane.
    """
    i32 = jnp.int32
    zero_row = plane_s.shape[0] - 1
    found, row, _ = lookup(table, seed1, seed2, e_hi.reshape(-1), e_lo.reshape(-1))
    rows = jnp.where(found, row.astype(i32), i32(zero_row)).reshape(R, Wmax)
    return dense_sums_from_rows(plane_s, rows, R=R, B=B, Wmax=Wmax, w_ch=w_ch)


def dense_sums_from_rows(plane_s, rows, *, R, B, Wmax, w_ch=16):
    """Chunked row-gather + reduce given precomputed plane row indices
    (misses / padding = the all-zero last row).  The gather runs in chunks
    of ``w_ch`` windows, which keeps the (R, chunk, B) working set small."""
    f32 = jnp.float32
    i32 = jnp.int32

    # chunked row-gather + reduce keeps the (R, chunk, B) working set small
    W_CH = min(w_ch, Wmax)

    bw = plane_s.shape[1]  # plane width (B padded to a 128 multiple)

    def w_body(i, acc):
        S, C = acc
        chunk = jax.lax.dynamic_slice(rows, (0, i * W_CH), (R, W_CH))
        g = plane_s[chunk]  # (R, W_CH, bw)
        S = S + jnp.sum(g.astype(f32), axis=1)
        C = C + jnp.sum((g != 0).astype(i32), axis=1)
        return S, C

    S, C = jax.lax.fori_loop(
        0, Wmax // W_CH, w_body,
        (jnp.zeros((R, bw), f32), jnp.zeros((R, bw), i32)),
    )
    return S[:, :B], C[:, :B]


def dense_sums_shifted(plane_p, rows, *, R, B, Wmax, w_ch=16):
    """Single-reduce row-gather over the SHIFTED plane (plane_mode="shifted").

    The plane holds s - log10(eps) (> 0 present, 0 absent), so ONE sum per
    window chunk carries everything the correction needs -- the per-window
    count reduce of :func:`dense_sums_from_rows` disappears entirely.

    An int16 plane (``precision="int16"``) holds quantized shifted values;
    the accumulator switches to int32 (exact integer addition) and the
    caller divides by the plane scale once at the end.
    """
    quant = plane_p.dtype == jnp.int16
    acc_dt = jnp.int32 if quant else jnp.float32
    W_CH = min(w_ch, Wmax)
    bw = plane_p.shape[1]

    def w_body(i, Sp):
        chunk = jax.lax.dynamic_slice(rows, (0, i * W_CH), (R, W_CH))
        return Sp + jnp.sum(plane_p[chunk], axis=1, dtype=acc_dt)

    Sp = jax.lax.fori_loop(0, Wmax // W_CH, w_body, jnp.zeros((R, bw), acc_dt))
    return Sp[:, :B]


def _apply_amb(S, C, plane_s, arows, *, R, B, Amax, k, eps, log_eps, shifted,
               plane_scale=1.0):
    """Fold the ambiguous first-hit contribution (quirks Q6/Q7) into (S, C).

    ``shifted``: the plane holds s - log10(eps); the stored score is
    recovered as sel + log_eps and the contribution lands shifted too
    (V - log_eps), preserving S' = S - C*log_eps.  ``plane_scale != 1``
    (int16 plane) dequantizes the selected value first; S must already be
    in dequantized f32 units.
    """
    first, sel = dense_amb_from_rows(plane_s, arows, R=R, B=B, Amax=Amax)
    hit = first < _ORDER_INF
    f32 = jnp.float32
    if plane_scale != 1.0:
        sel = sel / f32(plane_scale)
    s = sel + f32(log_eps) if shifted else sel
    pow10 = jnp.exp(s * f32(math.log(10.0)))
    V = (pow10 + f32(k - 1) * f32(eps)) / f32(k)
    if shifted:
        return S + jnp.where(hit, V - f32(log_eps), 0.0), None
    return S + jnp.where(hit, V, 0.0), C + hit.astype(jnp.int32)


def dense_amb_firsthit(table, plane_s, a_hi, a_lo, *, R, B, Amax,
                       seed1, seed2):
    """Ambiguous first-hit from dense planes (quirks Q6/Q7).

    Returns (first, sel_score): the min processing order per (read, branch)
    (_ORDER_INF when none) and the score of that first hit.  Shard combine:
    ``first_g = pmin(first); V_g = psum(where(first == first_g & hit, V, 0))``
    -- each key lives on one shard, so the argmin owner is unique.
    """
    i32 = jnp.int32
    zero_row = plane_s.shape[0] - 1
    afound, arow, _ = lookup(table, seed1, seed2, a_hi.reshape(-1), a_lo.reshape(-1))
    arows = jnp.where(afound, arow.astype(i32), i32(zero_row)).reshape(R, Amax)
    return dense_amb_from_rows(plane_s, arows, R=R, B=B, Amax=Amax)


def dense_amb_from_rows(plane_s, arows, *, R, B, Amax):
    """Ambiguous first-hit given precomputed plane row indices."""
    f32 = jnp.float32
    i32 = jnp.int32
    A_CH = min(8, Amax)

    bw = plane_s.shape[1]

    def a_body(i, carry):
        first, sel = carry
        chunk = jax.lax.dynamic_slice(arows, (0, i * A_CH), (R, A_CH))
        g = plane_s[chunk]  # (R, A_CH, bw); one gather serves both roles
        ind = g != 0
        col = jax.lax.broadcasted_iota(i32, (R, A_CH, bw), 1) + i * A_CH
        cand = jnp.where(ind, col, _ORDER_INF)
        cfirst = jnp.min(cand, axis=1)
        argc = jnp.argmin(cand, axis=1)  # (R, bw) column within chunk
        cscore = jnp.take_along_axis(g, argc[:, None, :], axis=1)[:, 0, :].astype(f32)
        better = cfirst < first
        return jnp.where(better, cfirst, first), jnp.where(better, cscore, sel)

    first, sel = jax.lax.fori_loop(
        0, Amax // A_CH, a_body,
        (jnp.full((R, bw), _ORDER_INF, i32), jnp.zeros((R, bw), f32)),
    )
    return first[:, :B], sel[:, :B]



def pack_reads(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Host half of the packed read upload (DNA fast path).

    ``codes``: (R, Lmax) uint8 alphabet codes (exact < 4, others non-exact;
    0-padding bytes map to the invalid code), Lmax a multiple of 8.
    Packs 2 bits/char + 1 bad-bit/char + a uint16 length per read into ONE
    (R, Lmax//4 + Lmax//8 + 2) uint8 buffer -- 2.6x smaller than raw bytes,
    and one host-to-device transfer per batch."""
    R, L = codes.shape
    ex = codes < 4
    c = np.where(ex, codes, 0).astype(np.uint8)
    c2 = (c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4)
          | (c[:, 3::4] << 6))
    bb = np.packbits(~ex, axis=1, bitorder="little")
    ll = np.empty((R, 2), np.uint8)
    ll[:, 0] = lens & 0xFF
    ll[:, 1] = lens >> 8
    return np.concatenate([c2, bb, ll], axis=1)


def device_tokenize_packed(buf, direct, *, k: int, Lmax: int, num_kmers: int):
    """On-device window tokenizer over the packed read buffer.

    The device replacement for the host tokenize + key->row lookup
    (reference: i2l::to_kmers + db.search, epik/src/epik/place.cpp:294-316):
    unpack 2-bit codes and bad-bits with shifts, build every k-window
    key with k shifted adds, and resolve keys through the direct-address
    ``direct`` table (4**k int32; absent keys map to the all-zero plane
    row).  Windows containing any non-exact character (ambiguous, invalid,
    or padding) yield the zero row -- their ambiguity contribution, if any,
    arrives via the host ambiguity stream.

    Returns (rows (R, W) int32, lens (R,) int32).  DNA only: keys fit
    uint32 for k <= 16 and the direct table is at most 268 MB for k <= 13.
    """
    key, ok, _c, lens = _tokenize_core(buf, k=k, Lmax=Lmax)
    rows = jnp.take(direct, key.astype(jnp.int32), axis=0)
    return jnp.where(ok, rows, jnp.int32(num_kmers)), lens


def _tokenize_core(buf, *, k: int, Lmax: int):
    """Unpack the packed read buffer into per-window keys + validity.

    Returns (key (R, W) uint32, ok (R, W) bool, codes (R, Lmax) uint32,
    lens (R,) int32) with W = Lmax - k + 1."""
    i32 = jnp.int32
    u32 = jnp.uint32
    R = buf.shape[0]
    L4, L8 = Lmax // 4, Lmax // 8
    c2 = buf[:, :L4].astype(i32)
    bb = buf[:, L4 : L4 + L8].astype(i32)
    lens = buf[:, L4 + L8].astype(i32) + 256 * buf[:, L4 + L8 + 1].astype(i32)
    codes = jnp.stack(
        [(c2 >> (2 * j)) & 3 for j in range(4)], axis=2
    ).reshape(R, Lmax)
    bad = jnp.stack([(bb >> j) & 1 for j in range(8)], axis=2).reshape(R, Lmax)
    W = Lmax - k + 1
    c = codes.astype(u32)
    key = jnp.zeros_like(c[:, :W])
    for j in range(k):
        key = key * u32(4) + c[:, j : j + W]
    # window is exact iff all k characters are exact: sliding sum of the
    # bad indicator via an exclusive cumsum difference
    cs = jnp.concatenate(
        [jnp.zeros((R, 1), i32), jnp.cumsum(bad, axis=1)], axis=1
    )
    ok = (cs[:, k : k + W] - cs[:, :W]) == 0
    return key, ok, c, lens


def device_tokenize_paired(buf, direct, direct11, *, k: int, Lmax: int,
                           num_kmers: int):
    """Paired on-device tokenizer: ONE plane row per two windows.

    Combined-plane layout: rows 0..N-1 = k-mer rows, row N = all-zero
    (every miss sentinel unchanged), rows N+1.. = (k+1)-mer pair rows
    (``direct11`` maps a (k+1)-mer key to its absolute combined row, -1
    when absent).  Per 2-window slot:

    * pair hit  -> the precomputed pair row (sum of both windows' rows);
    * pair miss -> by construction at most ONE of the two windows can hit
      (the pair table enumerates every suffix extension of every DB key,
      so "both k-mers present" implies "pair present"), gather that row;
    * neither   -> the zero row.

    Exactly ceil(W/2) rows per read -- half the row gathers of
    :func:`device_tokenize_packed` -- with identical summed scores.

    Returns (slot_rows (R, ceil(W/2)) int32, lens (R,) int32).

    NOTE: superseded on the production path by
    :func:`device_tokenize_combo` (ONE element gather per slot instead of
    three); kept for the tile pair mode and as the reference
    formulation the combo table must reproduce.
    """
    i32 = jnp.int32
    key, ok, c, lens = _tokenize_core(buf, k=k, Lmax=Lmax)
    R, W = key.shape
    rows10 = jnp.where(ok, jnp.take(direct, key.astype(i32), axis=0),
                       i32(num_kmers))
    Wp = (W + 1) // 2
    if W >= 2:
        # (k+1)-mer key/validity spans windows w and w+1
        key11 = key[:, : W - 1] * jnp.uint32(4) + c[:, k : k + W - 1]
        ok11 = ok[:, : W - 1] & ok[:, 1:]
        prow = jnp.where(ok11, jnp.take(direct11, key11.astype(i32), axis=0),
                         i32(-1))
        prow_e = prow[:, 0::2]
        prow_e = jnp.pad(prow_e, ((0, 0), (0, Wp - prow_e.shape[1])),
                         constant_values=-1)
    else:
        prow_e = jnp.full((R, Wp), -1, i32)
    rows10p = jnp.pad(rows10, ((0, 0), (0, 2 * Wp - W)),
                      constant_values=num_kmers)
    r1 = rows10p[:, 0::2]
    r2 = rows10p[:, 1::2]
    single = jnp.where(r1 != i32(num_kmers), r1, r2)
    return jnp.where(prow_e >= 0, prow_e, single), lens


def build_combo_table(direct: np.ndarray, direct11: np.ndarray, k: int,
                      num_kmers: int) -> np.ndarray:
    """ONE-gather slot-row table for the paired tokenizer.

    Layout (int32, size 4**(k+1) + 4**k + 1):

      [0, 4**(k+1))              fully-valid slots indexed by the
                                 (k+1)-mer: pair row if the pair exists,
                                 else the one hitting single's row (the
                                 pair identity guarantees at most one),
                                 else the miss row;
      [4**(k+1), 4**(k+1)+4**k)  single-window fallback region indexed by
                                 a k-mer (mixed-validity slots: read
                                 tails, windows adjacent to bad chars) --
                                 a copy of ``direct`` with misses mapped
                                 to the zero row;
      last cell                  the miss row (slots with no valid window).

    Collapses the paired path's 3 element-gather passes per 2 windows
    (prefix + suffix + pair tables) into 1.
    """
    n11 = direct11.shape[0]
    nk = direct.shape[0]
    combo = np.empty(n11 + nk + 1, np.int32)
    pre = direct[np.arange(n11, dtype=np.int64) >> (2 * 1)]  # key11 // 4
    # suffix k-mer = key11 mod 4**k
    suf = direct[np.arange(n11, dtype=np.int64) & (nk - 1)]
    single = np.where(pre != num_kmers, pre, suf)
    combo[:n11] = np.where(direct11 >= 0, direct11, single)
    combo[n11 : n11 + nk] = direct
    combo[-1] = num_kmers
    return combo


def device_tokenize_combo(buf, combo, *, k: int, Lmax: int, num_kmers: int):
    """Paired tokenizer with the unified combo table: ONE element gather
    per 2-window slot (vs three table passes in
    :func:`device_tokenize_paired`; see :func:`build_combo_table`).

    Semantically identical by construction: the fully-valid region bakes
    the pair/single/miss decision chain in at build time, and slots where
    only one window is valid (read tails, bad-character neighborhoods)
    index the fallback region with that window's k-mer.

    Returns (slot_rows (R, ceil(W/2)) int32, lens (R,) int32)."""
    i32 = jnp.int32
    u32 = jnp.uint32
    key, ok, c, lens = _tokenize_core(buf, k=k, Lmax=Lmax)
    R, W = key.shape
    Wp = (W + 1) // 2
    n11 = u32(4 ** (k + 1))
    miss_idx = u32(4 ** (k + 1) + 4**k)
    # per-slot pieces (slot j = windows 2j, 2j+1); pad the odd tail
    keyp = jnp.pad(key, ((0, 0), (0, 2 * Wp - W)))
    okp2 = jnp.pad(ok, ((0, 0), (0, 2 * Wp - W)), constant_values=False)
    kp = keyp[:, 0::2]
    ks = keyp[:, 1::2]
    op = okp2[:, 0::2]
    os_ = okp2[:, 1::2]
    if W >= 2:
        key11 = key[:, : W - 1] * u32(4) + c[:, k : k + W - 1]
        ok11 = ok[:, : W - 1] & ok[:, 1:]
        k11 = jnp.pad(key11, ((0, 0), (0, 2 * Wp - 1 - (W - 1))))[:, 0::2]
        o11 = jnp.pad(ok11, ((0, 0), (0, 2 * Wp - 1 - (W - 1))),
                      constant_values=False)[:, 0::2]
    else:
        k11 = jnp.zeros((R, Wp), u32)
        o11 = jnp.zeros((R, Wp), bool)
    fb_key = jnp.where(op, kp, ks)
    fb_ok = op | os_
    idx = jnp.where(o11, k11, jnp.where(fb_ok, n11 + fb_key, miss_idx))
    rows = jnp.take(combo, idx.astype(i32), axis=0)
    return rows, lens


@functools.partial(
    jax.jit,
    static_argnames=(
        "R", "B", "K", "k", "Lmax", "num_kmers", "PT", "packed",
        "tile_scale", "PT_OV", "OV", "N_OV",
    ),
)
def _place_batch_tiles_bytes(
    tiles,
    direct,
    buf,
    tiles_ov=None,
    *,
    R: int,
    B: int,
    K: int,
    k: int,
    Lmax: int,
    num_kmers: int,
    PT: int,
    log_eps,
    eps,
    packed: bool = False,
    tile_scale: float = 1.0,
    PT_OV: int = 0,
    OV: int = 0,
    N_OV: int = 0,
):
    """Big-tree fast path: posting-TILE plane + scatter-add accumulate.

    When the dense (keys x branches) plane exceeds its memory budget (10k+
    taxa), the CSR path fetches each posting with a per-cell 8-byte
    gather.  This path instead pre-materializes per-key padded posting
    tiles ``tiles: (n_keys+1, 2*PT) u32`` ([branch | shifted-score-bits]
    pairs, trash-padded; row n_keys all-trash for misses), so each window
    costs ONE contiguous row gather -- the same access pattern that makes
    the dense plane fast, at 2*PT*4 bytes/row instead of 4*B.  The cells
    are then summed per (read, branch) (ops/accumulate.py).  Tile scores
    are stored SHIFTED (s - log10(eps)), so no counts are needed and
    corrected = (S' + m*log_eps)/k (finish_scores_shifted).

    Ambiguity is not handled here -- batches with ambiguous reads fall
    back to the classic CSR path at staging (the rare path).

    Reference analog: posting-list walk + SIMD update_vector
    (place.cpp:349-371, intrinsic.h).  ``packed`` selects the int32
    ``(branch << 16) | q`` payload with an exact int32 accumulate
    (PlacerConfig.tile_payload).
    """
    i32 = jnp.int32
    f32 = jnp.float32
    rows, lens = device_tokenize_packed(
        buf, direct, k=k, Lmax=Lmax, num_kmers=num_kmers
    )
    m_f32 = _window_count_f32(lens, k)
    W = rows.shape[1]
    with jax.named_scope("accumulate"):
        if packed:
            g = tiles[rows].reshape(R, W * PT)  # one row gather per window
            cnt_ov = None
            if PT_OV > 0:
                # TWO-LEVEL tiles: the main plane holds only the first PT
                # postings per key (PT chosen near the length
                # distribution's knee instead of the max, so mean-12/max-30
                # DBs stop dragging mostly-trash cells through the
                # accumulate).  The tail postings live in a compact
                # overflow plane addressed per WINDOW: overflow windows are
                # rare, so their rows are COMPACTED to a static budget OV by
                # top_k; cnt_ov rides home in an extra result column and
                # the host re-dispatches with a bigger OV when a read
                # exceeds it (exactness by retry, like the CSR posting
                # budgets).  Overflow keys occupy tile rows [0, N_OV) -- a
                # build-time permutation -- so membership is arithmetic,
                # not a gather; overflow plane row = main row + 1 (row 0 is
                # all-trash).
                ovr = jnp.where(rows < i32(N_OV), rows + 1, 0)
                cnt_ov = jnp.sum((ovr > 0).astype(i32), axis=1)
                sel = jax.lax.top_k(ovr, OV)[0]  # (R, OV); 0 -> all-trash row
                gov = tiles_ov[sel].reshape(R, OV * PT_OV)
                g = jnp.concatenate([g, gov], axis=1)
            Sp = segment_sums_packed(g, B).astype(f32) / f32(tile_scale)
        else:
            g = tiles[rows].reshape(R, W * PT, 2)  # one row gather per window
            b = g[..., 0].astype(i32)
            s = jax.lax.bitcast_convert_type(g[..., 1], f32)
            Sp = segment_sums(b, s, B)
            cnt_ov = None
    with jax.named_scope("finish"):
        pack = _pack_outputs_slim(
            finish_scores_shifted(Sp, m_f32, B=B, K=K, k=k, log_eps=log_eps)
        )
        if cnt_ov is not None:
            pack = jnp.concatenate([pack, cnt_ov.astype(f32)[:, None]], axis=1)
    return pack


@functools.partial(
    jax.jit,
    static_argnames=(
        "R", "B", "K", "k", "Lmax", "num_kmers", "PT", "tile_scale",
    ),
)
def _place_batch_tiles_paired(
    tiles,
    direct,
    direct11,
    buf,
    *,
    R: int,
    B: int,
    K: int,
    k: int,
    Lmax: int,
    num_kmers: int,
    PT: int,
    log_eps,
    eps,
    tile_scale: float = 1.0,
):
    """Pair-fused packed-tile step: ONE 2*PT row gather per TWO windows.

    Tile pair rows hold prefix-postings ++ suffix-postings (the packed
    payload's integer sums make accumulation order-free, so concatenation
    order cannot perturb parity).  Same (k+1)-mer identity as the dense
    pair plane: a pair MISS implies at most one of the two windows hits."""
    f32 = jnp.float32
    rows, lens = device_tokenize_paired(
        buf, direct, direct11, k=k, Lmax=Lmax, num_kmers=num_kmers
    )
    m_f32 = _window_count_f32(lens, k)
    g = tiles[rows].reshape(R, rows.shape[1] * 2 * PT)
    Sp = segment_sums_packed(g, B).astype(f32) / f32(tile_scale)
    outs = finish_scores_shifted(Sp, m_f32, B=B, K=K, k=k, log_eps=log_eps)
    return _pack_outputs_slim(outs)


def _window_count_f32(lens, k: int):
    """Per-read window count m as f32, with the reference's size_t
    wraparound for reads shorter than k (quirk Q1)."""
    f32 = jnp.float32
    m_signed = lens - jnp.int32(k - 1)
    return jnp.where(
        m_signed >= 0, m_signed.astype(f32), f32(float(_U64)) + m_signed.astype(f32)
    )


def device_tokenize_codes(buf, *, k: int, sigma: int, Lmax: int):
    """On-device window keys for generic-alphabet codes (the amino path).

    ``buf``: (R, Lmax + 2) uint8 -- alphabet codes (exact < sigma, others
    invalid) plus a trailing uint16 read length.  Window keys are built in
    base sigma with uint32 split limbs (b = low 16 bits, a = high bits):
    b' = b*sigma + c wraps at 2**16 into a, so sigma**k < 2**48 (amino
    k <= 10) needs no x64.  Returns (a, b, ok, lens)."""
    i32 = jnp.int32
    u32 = jnp.uint32
    R = buf.shape[0]
    codes = buf[:, :Lmax].astype(i32)
    lens = buf[:, Lmax].astype(i32) + 256 * buf[:, Lmax + 1].astype(i32)
    bad = (codes >= sigma).astype(i32)
    W = Lmax - k + 1
    c = jnp.where(codes < sigma, codes, 0).astype(u32)
    a = jnp.zeros((R, W), u32)
    b = jnp.zeros((R, W), u32)
    for j in range(k):
        cj = c[:, j : j + W]
        b2 = b * u32(sigma) + cj
        a = a * u32(sigma) + (b2 >> u32(16))
        b = b2 & u32(0xFFFF)
    cs = jnp.concatenate(
        [jnp.zeros((R, 1), i32), jnp.cumsum(bad, axis=1)], axis=1
    )
    ok = (cs[:, k : k + W] - cs[:, :W]) == 0
    return a, b, ok, lens


@functools.partial(
    jax.jit,
    static_argnames=(
        "R", "B", "K", "Amax", "k", "sigma", "Lmax", "num_kmers",
        "shift", "n_probe", "off_bits", "plane_scale",
    ),
)
def _place_batch_dense_codes(
    plane_s,
    off,
    low,
    buf,
    arows,
    *,
    R: int,
    B: int,
    K: int,
    Amax: int,
    k: int,
    sigma: int,
    Lmax: int,
    num_kmers: int,
    shift: int,
    n_probe: int,
    log_eps,
    eps,
    off_bits: int = 0,
    plane_scale: float = 1.0,
):
    """Dense shifted step for generic alphabets (amino): on-device
    tokenization + radix-index lookup (ops/radix_lookup.py) + shifted row
    gather.  Removes ALL per-window host work from the amino path, which
    was host-staging-bound (~60 ms/2000 reads of searchsorted + row fill
    on a 2-core host vs ~10 ms of device element gathers).

    ``off_bits`` > 0 selects the PACKED 3-gather-pass lookup (off/low then
    hold offc/low2), SPLIT (-1) the 2-independent-gather split-word form
    (off/low hold v1/v2; ops/radix_lookup.py)."""
    from ..ops.radix_lookup import radix_lookup_dispatch

    a, b, ok, lens = device_tokenize_codes(buf, k=k, sigma=sigma, Lmax=Lmax)
    rows = radix_lookup_dispatch(off, low, a, b, shift=shift,
                                 n_probe=n_probe, off_bits=off_bits,
                                 n_keys=num_kmers)
    rows = jnp.where(ok, rows, jnp.int32(num_kmers))
    f32 = jnp.float32
    m_f32 = _window_count_f32(lens, k)
    W = rows.shape[1]
    Wp = -(-W // 16) * 16
    rows = jnp.pad(rows, ((0, 0), (0, Wp - W)), constant_values=num_kmers)
    Sp = dense_sums_shifted(plane_s, rows, R=R, B=B, Wmax=Wp)
    if plane_scale != 1.0:
        Sp = Sp.astype(f32) / f32(plane_scale)
    if Amax > 0:
        Sp, _ = _apply_amb(Sp, None, plane_s, arows, R=R, B=B, Amax=Amax,
                           k=k, eps=eps, log_eps=log_eps, shifted=True,
                           plane_scale=plane_scale)
    outs = finish_scores_shifted(Sp, m_f32, B=B, K=K, k=k, log_eps=log_eps)
    return _pack_outputs_slim(outs)


@functools.partial(
    jax.jit,
    static_argnames=(
        "R", "B", "K", "Amax", "k", "sigma", "Lmax", "num_kmers", "n_pairs",
        "shift", "n_probe", "off_bits", "p_shift", "p_probe", "p_off_bits",
    ),
)
def _place_batch_dense_codes_paired(
    plane_s,
    off,
    low,
    poff,
    plow,
    buf,
    arows,
    *,
    R: int,
    B: int,
    K: int,
    Amax: int,
    k: int,
    sigma: int,
    Lmax: int,
    num_kmers: int,
    n_pairs: int,
    shift: int,
    n_probe: int,
    off_bits: int,
    p_shift: int,
    p_probe: int,
    p_off_bits: int,
    log_eps,
    eps,
):
    """Generic-alphabet (amino) pair-plane step: ONE plane-row gather per
    TWO windows, pair rows resolved by a second radix index over the
    (k+1)-mer pair keys.

    Round 4: previously skipped because the pair lookup's probe passes
    would cancel the halved row gathers; the packed 3-pass radix
    (radix_lookup_packed) changed the arithmetic -- the pair lookup costs
    ~1.5 pass-equivalents (3 passes over half the windows) against ~11 ms
    of saved gather at the production amino geometry.  Same (k+1)-mer
    identity as the DNA pair plane: the pair table enumerates every
    suffix extension of every key, so a pair miss implies at most one of
    the two windows hits."""
    from ..ops.radix_lookup import radix_lookup_dispatch

    i32 = jnp.int32
    f32 = jnp.float32

    def lk(o, l, aa, bb, sh, npb, ob, nk):
        return radix_lookup_dispatch(o, l, aa, bb, shift=sh, n_probe=npb,
                                     off_bits=ob, n_keys=nk)

    a, b, ok, lens = device_tokenize_codes(buf, k=k, sigma=sigma, Lmax=Lmax)
    rows10 = lk(off, low, a, b, shift, n_probe, off_bits, num_kmers)
    rows10 = jnp.where(ok, rows10, i32(num_kmers))
    m_f32 = _window_count_f32(lens, k)
    R_, W = rows10.shape
    Wp = (W + 1) // 2
    rows10p = jnp.pad(rows10, ((0, 0), (0, 2 * Wp - W)),
                      constant_values=num_kmers)
    r1 = rows10p[:, 0::2]
    r2 = rows10p[:, 1::2]
    single = jnp.where(r1 != i32(num_kmers), r1, r2)
    if W >= 2:
        a11, b11, ok11, _ = device_tokenize_codes(buf, k=k + 1, sigma=sigma,
                                                  Lmax=Lmax)
        # even slots only: slot j pairs windows 2j, 2j+1
        pad11 = 2 * Wp - 1 - a11.shape[1]
        a11e = jnp.pad(a11, ((0, 0), (0, pad11)))[:, 0::2]
        b11e = jnp.pad(b11, ((0, 0), (0, pad11)))[:, 0::2]
        ok11e = jnp.pad(ok11, ((0, 0), (0, pad11)),
                        constant_values=False)[:, 0::2]
        pidx = lk(poff, plow, a11e, b11e, p_shift, p_probe, p_off_bits,
                  n_pairs)
        prow = jnp.where(ok11e & (pidx < n_pairs),
                         i32(num_kmers + 1) + pidx, i32(-1))
        rows = jnp.where(prow >= 0, prow, single)
    else:
        rows = single
    Wpad = -(-Wp // 16) * 16
    rows = jnp.pad(rows, ((0, 0), (0, Wpad - Wp)), constant_values=num_kmers)
    Sp = dense_sums_shifted(plane_s, rows, R=R, B=B, Wmax=Wpad)
    if Amax > 0:
        Sp, _ = _apply_amb(Sp, None, plane_s, arows, R=R, B=B, Amax=Amax,
                           k=k, eps=eps, log_eps=log_eps, shifted=True)
    outs = finish_scores_shifted(Sp, m_f32, B=B, K=K, k=k, log_eps=log_eps)
    return _pack_outputs_slim(outs)


def _pack_outputs(outs, e_total, a_total):
    """Pack all step outputs into ONE (R+1, 4K+2) f32 array.

    A single packed array makes the whole result one device-to-host
    transfer.  idx/counts fit exactly in f32 (< 2**24)."""
    scores_k, idx_k, counts_k, wr_k, n, zero_sum = outs[:6]
    f32 = jnp.float32
    body = jnp.concatenate(
        [
            scores_k,
            wr_k.astype(f32),
            idx_k.astype(f32),
            counts_k.astype(f32),
            n.astype(f32)[:, None],
            zero_sum.astype(f32)[:, None],
        ],
        axis=1,
    )
    return jnp.concatenate([body, _totals_row(body.shape[1], e_total,
                                              a_total)], axis=0)


def _totals_row(width: int, e_total, a_total):
    """(1, width) f32 budget-totals row.  Totals split into 20-bit halves:
    a single f32 rounds above 2**24 and could round a true overflow down
    to exactly the budget, silently skipping the retry.  Host decoder:
    unpack_outputs / parallel/sharding.py place_wait."""
    f32 = jnp.float32
    e_t = e_total.astype(jnp.int32)
    a_t = a_total.astype(jnp.int32)
    return (
        jnp.zeros((1, width), f32)
        .at[0, 0].set((e_t >> 20).astype(f32))
        .at[0, 1].set((e_t & 0xFFFFF).astype(f32))
        .at[0, 2].set((a_t >> 20).astype(f32))
        .at[0, 3].set((a_t & 0xFFFFF).astype(f32))
    )


def unpack_outputs(arr: np.ndarray, K: int):
    """Host-side inverse of _pack_outputs (numpy array in)."""
    body, totals = arr[:-1], arr[-1]
    scores_k = body[:, 0:K]
    wr_k = body[:, K : 2 * K].astype(np.float64)
    idx_k = body[:, 2 * K : 3 * K].astype(np.int32)
    counts_k = body[:, 3 * K : 4 * K].astype(np.int64)
    n = body[:, 4 * K].astype(np.int32)
    zero_sum = body[:, 4 * K + 1] != 0
    e_total = (int(totals[0]) << 20) + int(totals[1])
    a_total = (int(totals[2]) << 20) + int(totals[3])
    return scores_k, idx_k, counts_k, wr_k, n, zero_sum, e_total, a_total


def _pack_outputs_slim(outs):
    """Slim (R, 2K+3) result pack for the shifted dense paths.

    Shifted mode never materializes counts (all -1) and the like-weight
    ratios are a pure function of (topk_scores, log_sum), so the result
    carries only [scores K | idx K | log_sum | n | zero_sum] -- 1.76x fewer
    bytes to fetch than the full pack -- and the host recomputes wr in
    equivalent f32 arithmetic (ulp-level: np.exp and XLA's f32 exp may
    differ in the last ulp) (:func:`unpack_outputs_slim`)."""
    scores_k, idx_k, _counts_k, _wr_k, n, zero_sum, log_sum = outs
    f32 = jnp.float32
    return jnp.concatenate(
        [
            scores_k,
            idx_k.astype(f32),
            log_sum[:, None],
            n.astype(f32)[:, None],
            zero_sum.astype(f32)[:, None],
        ],
        axis=1,
    )


def _pack_outputs_slim_totals(outs, e_total, a_total):
    """Slim pack plus the budget-overflow totals row: (R+1, 2K+3).

    The sharded CSR step needs the e/a totals for its overflow-retry
    protocol (shared :func:`_totals_row` encoding) but has no reason to
    ship the full 4K+2 pack -- counts are not part of the jplace format
    and wr is a pure function of (scores, log_sum)."""
    body = _pack_outputs_slim(outs)
    return jnp.concatenate(
        [body, _totals_row(body.shape[1], e_total, a_total)], axis=0)


def unpack_outputs_slim(arr: np.ndarray, K: int):
    """Host-side inverse of _pack_outputs_slim; recomputes wr exactly as the
    device would (f32 exp of score - log_sum, zeroed below the double-pow
    underflow floor, mirroring _lwr_topk)."""
    scores_k = arr[:, 0:K]
    idx_k = arr[:, K : 2 * K].astype(np.int32)
    log_sum = arr[:, 2 * K]
    n = arr[:, 2 * K + 1].astype(np.int32)
    zero_sum = arr[:, 2 * K + 2] != 0
    dead = zero_sum[:, None] | (scores_k < np.float32(_POW10_ZERO))
    # mask BEFORE subtracting: dead lanes can hold -inf - -inf
    z = np.where(dead, np.float32(0), scores_k) - np.where(
        dead, np.float32(0), np.broadcast_to(log_sum[:, None], scores_k.shape)
    )
    wr = np.exp(z.astype(np.float32) * np.float32(math.log(10.0)))
    wr = np.where(dead, np.float32(0), wr).astype(np.float64)
    counts_k = np.full((arr.shape[0], K), -1, dtype=np.int64)
    return scores_k, idx_k, counts_k, wr, n, zero_sum, 0, 0


@dataclasses.dataclass
class _Pending:
    """In-flight batch: device arrays dispatched, results not yet fetched."""

    sequence_map: dict
    seqs: list
    m_signed: object
    out: tuple | None
    budgets: tuple | None
    redo: tuple | None


@dataclasses.dataclass
class _SplitPending:
    """A batch split between two engines (tiles for clean reads, classic
    CSR for ambiguous ones); results merge back into original row order."""

    sequence_map: dict
    seqs: list
    idx_clean: np.ndarray
    idx_amb: np.ndarray
    clean: _Pending
    amb: _Pending


class HostStaging:
    """Host-side batch staging shared by the single-chip and sharded placers:
    native-C++ tokenization with a GIL-releasing thread pool and threaded
    key->row binary search (the host work that overlaps device compute in
    the in-flight batch loop).

    Requires attributes: ``db``, ``k``, ``alphabet``, ``config``,
    ``_lazy_lock``, ``_native_tok``, ``_tok_pool``.
    """

    def _init_staging(self):
        import threading

        self._lazy_lock = threading.Lock()
        self._native_tok = None  # resolved lazily on first batch
        self._native_pack = None  # resolved lazily on first bytes batch
        self._tok_pool = None

    def _pack_reads_fast(self, seqs, lens_arr, Lmax: int, R: int):
        """(packed buf, amb_mask) via the native one-pass stager (GIL
        released) when the library builds, else the numpy path."""
        if self._native_pack is None:
            try:
                from ..native import native_available, native_pack_reads

                self._native_pack = (
                    native_pack_reads if native_available() else False
                )
            except Exception:
                self._native_pack = False
        if self._native_pack:
            return self._native_pack(seqs, lens_arr, self.alphabet, Lmax, R)
        R_true = len(seqs)
        flat = np.frombuffer(b"".join(seqs), np.uint8)
        starts = np.concatenate([[0], np.cumsum(lens_arr)])
        mat = np.zeros((R, Lmax), np.uint8)
        mat[np.repeat(np.arange(R_true), lens_arr),
            np.arange(flat.size) - np.repeat(starts[:-1], lens_arr)] = flat
        codes = self.alphabet.char_code[mat]
        amb_mask = ((codes >= 0x80) & (codes != 0xFF)).any(axis=1)[:R_true]
        lens_pad = np.zeros(R, np.int64)
        lens_pad[:R_true] = lens_arr
        return pack_reads(codes, lens_pad), amb_mask

    def _tokenize(self, seqs):
        """Native C++ tokenizer when built; numpy single-pass otherwise.

        With ``config.host_threads > 1`` the batch splits into chunks
        tokenized concurrently (ctypes releases the GIL during the C call)
        and the streams are re-merged with read ids offset."""
        if self._native_tok is None:
            try:
                from ..native import native_available, native_tokenize_batch

                self._native_tok = native_tokenize_batch if native_available() else False
            except Exception:
                self._native_tok = False
        tok = self._native_tok or tokenize_batch
        nt = self.config.host_threads
        if nt <= 1 or len(seqs) < 2 * nt:
            return tok(seqs, self.k, self.alphabet)
        from concurrent.futures import ThreadPoolExecutor

        from ..core.kmers import BatchTokens

        chunk = -(-len(seqs) // nt)
        parts = [seqs[i : i + chunk] for i in range(0, len(seqs), chunk)]
        if self._tok_pool is None:
            with self._lazy_lock:
                if self._tok_pool is None:
                    self._tok_pool = ThreadPoolExecutor(max_workers=nt)
        outs = list(self._tok_pool.map(lambda p: tok(p, self.k, self.alphabet), parts))
        # merge with read-id offsets
        off = 0
        e_keys, e_read, a_keys, a_read, a_order = [], [], [], [], []
        for t in outs:
            e_keys.append(t.exact_keys)
            e_read.append(t.exact_read + off)
            a_keys.append(t.amb_keys)
            a_read.append(t.amb_read + off)
            a_order.append(t.amb_order)
            off += t.num_reads
        cat = np.concatenate
        return BatchTokens(
            num_reads=off,
            num_windows=cat([t.num_windows for t in outs]),
            seq_lengths=cat([t.seq_lengths for t in outs]),
            exact_keys=cat(e_keys) if e_keys else np.empty(0, np.uint64),
            exact_read=cat(e_read).astype(np.int32),
            amb_keys=cat(a_keys) if a_keys else np.empty(0, np.uint64),
            amb_read=cat(a_read).astype(np.int32),
            amb_order=cat(a_order).astype(np.int32),
        )

    def _host_rows(self, keys: np.ndarray) -> np.ndarray:
        """Resolve keys -> dense plane row indices on the host.

        Binary search over the sorted key array (io/db.py guarantees sorted
        unique keys); misses map to the all-zero last plane row.  This is
        the host half of the lookup_where="host" fast path -- it runs on CPU
        threads that would otherwise idle while the device computes the
        previous batch."""
        dbk = self.db.keys
        n = dbk.shape[0]
        if keys.size == 0:
            return np.empty(0, np.int32)
        nt = max(1, self.config.host_threads)
        if nt > 1 and keys.size >= 1 << 16:
            from concurrent.futures import ThreadPoolExecutor

            if self._tok_pool is None:
                with self._lazy_lock:
                    if self._tok_pool is None:
                        self._tok_pool = ThreadPoolExecutor(max_workers=nt)
            chunk = -(-keys.size // nt)
            parts = [keys[i : i + chunk] for i in range(0, keys.size, chunk)]
            # np.searchsorted releases the GIL, so chunks run concurrently
            idx = np.concatenate(
                list(self._tok_pool.map(lambda q: np.searchsorted(dbk, q), parts))
            )
        else:
            idx = np.searchsorted(dbk, keys)
        idx_c = np.minimum(idx, n - 1)
        return np.where(dbk[idx_c] == keys, idx_c, n).astype(np.int32)

    def _rows_matrix(self, keys: np.ndarray, read: np.ndarray, R: int, width: int):
        """(R, width) per-read plane-row matrix in processing order; padding
        slots hold the all-zero row index."""
        zero_row = self.db.keys.shape[0]
        M = np.full((R, width), zero_row, dtype=np.int32)
        if keys.size:
            rows = self._host_rows(keys)
            counts = np.bincount(read, minlength=R)
            starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
            cols = np.arange(keys.shape[0]) - starts[read]
            M[read, cols] = rows
        return M


class JaxPlacer(HostStaging):
    """Single-device placer with the reference's ``place(batch)`` surface
    (reference: epik/src/epik/main.cpp:295,344)."""

    def __init__(
        self,
        db: PhyloKmerDB,
        tree: PhyloTree,
        keep_at_most: int | None = None,
        keep_factor: float | None = None,
        config: PlacerConfig | None = None,
    ):
        self.db = db
        self.tree = tree
        # copy: never mutate a caller-supplied config; explicit kwargs win
        self.config = dataclasses.replace(config) if config else PlacerConfig()
        if keep_at_most is not None:
            self.config.keep_at_most = keep_at_most
        if keep_factor is not None:
            self.config.keep_factor = keep_factor
        self.alphabet = get_alphabet(db.sequence_type)
        self.k = db.kmer_size
        self.B = tree.get_node_count()

        # quirk Q10: threshold from db.omega() after load
        self.eps = np.float32(score_threshold(db.omega, self.k, self.alphabet.sigma))
        self.log_eps = np.float32(np.log10(self.eps))

        # pendant/distal precompute (reference: place.cpp:98-125)
        num, tot = tree.tree_index()
        self.distal = tree.branch_lengths / 2.0
        mean = np.where(num > 1, tot / np.maximum(num, 1), 0.0)
        self.pendant = mean + self.distal

        # device-resident DB; postings packed as (P, 2) uint32 rows
        # [branch | score bits]: one contiguous row gather fetches both
        lens = np.diff(db.row_off)
        self._lens = lens
        # the cuckoo table (payload = k-mer row index; CSR byte offsets
        # derive via one row_off gather) is built LAZILY: the dense
        # host-lookup and device-tokenize paths never probe it, and its
        # build takes seconds
        self._table = None
        self._dev_table_cache = None
        self._dev_row_off_cache = None
        self._dev_postings_cache = None
        self._avg_plen = float(lens.mean()) if lens.size else 1.0
        self._max_plen = int(lens.max()) if lens.size else 0

        self._init_staging()
        #: CSR budget-overflow re-dispatches (observability; tests assert on it)
        self.overflow_retries = 0
        # memory budgets: unset ones are shares of the device's pool
        dense_budget, pair_budget, self._pair_cap = device_memory_budgets()
        if self.config.dense_db_budget is None:
            self.config.dense_db_budget = dense_budget
        if self.config.pair_plane_budget is None:
            self.config.pair_plane_budget = pair_budget

        # dense-DB planes: the bandwidth-optimal layout when they fit
        n_keys = db.num_kmers
        plane_bytes = (n_keys + 1) * self.B * 4  # one f32 score plane
        cfg_dense = self.config.dense_db
        self._dense_db = cfg_dense == "on" or (
            cfg_dense == "auto" and plane_bytes <= self.config.dense_db_budget
        )
        self._host_lookup = (
            self._dense_db and self.config.lookup_where in ("auto", "host")
        )
        #: shifted-score validity: every stored score >= log10(eps) (the
        #: load contract, quirk Q10) -- hand-built fixtures can violate it
        self._shift_ok = (
            db.scores.size == 0
            or float(db.scores.min()) >= float(self.log_eps)
        )
        # device-tokenize fast path: DNA with a direct-address key->row
        # table (4**k int32, k <= 13 -> <= 268 MB); no hash table at all
        self._fast_bytes = (
            self._dense_db
            and self.config.tokenize_where in ("auto", "device")
            and self.alphabet.sigma == 4
            and self.k <= 13
        )
        # posting-TILE mode: the big-tree fast path when the dense plane
        # does NOT fit (see _place_batch_tiles_bytes).  Decided by the DB's
        # shape and the memory budget: DNA with a direct table, shifted-
        # valid scores, the tiles within dense_db_budget, and a bounded max
        # posting length (a hot k-mer with a huge posting list would blow
        # the tile width -- fall back to CSR; the two-level split keeps the
        # MAIN plane at the length-distribution knee regardless of the max).
        self._tile_pt = -(-max(self._max_plen, 1) // 8) * 8
        tiles_bytes = (n_keys + 1) * self._tile_pt * 8
        self._tiles_mode = (
            not self._dense_db
            and self.config.tokenize_where in ("auto", "device")
            and self.config.precision == "exact"
            and self.alphabet.sigma == 4
            and self.k <= 13
            and self._shift_ok
            and n_keys > 0
            and self._max_plen <= 128
            and tiles_bytes <= self.config.dense_db_budget
        )
        self._dev_tiles_cache = None
        self._dev_direct = None
        self._direct_np = None
        # two-level tiles: set by the lazy build when the length
        # distribution makes a slimmer main plane + overflow plane cheaper
        self._tile_pt_ov = 0
        self._tile_n_ov = 0
        self._tile_frac_over = 0.0
        self._dev_tiles_ov = None
        # packed tile payload (see PlacerConfig.tile_payload): needs every
        # branch id -- including the trash column (ops/accumulate.py) -- to
        # fit 15 bits so the int32 cell stays non-negative
        _tile_bw = trash_branch(self.B) + 1
        self._tile_packed = (
            self.config.tile_payload in ("auto", "packed")
            and _tile_bw - 1 < (1 << 15)
        )
        if self.config.tile_payload == "packed" and not self._tile_packed:
            raise ValueError(
                f"tile_payload='packed' needs branch ids < 2**15 "
                f"(padded width {_tile_bw}); use 'auto' or 'f32'"
            )
        self._tile_scale = 1.0
        if self._fast_bytes or self._tiles_mode:
            direct = np.full(4**self.k, n_keys, dtype=np.int32)
            direct[db.keys.astype(np.int64)] = np.arange(n_keys, dtype=np.int32)
            self._dev_direct = jnp.asarray(direct)
            self._direct_np = direct
        # shifted plane: single-reduce scoring (see PlacerConfig.plane_mode);
        # only meaningful for the dense f32 paths
        # validity: the count term only cancels when every stored score is
        # >= log10(eps) -- guaranteed for databases loaded through the
        # omega-threshold contract (io/db.py::build_filtered, quirk Q10) but
        # not for hand-built fixtures, so it is checked, not assumed
        self._shifted = (
            self._dense_db
            and (self.config.plane_mode == "shifted"
                 or self.config.precision == "int16")
            and self.config.precision in ("exact", "int16")
            and self._host_lookup  # device-cuckoo dense path stays classic
            and self._shift_ok
        )
        # int16 quantized plane: shifted-only (values live in [0, -log_eps])
        self._plane_q = self._shifted and self.config.precision == "int16"
        self._plane_scale = 1.0
        if self._dense_db:
            rows_per_posting = np.repeat(
                np.arange(n_keys, dtype=np.int32), lens.astype(np.int64)
            )
            br = db.branches.astype(np.int32)
            if self._shifted:
                # plane holds s - log10(eps) -- strictly positive where a
                # branch is present (stored scores >= log_eps); cells that
                # would round to 0 get a tiny NORMAL positive nudge so
                # presence stays "> 0" (devices may flush subnormals)
                sp = (db.scores.astype(np.float64) - float(self.log_eps)).astype(
                    np.float32
                )
                sc = np.where(sp <= 0.0, np.float32(1e-37), sp)
            else:
                # presence is encoded as nonzero: nudge exact-0.0 stored
                # scores (P == 1) to a tiny NORMAL negative float32 -- a
                # subnormal nudge (np.nextafter from float64) underflows to
                # -0.0 and devices may flush subnormals, which would drop
                # the branch entirely
                sc = np.where(
                    db.scores == 0.0, np.float32(-1e-37), db.scores
                ).astype(np.float32)
            # rows padded to a 128 multiple (aligned row gathers); the
            # padding columns read as zeros
            self._plane_w = -(-self.B // 128) * 128
            plane_dtype = jnp.float32
            if self.config.precision == "bf16":
                plane_dtype = jnp.bfloat16
                # the f32 subnormal nudge would round to bf16 zero
                sc = np.where(sc == 0.0, np.float32(-1.2e-38), sc)
            if self._plane_q:
                # quantize the shifted values onto a 32000-step grid; present
                # cells clamp to >= 1 so presence stays "!= 0".  Row sums
                # accumulate in int32 (exact: even a 65535-window read tops
                # out at 65526 * 32000 < 2**31) and one divide recovers
                # log10 units.  The max quantum is 32000, NOT 32767: the
                # headroom keeps that worst-case sum inside int32.
                plane_dtype = jnp.int16
                span = max(float(-self.log_eps), 1e-6)
                self._plane_scale = 32000.0 / span
                sc = np.clip(
                    np.rint(sc.astype(np.float64) * self._plane_scale),
                    1, 32000,
                ).astype(np.int16)
            self._plane_s = (
                jnp.zeros((n_keys + 1, self._plane_w), plane_dtype)
                .at[rows_per_posting, br]
                .set(jnp.asarray(sc).astype(plane_dtype))
            )
        # generic-alphabet device tokenize (amino): radix-index lookup keeps
        # every device access an element gather (ops/radix_lookup.py).
        # Limb tokenization needs sigma**k < 2**48; a skewed key
        # distribution (max radix bucket > 32 probes) falls back to host.
        self._fast_codes = False
        self._radix = None
        self._dev_radix = None
        if (
            self._dense_db
            and self._shifted
            and not self._fast_bytes
            and self.config.tokenize_where in ("auto", "device")
            and n_keys > 0
            and self.alphabet.sigma**self.k < (1 << 48)
        ):
            from ..ops.radix_lookup import build_radix

            key_bits = int(self.alphabet.sigma**self.k - 1).bit_length()
            try:
                radix = build_radix(db.keys, key_bits)
            except ValueError:
                radix = None
            if radix is not None and 0 < radix.max_bucket <= 32:
                self._radix = radix
                self._dev_radix = radix.device_arrays()
                self._fast_codes = True

        # (k+1)-mer pair plane: halve the row-issue count of the bytes path
        # (see PlacerConfig.pair_plane).  Layout keeps the zero row at index
        # n_keys so every existing miss sentinel stays valid; pair rows
        # append after it.
        self._paired = False
        self._dev_combo = None
        if (
            self._fast_bytes
            and self._shifted
            and not self._plane_q
            and self.config.pair_plane in ("auto", "on")
            and self.k + 1 <= 13
            and n_keys > 0
        ):
            pu, pv, key11 = self._enumerate_pairs(n_keys)
            n_pairs = int(pu.shape[0])
            paired_bytes = (n_keys + 1 + n_pairs) * self._plane_w * 4
            if (
                self.config.pair_plane == "on"
                and paired_bytes > self._pair_cap
            ):
                # "on" overrides pair_plane_budget but not physics: a dense
                # key set pairs up to 4x the keys and the allocation would
                # run out of device memory with an opaque runtime error;
                # fail with the size
                raise ValueError(
                    f"pair_plane='on' but the combined plane needs "
                    f"{paired_bytes / 2**30:.1f} GiB "
                    f"({n_keys + 1 + n_pairs} rows x {self._plane_w} f32) — "
                    f"over the {self._pair_cap / 2**30:.0f} GiB "
                    f"device-memory cap; use pair_plane='auto' or shrink the DB"
                )
            if n_pairs > 0 and (
                paired_bytes <= self.config.pair_plane_budget
                or self.config.pair_plane == "on"
            ):
                direct11 = np.full(4 ** (self.k + 1), -1, dtype=np.int32)
                direct11[key11] = n_keys + 1 + np.arange(n_pairs, dtype=np.int32)
                # ONE-gather slot-row resolution; subsumes the
                # separate prefix/suffix/pair table lookups
                self._dev_combo = jnp.asarray(
                    build_combo_table(self._direct_np, direct11, self.k,
                                      n_keys)
                )
                # combined plane built with donated in-place fills: peak memory
                # = final + one chunk (vs 2x final for a concatenate); pair
                # rows = f32 sum of the two shifted rows, gathered from the
                # already-filled base region of the same buffer
                final = jnp.zeros((n_keys + 1 + n_pairs, self._plane_w),
                                  plane_dtype)
                final = _plane_fill(final, jnp.int32(0), self._plane_s)
                self._plane_s = None
                CH = 1 << 16
                for s in range(0, n_pairs, CH):
                    vals = (final[jnp.asarray(pu[s : s + CH])]
                            + final[jnp.asarray(pv[s : s + CH])])
                    final = _plane_fill(final, jnp.int32(n_keys + 1 + s), vals)
                self._plane_s = final
                self._paired = True
        # generic-alphabet (amino) pair plane: same identity, pair rows
        # resolved by a SECOND radix index over the sorted (k+1)-mer pair
        # keys (no direct table at sigma=20).  Off by default: the second
        # (k+1)-limb tokenize pass plus the pair radix passes may cost more
        # than the halved row gathers (the DNA pair plane resolves slots in
        # ONE gather; amino has no direct table).  Opt in with
        # pair_plane="on".
        self._paired_codes = False
        self._pair_radix = None
        self._dev_pair_radix = None
        self._n_pairs = 0
        if (
            self._fast_codes
            and not self._plane_q
            and self.config.pair_plane == "on"
            and n_keys > 0
            and self.alphabet.sigma ** (self.k + 1) < (1 << 48)
        ):
            from ..ops.radix_lookup import build_radix

            pu, pv, key11 = enumerate_pairs_generic(
                db.keys, self.k, self.alphabet.sigma
            )
            n_pairs = int(pu.shape[0])
            paired_bytes = (n_keys + 1 + n_pairs) * self._plane_w * 4
            if n_pairs > 0 and paired_bytes <= self.config.pair_plane_budget:
                kb11 = int(
                    self.alphabet.sigma ** (self.k + 1) - 1
                ).bit_length()
                try:
                    pradix = build_radix(key11, kb11)
                except ValueError:
                    pradix = None
                if pradix is not None and 0 < pradix.max_bucket <= 32:
                    final = jnp.zeros((n_keys + 1 + n_pairs, self._plane_w),
                                      plane_dtype)
                    final = _plane_fill(final, jnp.int32(0), self._plane_s)
                    self._plane_s = None
                    CH = 1 << 16
                    for s in range(0, n_pairs, CH):
                        vals = (final[jnp.asarray(pu[s : s + CH])]
                                + final[jnp.asarray(pv[s : s + CH])])
                        final = _plane_fill(final, jnp.int32(n_keys + 1 + s),
                                            vals)
                    self._plane_s = final
                    self._pair_radix = pradix
                    self._dev_pair_radix = pradix.device_arrays()
                    self._n_pairs = n_pairs
                    self._paired_codes = True

        # pair-fused posting tiles (big-tree): one 2*PT row gather per TWO
        # windows, same (k+1)-mer identity as the dense pair plane; the
        # packed payload's integer sums make accumulation order-free.
        # Off by default (it costs ~2.3x the tile memory); opt in with
        # pair_plane="on".
        self._tile_paired = (
            self._tiles_mode
            and self._tile_packed
            and self.config.pair_plane == "on"
            and self.k + 1 <= 13
        )
        self._dev_tile_direct11 = None
        # host copy of the direct table (4**k int32, up to 268 MB at k=13)
        # is only consumed by the pair enumerations; the lazy tile build
        # still needs it (the dense pair build above ran eagerly)
        if not self._tiles_mode:
            self._direct_np = None

    @property
    def path_name(self) -> str:
        """The device path a clean batch takes, e.g. "dense shifted pair-
        plane device-tokenize" (batches the path cannot take -- ambiguous
        reads on the tiles path, reads shorter than k -- use the classic
        path)."""
        if self._tiles_mode:
            payload = "packed" if self._tile_packed else "f32"
            return f"posting-tiles {payload} device-tokenize"
        if not self._dense_db:
            return "csr host-tokenize"
        parts = ["dense", "shifted" if self._shifted else "classic"]
        if self._paired or self._paired_codes:
            parts.append("pair-plane")
        if self.config.precision != "exact":
            parts.append(self.config.precision)
        fast = self._fast_bytes or self._fast_codes
        parts.append("device-tokenize" if fast else "host-tokenize")
        return " ".join(parts)

    def _enumerate_pairs(self, n_keys: int):
        return enumerate_pairs(self.db.keys, self.k, self._direct_np, n_keys)

    # -- lazily-built lookup structures -----------------------------------------
    # guarded by _lazy_lock: place() runs concurrently from the pipeline's
    # worker threads (engine/pipeline.py), and the cuckoo build is seconds

    @property
    def _dev_tiles(self):
        """Posting-tile plane, built on first use: packed int32
        (n_keys+1, PT) cells ``(branch << 16) | q`` (the default,
        PlacerConfig.tile_payload) or u32 (n_keys+1, 2*PT)
        [branch | score-bits] pairs (tile_payload="f32").

        Interleaved [branch | shifted-score-bits] pairs per key, trash-
        padded; row n_keys is all-trash (the miss row).  PT*4 bytes per key
        (packed) versus 4*B for the dense plane."""
        if self._dev_tiles_cache is None:
            with self._lazy_lock:
                if self._dev_tiles_cache is None:
                    db = self.db
                    n = db.num_kmers
                    PT = self._tile_pt
                    lens = self._lens.astype(np.int64)
                    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
                    cols = (
                        np.arange(rows.shape[0], dtype=np.int64)
                        - np.repeat(db.row_off[:-1], lens)
                    )
                    shifted = (
                        db.scores.astype(np.float64) - float(self.log_eps)
                    ).astype(np.float32)
                    if self._tile_packed:
                        # ONE int32 per cell: (branch << 16) | q with q the
                        # shifted score on a 64000-step grid, clamped >= 1
                        # so threshold-boundary postings stay "touched"
                        # (S' > 0); trash cells are (trash << 16) | 0
                        span = max(float(-self.log_eps), 1e-6)
                        self._tile_scale = 64000.0 / span
                        q = np.clip(
                            np.rint(shifted.astype(np.float64)
                                    * self._tile_scale),
                            1, 64000,
                        ).astype(np.int32)
                        vals = (db.branches.astype(np.int32) << 16) | q
                        trash_val = np.int32(trash_branch(self.B) << 16)
                        n_pairs = 0
                        if self._tile_paired:
                            pu, pv, key11 = enumerate_pairs(
                                db.keys, self.k, self._direct_np, n
                            )
                            n_pairs = int(pu.shape[0])
                            paired_bytes = (n + 1 + n_pairs) * 2 * PT * 4
                            if (n_pairs == 0
                                    or paired_bytes
                                    > self.config.dense_db_budget):
                                self._tile_paired = False
                                n_pairs = 0
                        # two-level split: the main plane keeps
                        # only the first PT_main postings per key with
                        # PT_main chosen to minimize expected cells per
                        # window (PT + safety * frac_over * PT_ov); the
                        # tail lives in a compact overflow plane addressed
                        # through a per-key overflow-row table.  Skipped in
                        # the (opt-in) pair-fused mode.
                        if not self._tile_paired and PT > 8:
                            max_plen = int(self._max_plen)
                            best, best_cost = PT, float(PT)
                            for cand in range(8, PT, 8):
                                fo = float((lens > cand).mean())
                                ptov = -(-(max_plen - cand) // 8) * 8
                                cost = cand + 2.0 * fo * ptov
                                if cost < best_cost - 0.5:
                                    best, best_cost = cand, cost
                            if best < PT and bool((lens > best).any()):
                                PT = best
                                self._tile_pt = PT
                                self._tile_pt_ov = (
                                    -(-(max_plen - PT) // 8) * 8
                                )
                                self._tile_frac_over = float(
                                    (lens > PT).mean()
                                )
                                # overflow keys take tile rows 0..n_ov-1
                                # (a row PERMUTATION baked into the direct
                                # table), so "window has overflow" is the
                                # arithmetic row < n_ov -- no per-window
                                # overflow-table gather
                                over = lens > PT
                                ov_keys = np.flatnonzero(over)
                                n_ov = ov_keys.shape[0]
                                self._tile_n_ov = n_ov
                                perm = np.empty(n, np.int64)
                                perm[ov_keys] = np.arange(n_ov)
                                perm[np.flatnonzero(~over)] = np.arange(
                                    n_ov, n
                                )
                                direct = np.full(4**self.k, n, np.int32)
                                direct[db.keys.astype(np.int64)] = (
                                    perm.astype(np.int32)
                                )
                                self._dev_direct = jnp.asarray(direct)
                                self._direct_np = direct
                                ovt = np.full(
                                    (n_ov + 1, self._tile_pt_ov),
                                    trash_val, np.int32,
                                )
                                ov_sel = cols >= PT
                                ovt[perm[rows[ov_sel]] + 1,
                                    cols[ov_sel] - PT] = vals[ov_sel]
                                self._dev_tiles_ov = jnp.asarray(ovt)
                                rows = perm[rows[~ov_sel]]
                                cols = cols[~ov_sel]
                                vals = vals[~ov_sel]
                        PTW = 2 * PT if self._tile_paired else PT
                        til = np.full((n + 1 + n_pairs, PTW), trash_val,
                                      np.int32)
                        til[rows, cols] = vals
                        if self._tile_paired:
                            # pair row = prefix postings then suffix
                            # postings (integer sums are order-free)
                            lu = lens[pu]
                            lv = lens[pv]
                            pr = n + 1 + np.arange(n_pairs, dtype=np.int64)

                            def _fill(p_rows, p_lens, src_off, col_base):
                                tot = int(p_lens.sum())
                                within = (
                                    np.arange(tot, dtype=np.int64)
                                    - np.repeat(
                                        np.concatenate(
                                            [[0], np.cumsum(p_lens)[:-1]]
                                        ),
                                        p_lens,
                                    )
                                )
                                til[
                                    np.repeat(p_rows, p_lens),
                                    within + np.repeat(col_base, p_lens),
                                ] = vals[
                                    within + np.repeat(src_off, p_lens)
                                ]

                            _fill(pr, lu, db.row_off[pu],
                                  np.zeros(n_pairs, np.int64))
                            _fill(pr, lv, db.row_off[pv], lu)
                            direct11 = np.full(4 ** (self.k + 1), -1,
                                               np.int32)
                            direct11[key11] = (
                                n + 1 + np.arange(n_pairs, dtype=np.int64)
                            ).astype(np.int32)
                            self._dev_tile_direct11 = jnp.asarray(direct11)
                        self._direct_np = None
                        self._dev_tiles_cache = jnp.asarray(til)
                        return self._dev_tiles_cache
                    til = np.empty((n + 1, 2 * PT), np.uint32)
                    til[:, 0::2] = np.uint32(trash_branch(self.B))
                    til[:, 1::2] = np.float32(0.0).view(np.uint32)
                    til[rows, 2 * cols] = db.branches.astype(np.uint32)
                    # threshold-boundary scores (s == log10(eps)) shift to
                    # exactly 0, which would drop the branch from the
                    # "touched" test (S' > 0); nudge to a tiny normal
                    # positive like the dense shifted plane
                    shifted = np.where(shifted <= 0.0, np.float32(1e-37), shifted)
                    til[rows, 2 * cols + 1] = shifted.view(np.uint32)
                    self._dev_tiles_cache = jnp.asarray(til)
        return self._dev_tiles_cache

    @property
    def table(self):
        """Cuckoo table, built on first use (device-lookup paths only)."""
        if self._table is None:
            with self._lazy_lock:
                if self._table is None:
                    self._table = build_table(
                        self.db.keys,
                        np.arange(self.db.num_kmers, dtype=np.uint32),
                        self._lens,
                    )
        return self._table

    @property
    def _dev_table(self):
        if self._dev_table_cache is None:
            self._dev_table_cache = self.table.device_arrays()
        return self._dev_table_cache

    @property
    def _dev_row_off(self):
        if self._dev_row_off_cache is None:
            self._dev_row_off_cache = jnp.asarray(self.db.row_off.astype(np.int32))
        return self._dev_row_off_cache

    @property
    def _dev_postings(self):
        if self._dev_postings_cache is None:
            packed = np.stack(
                [self.db.branches.astype(np.uint32), self.db.scores.view(np.uint32)],
                axis=1,
            )
            self._dev_postings_cache = jnp.asarray(packed)
        return self._dev_postings_cache

    # -- host-side batch staging ----------------------------------------------

    @staticmethod
    def _pad_u64_split(keys: np.ndarray, size: int):
        padded = np.full(size, _SENTINEL_KEY, dtype=np.uint64)
        padded[: keys.shape[0]] = keys
        hi = (padded >> np.uint64(32)).astype(np.uint32)
        lo = (padded & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return hi, lo

    @staticmethod
    def _key_matrix(keys: np.ndarray, read: np.ndarray, R: int, width: int):
        """(R, width) per-read key matrix in processing order, sentinel-padded."""
        M = np.full((R, width), _SENTINEL_KEY, dtype=np.uint64)
        if keys.size:
            counts = np.bincount(read, minlength=R)
            starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
            cols = np.arange(keys.shape[0]) - starts[read]
            M[read, cols] = keys
        hi = (M >> np.uint64(32)).astype(np.uint32)
        lo = (M & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return hi, lo

    @staticmethod
    def _pad_i32(arr: np.ndarray, size: int, fill: int):
        padded = np.full(size, fill, dtype=np.int32)
        padded[: arr.shape[0]] = arr
        return padded

    def place(self, records: list[tuple[str, bytes]]) -> PlacedCollection:
        """Synchronous place (reference surface: place.cpp:201)."""
        return self.place_wait(self.place_async(records))

    def place_async(self, records: list[tuple[str, bytes]]):
        """Tokenize + dispatch the device step WITHOUT blocking on results.

        JAX dispatch is asynchronous: the returned pending handle carries
        device arrays still being computed.  This enables the double-buffered
        batch loop (engine/pipeline.py) that the reference lacks -- its loop
        is fully synchronous (reference: main.cpp:332-365, dead is_busy
        helper main.cpp:39-43; SURVEY.md "Pipeline overlap (degenerate)").
        """
        cfg = self.config
        # dedup by content (quirk Q8; reference: place.cpp:73-81,207)
        sequence_map: dict[bytes, list[str]] = {}
        for header, seq in records:
            sequence_map.setdefault(seq, []).append(header)
        seqs = list(sequence_map.keys())
        R = len(seqs)
        if R == 0:
            return _Pending(sequence_map, [], None, None, None, None)

        if self._fast_bytes or self._tiles_mode:
            pending = self._place_async_bytes(sequence_map, seqs)
            if pending is not None:
                return pending
        elif self._fast_codes:
            pending = self._place_async_codes(sequence_map, seqs)
            if pending is not None:
                return pending
        return self._place_async_classic(sequence_map, seqs)

    def _place_async_classic(self, sequence_map, seqs):
        """Host-tokenize path: dense planes with host lookup/cuckoo, or the
        CSR scatter/matmul engines (the fallback for every batch shape the
        fast paths cannot take)."""
        cfg = self.config
        R = len(seqs)
        tokens = self._tokenize(seqs)
        # the correction term uses the size_t-wrapped window count (quirk Q1);
        # float32(2**64 - small) == float32(2**64), so the wrap collapses
        m_signed = tokens.seq_lengths - self.k + 1  # int64, may be negative
        m_f32 = np.where(
            m_signed >= 0,
            m_signed.astype(np.float32),
            np.float32(float(_U64)) + m_signed.astype(np.float32),
        ).astype(np.float32)

        if self._dense_db:
            wpr = int(np.bincount(tokens.exact_read, minlength=R).max()) if tokens.exact_read.size else 1
            apr = int(np.bincount(tokens.amb_read, minlength=R).max()) if tokens.amb_read.size else 1
            # multiple-of-16 buckets: a pow2 bucket wastes up to 2x row
            # gathers on the all-zero padding row
            Wmax = max(16, -(-wpr // 16) * 16)
            K = min(cfg.keep_at_most, self.B)
            if self._host_lookup:
                # Amax == 0 statically elides the ambiguity stage for
                # batches with no ambiguous windows (the common DNA case)
                Amax = _bucket(apr, 8) if tokens.amb_keys.size else 0
                rows = self._rows_matrix(tokens.exact_keys, tokens.exact_read, R, Wmax)
                arows = self._rows_matrix(tokens.amb_keys, tokens.amb_read, R, Amax)
                out = _place_batch_dense_rows(
                    self._plane_s,
                    jnp.asarray(rows), jnp.asarray(arows), jnp.asarray(m_f32),
                    R=R, B=self.B, K=K, Wmax=Wmax, Amax=Amax, k=self.k,
                    log_eps=float(self.log_eps), eps=float(self.eps),
                    shifted=self._shifted,
                    plane_scale=float(self._plane_scale),
                   
                )
                return _Pending(sequence_map, seqs, m_signed, out, None, (None, R, K))
            Amax = _bucket(apr, 8)
            e_hi, e_lo = self._key_matrix(tokens.exact_keys, tokens.exact_read, R, Wmax)
            a_hi, a_lo = self._key_matrix(tokens.amb_keys, tokens.amb_read, R, Amax)
            out = _place_batch_device_densedb(
                self._dev_table, self._plane_s,
                jnp.asarray(e_hi), jnp.asarray(e_lo),
                jnp.asarray(a_hi), jnp.asarray(a_lo), jnp.asarray(m_f32),
                R=R, B=self.B, K=K, Wmax=Wmax, Amax=Amax, k=self.k,
                seed1=self.table.seed1, seed2=self.table.seed2,
                log_eps=float(self.log_eps), eps=float(self.eps),
               
            )
            return _Pending(sequence_map, seqs, m_signed, out, None, (None, R, K))

        E = _bucket(tokens.exact_keys.shape[0], cfg.min_bucket)
        A = _bucket(tokens.amb_keys.shape[0], cfg.min_bucket)
        e_hi, e_lo = self._pad_u64_split(tokens.exact_keys, E)
        a_hi, a_lo = self._pad_u64_split(tokens.amb_keys, A)
        e_read = self._pad_i32(tokens.exact_read, E, R)
        a_read = self._pad_i32(tokens.amb_read, A, R)
        a_order = self._pad_i32(tokens.amb_order, A, 2**31 - 1)

        est = max(1, int(self._avg_plen * cfg.budget_headroom))
        P = _bucket(tokens.exact_keys.shape[0] * est, cfg.min_bucket)
        PA = _bucket(tokens.amb_keys.shape[0] * est, cfg.min_bucket)
        # lax.top_k needs K <= B; tiny trees report at most B branches anyway
        K = min(cfg.keep_at_most, self.B)

        inputs = (
            e_hi, e_lo, e_read, a_hi, a_lo, a_read, a_order, m_f32,
        )
        out = self._dispatch(inputs, R, K, P, PA)
        return _Pending(sequence_map, seqs, m_signed, out, (P, PA), (inputs, R, K))

    def _place_async_bytes(self, sequence_map, seqs):
        staged = self._stage_bytes(seqs)
        if staged is None:
            return None
        if staged[0] == "amb_split":
            amb_mask = staged[1]
            idx_a = np.flatnonzero(amb_mask)
            idx_c = np.flatnonzero(~amb_mask)
            if idx_c.size == 0:
                return None  # every read ambiguous: whole-batch classic
            seqs_c = [seqs[i] for i in idx_c]
            seqs_a = [seqs[i] for i in idx_a]
            st_c = self._stage_bytes(seqs_c)
            if st_c is None or st_c[0] == "amb_split":  # pragma: no cover
                return None
            fn, arrays, m_signed, R_true, K, *retry = st_c
            budget = (*retry[0], arrays) if retry else None
            pend_c = _Pending({s: sequence_map[s] for s in seqs_c}, seqs_c,
                              m_signed, fn(*arrays), budget,
                              (None, R_true, K))
            pend_a = self._place_async_classic(
                {s: sequence_map[s] for s in seqs_a}, seqs_a
            )
            return _SplitPending(sequence_map, seqs, idx_c, idx_a,
                                 pend_c, pend_a)
        fn, arrays, m_signed, R_true, K, *retry = staged
        budget = (*retry[0], arrays) if retry else None
        out = fn(*arrays)
        return _Pending(sequence_map, seqs, m_signed, out, budget,
                        (None, R_true, K))

    def _stage_bytes(self, seqs):
        """Stage the device-tokenize fast path: one small uint8 H2D transfer.

        Returns ``(fn, arrays, m_signed, R_true, K)`` with ``fn(*arrays)``
        the fused jitted step, or None when the batch cannot take the fast
        path (every read shorter than k), in which case the caller falls
        back to the classic
        host-tokenize path.
        """
        cfg = self.config
        R_true = len(seqs)
        lens_arr = np.fromiter((len(s) for s in seqs), np.int64, count=R_true)
        Lmax_true = int(lens_arr.max())
        if Lmax_true < self.k:
            return None  # no window anywhere; classic path handles fallback
        if Lmax_true > 0xFFFF:
            return None  # packed length field is uint16; classic path

        # R is a static jit argument; dedup makes the unique-read count
        # wander batch to batch, so pad to a bucket to keep the jit cache
        # bounded (padding rows are all-invalid -> sliced off on fetch).
        # Large batches use a coarser bucket: dedup jitter of a few hundred
        # reads must not spread across several compiled shapes.
        gran = 256 if R_true > 2048 else 64
        R = -(-R_true // gran) * gran
        Lmax = _bucket_lmax(Lmax_true)  # bucketed jit cache

        m_signed = lens_arr - self.k + 1  # host copy for assembly (quirk Q1)

        # packed buffer + per-read ambiguity flags in one native pass; the
        # ambiguity stream is host-tokenized only for flagged reads (quirks
        # Q6/Q7; the device exact path already excludes every window
        # touching a non-exact character)
        buf, amb_mask = self._pack_reads_fast(seqs, lens_arr, Lmax, R)
        if self._tiles_mode:
            # packed-tile exactness gate: per-(read, branch) integer sums
            # are bounded by W * 64000 and must fit the int32 accumulator
            # -- longer reads (W >= 33554) take the classic CSR path
            if self._tile_packed and (Lmax - self.k + 1) * 64000 >= (1 << 31):
                return None
            if amb_mask.any():
                # rare: the caller splits the batch -- clean reads stay on
                # the tiles path, ambiguous reads take the classic CSR path
                return ("amb_split", amb_mask)
            K = min(cfg.keep_at_most, self.B)
            tiles = self._dev_tiles  # build first: sets _tile_scale/_tile_paired
            if self._tile_paired:
                fn = functools.partial(
                    _place_batch_tiles_paired,
                    R=R, B=self.B, K=K, k=self.k, Lmax=Lmax,
                    num_kmers=self.db.num_kmers, PT=self._tile_pt,
                    log_eps=float(self.log_eps), eps=float(self.eps),
                    tile_scale=float(self._tile_scale),
                   
                )
                arrays = (tiles, self._dev_direct, self._dev_tile_direct11,
                          jnp.asarray(buf))
                return fn, arrays, m_signed, R_true, K
            if self._tile_pt_ov > 0:
                # static overflow-window budget: expected overflow windows
                # per read x2 safety, bucketed; the step reports the true
                # per-read count and place_wait retries with a bigger OV
                # on the (rare) read that exceeds it
                W = Lmax - self.k + 1
                OV = min(W, _bucket(
                    max(8, int(W * self._tile_frac_over * 2.0) + 4), 8))

                def fn_ov(OV_, _W=W):
                    return functools.partial(
                        _place_batch_tiles_bytes,
                        R=R, B=self.B, K=K, k=self.k, Lmax=Lmax,
                        num_kmers=self.db.num_kmers, PT=self._tile_pt,
                        log_eps=float(self.log_eps), eps=float(self.eps),
                        packed=self._tile_packed,
                        tile_scale=float(self._tile_scale),
                        PT_OV=self._tile_pt_ov, OV=min(OV_, _W),
                        N_OV=self._tile_n_ov,
                       
                    )

                arrays = (tiles, self._dev_direct, jnp.asarray(buf),
                          self._dev_tiles_ov)
                return fn_ov(OV), arrays, m_signed, R_true, K, (
                    "tiles_ov", OV, fn_ov)
            fn = functools.partial(
                _place_batch_tiles_bytes,
                R=R, B=self.B, K=K, k=self.k, Lmax=Lmax,
                num_kmers=self.db.num_kmers, PT=self._tile_pt,
                log_eps=float(self.log_eps), eps=float(self.eps),
                packed=self._tile_packed,
                tile_scale=float(self._tile_scale),
               
            )
            arrays = (tiles, self._dev_direct, jnp.asarray(buf))
            return fn, arrays, m_signed, R_true, K
        if amb_mask.any():
            idxs = np.flatnonzero(amb_mask)
            tok = self._tokenize([seqs[i] for i in idxs])
            a_keys = tok.amb_keys
            a_read = idxs[tok.amb_read] if a_keys.size else tok.amb_read
            apr = int(np.bincount(a_read, minlength=R).max()) if a_keys.size else 0
            Amax = _bucket(apr, 8) if a_keys.size else 0
            arows = self._rows_matrix(a_keys, a_read, R, Amax)
        else:
            Amax = 0
            arows = np.zeros((R, 0), np.int32)

        K = min(cfg.keep_at_most, self.B)
        if self._paired:
            fn = functools.partial(
                _place_batch_dense_paired,
                R=R, B=self.B, K=K, Amax=Amax, k=self.k, Lmax=Lmax,
                num_kmers=self.db.num_kmers,
                log_eps=float(self.log_eps), eps=float(self.eps),
               
            )
            arrays = (
                self._plane_s, self._dev_combo,
                jnp.asarray(buf), jnp.asarray(arows),
            )
            return fn, arrays, m_signed, R_true, K
        fn = functools.partial(
            _place_batch_dense_bytes,
            R=R, B=self.B, K=K, Amax=Amax, k=self.k, Lmax=Lmax,
            num_kmers=self.db.num_kmers,
            log_eps=float(self.log_eps), eps=float(self.eps),
            shifted=self._shifted,
            plane_scale=float(self._plane_scale),
        )
        arrays = (
            self._plane_s, self._dev_direct, jnp.asarray(buf), jnp.asarray(arows),
        )
        return fn, arrays, m_signed, R_true, K

    def _place_async_codes(self, sequence_map, seqs):
        staged = self._stage_codes(seqs)
        if staged is None:
            return None
        fn, arrays, m_signed, R_true, K = staged
        out = fn(*arrays)
        return _Pending(sequence_map, seqs, m_signed, out, None, (None, R_true, K))

    def _stage_codes(self, seqs):
        """Stage the generic-alphabet device path (amino): ship one uint8
        codes buffer; window keys, radix lookup, and the row gather all run
        on chip.  Mirrors :meth:`_stage_bytes`."""
        cfg = self.config
        R_true = len(seqs)
        lens_arr = np.fromiter((len(s) for s in seqs), np.int64, count=R_true)
        Lmax_true = int(lens_arr.max())
        if Lmax_true < self.k or Lmax_true > 0xFFFF:
            return None

        gran = 256 if R_true > 2048 else 64
        R = -(-R_true // gran) * gran
        Lmax = _bucket_lmax(Lmax_true)
        flat = np.frombuffer(b"".join(seqs), np.uint8)
        starts = np.concatenate([[0], np.cumsum(lens_arr)])
        mat = np.zeros((R, Lmax), np.uint8)
        mat[np.repeat(np.arange(R_true), lens_arr),
            np.arange(flat.size) - np.repeat(starts[:-1], lens_arr)] = flat

        m_signed = lens_arr - self.k + 1
        codes = self.alphabet.char_code[mat]
        amb_mask = ((codes >= 0x80) & (codes != 0xFF)).any(axis=1)
        if amb_mask.any():
            idxs = np.flatnonzero(amb_mask)
            tok = self._tokenize([seqs[i] for i in idxs])
            a_keys = tok.amb_keys
            a_read = idxs[tok.amb_read] if a_keys.size else tok.amb_read
            apr = int(np.bincount(a_read, minlength=R).max()) if a_keys.size else 0
            Amax = _bucket(apr, 8) if a_keys.size else 0
            arows = self._rows_matrix(a_keys, a_read, R, Amax)
        else:
            Amax = 0
            arows = np.zeros((R, 0), np.int32)

        K = min(cfg.keep_at_most, self.B)
        buf = np.concatenate([codes, np.zeros((R, 2), np.uint8)], axis=1)
        buf[:R_true, Lmax] = lens_arr & 0xFF
        buf[:R_true, Lmax + 1] = lens_arr >> 8
        off, low = self._dev_radix
        r_shift, r_probe, r_off_bits = self._radix.dispatch_args()
        if self._paired_codes:
            pr = self._pair_radix
            p_shift, p_probe, p_off_bits = pr.dispatch_args()
            fn = functools.partial(
                _place_batch_dense_codes_paired,
                R=R, B=self.B, K=K, Amax=Amax, k=self.k,
                sigma=self.alphabet.sigma, Lmax=Lmax,
                num_kmers=self.db.num_kmers, n_pairs=self._n_pairs,
                shift=r_shift, n_probe=r_probe, off_bits=r_off_bits,
                p_shift=p_shift, p_probe=p_probe, p_off_bits=p_off_bits,
                log_eps=float(self.log_eps), eps=float(self.eps),
               
            )
            poff, plow = self._dev_pair_radix
            arrays = (self._plane_s, off, low, poff, plow,
                      jnp.asarray(buf), jnp.asarray(arows))
            return fn, arrays, m_signed, R_true, K
        fn = functools.partial(
            _place_batch_dense_codes,
            R=R, B=self.B, K=K, Amax=Amax, k=self.k,
            sigma=self.alphabet.sigma, Lmax=Lmax,
            num_kmers=self.db.num_kmers,
            shift=r_shift, n_probe=r_probe, off_bits=r_off_bits,
            log_eps=float(self.log_eps), eps=float(self.eps),
            plane_scale=float(self._plane_scale),
        )
        arrays = (self._plane_s, off, low, jnp.asarray(buf), jnp.asarray(arows))
        return fn, arrays, m_signed, R_true, K

    def _dispatch(self, inputs, R, K, P, PA):
        e_hi, e_lo, e_read, a_hi, a_lo, a_read, a_order, m_f32 = inputs
        return _place_batch_device(
            self._dev_table,
            self._dev_postings,
            self._dev_row_off,
            jnp.asarray(e_hi),
            jnp.asarray(e_lo),
            jnp.asarray(e_read),
            jnp.asarray(a_hi),
            jnp.asarray(a_lo),
            jnp.asarray(a_read),
            jnp.asarray(a_order),
            jnp.asarray(m_f32),
            R=R,
            B=self.B,
            K=K,
            P=P,
            PA=PA,
            k=self.k,
            seed1=self.table.seed1,
            seed2=self.table.seed2,
            log_eps=float(self.log_eps),
            eps=float(self.eps),
        )

    def place_wait(self, pending: "_Pending") -> PlacedCollection:
        """Block on a pending batch, re-dispatching on budget overflow."""
        if isinstance(pending, _SplitPending):
            return self._merge_split(pending)
        if pending.out is None:
            return PlacedCollection(sequence_map=pending.sequence_map, placed_seqs=[])
        cfg = self.config
        inputs, R, K = pending.redo
        if pending.budgets is not None and pending.budgets[0] == "tiles_ov":
            # two-level tiles: the last result column carries each read's
            # true overflow-window count; a read above the static OV
            # budget re-dispatches the SAME staged arrays with a bigger
            # budget (exactness by retry, like the CSR posting budgets)
            _, OV, fn_ov, arrays = pending.budgets
            out = pending.out
            while True:
                arr = np.asarray(out)
                ovmax = int(arr[:, -1].max()) if arr.shape[0] else 0
                if ovmax <= OV:
                    break
                self.overflow_retries += 1
                OV = _bucket(ovmax, 8)  # fn_ov clamps to the window count
                out = fn_ov(OV)(*arrays)
            (scores_k, idx_k, counts_k, wr_k, n_touched, zero_sum, _, _) = (
                unpack_outputs_slim(arr[:, :-1], K)
            )
            return self._assemble(
                pending.seqs, pending.sequence_map, pending.m_signed,
                scores_k[:R], idx_k[:R], counts_k[:R], wr_k[:R],
                n_touched[:R], zero_sum[:R], K,
            )
        if pending.budgets is None:  # dense-DB mode: no overflow retries
            arr = np.asarray(pending.out)
            # shifted paths ship the slim (R, 2K+3) pack; classic the
            # (R+1, 4K+2) full pack -- widths are distinct for every K >= 1
            unpack = unpack_outputs_slim if arr.shape[1] == 2 * K + 3 else unpack_outputs
            (scores_k, idx_k, counts_k, wr_k, n_touched, zero_sum, _, _) = unpack(
                arr, K
            )
            # the bytes path pads R to a 64 multiple; drop padding rows
            return self._assemble(
                pending.seqs, pending.sequence_map, pending.m_signed,
                scores_k[:R], idx_k[:R], counts_k[:R], wr_k[:R],
                n_touched[:R], zero_sum[:R], K,
            )
        P, PA = pending.budgets
        out = pending.out
        while True:
            # one packed transfer for the whole result
            (scores_k, idx_k, counts_k, wr_k, n_touched, zero_sum, e_total, a_total) = (
                unpack_outputs(np.asarray(out), K)
            )
            if e_total <= P and a_total <= PA:
                break
            # budget overflow: grow the static budget bucket and re-run
            self.overflow_retries += 1
            P = _bucket(int(e_total), cfg.min_bucket) if e_total > P else P
            PA = _bucket(int(a_total), cfg.min_bucket) if a_total > PA else PA
            out = self._dispatch(inputs, R, K, P, PA)

        return self._assemble(
            pending.seqs, pending.sequence_map, pending.m_signed,
            scores_k, idx_k, counts_k, wr_k, n_touched, zero_sum, K,
        )

    def _merge_split(self, pending: "_SplitPending") -> ArrayPlacedCollection:
        """Merge a split batch's two array collections back into the
        original unique-sequence row order."""
        col_c = self.place_wait(pending.clean)
        col_a = self.place_wait(pending.amb)
        R = len(pending.seqs)
        Kmax = max(col_c.ids.shape[1], col_a.ids.shape[1])

        def alloc(ref):
            return np.zeros((R, Kmax), ref.dtype)

        ids = alloc(col_c.ids)
        scores = alloc(col_c.scores)
        wr = alloc(col_c.wr)
        counts = alloc(col_c.counts)
        dist = alloc(col_c.dist)
        pend = alloc(col_c.pend)
        keep = np.zeros((R, Kmax), bool)
        for idx, col in ((pending.idx_clean, col_c), (pending.idx_amb, col_a)):
            w = col.ids.shape[1]
            ids[idx, :w] = col.ids
            scores[idx, :w] = col.scores
            wr[idx, :w] = col.wr
            counts[idx, :w] = col.counts
            dist[idx, :w] = col.dist
            pend[idx, :w] = col.pend
            keep[idx, :w] = col.keep
        return ArrayPlacedCollection(
            pending.sequence_map, pending.seqs, ids, scores, wr, counts,
            dist, pend, keep,
        )

    def device_fn_args(self, records: list[tuple[str, bytes]]):
        """(jittable fn, example array args) for the staged device step.

        Used by the harness entry point and benchmarks: ``fn(*args)`` is the
        full fused placement step with all static parameters bound.  Stages
        the PRODUCTION path for this placer's configuration: the
        device-tokenize step when active (the dense DNA fast path or the
        big-tree tiles path; a batch with ambiguous reads stages the
        classic path), the host-lookup dense-rows step for other dense
        configs, and the CSR scatter step otherwise.
        """
        cfg = self.config
        sequence_map: dict[bytes, list[str]] = {}
        for header, seq in records:
            sequence_map.setdefault(seq, []).append(header)
        seqs = list(sequence_map.keys())
        R = len(seqs)

        if self._fast_bytes or self._tiles_mode:
            staged = self._stage_bytes(seqs)
            if staged is not None and staged[0] != "amb_split":
                return staged[0], staged[1]

        tokens = self._tokenize(seqs)
        if self._dense_db and self._host_lookup:
            m_signed = tokens.seq_lengths - self.k + 1
            m_f32 = np.where(
                m_signed >= 0,
                m_signed.astype(np.float32),
                np.float32(float(_U64)) + m_signed.astype(np.float32),
            ).astype(np.float32)
            wpr = int(np.bincount(tokens.exact_read, minlength=R).max()) if tokens.exact_read.size else 1
            apr = int(np.bincount(tokens.amb_read, minlength=R).max()) if tokens.amb_read.size else 1
            Wmax = max(16, -(-wpr // 16) * 16)
            Amax = _bucket(apr, 8) if tokens.amb_keys.size else 0
            rows = self._rows_matrix(tokens.exact_keys, tokens.exact_read, R, Wmax)
            arows = self._rows_matrix(tokens.amb_keys, tokens.amb_read, R, Amax)
            fn = functools.partial(
                _place_batch_dense_rows,
                R=R, B=self.B, K=min(cfg.keep_at_most, self.B),
                Wmax=Wmax, Amax=Amax, k=self.k,
                log_eps=float(self.log_eps), eps=float(self.eps),
                shifted=self._shifted,
                plane_scale=float(self._plane_scale),
            )
            args = (
                self._plane_s, jnp.asarray(rows), jnp.asarray(arows),
                jnp.asarray(m_f32),
            )
            return fn, args
        m_signed = tokens.seq_lengths - self.k + 1
        m_f32 = np.where(
            m_signed >= 0,
            m_signed.astype(np.float32),
            np.float32(float(_U64)) + m_signed.astype(np.float32),
        ).astype(np.float32)
        E = _bucket(tokens.exact_keys.shape[0], cfg.min_bucket)
        A = _bucket(tokens.amb_keys.shape[0], cfg.min_bucket)
        e_hi, e_lo = self._pad_u64_split(tokens.exact_keys, E)
        a_hi, a_lo = self._pad_u64_split(tokens.amb_keys, A)
        est = max(1, int(self._avg_plen * cfg.budget_headroom))
        statics = dict(
            R=R, B=self.B, K=min(cfg.keep_at_most, self.B),
            P=_bucket(tokens.exact_keys.shape[0] * est, cfg.min_bucket),
            PA=_bucket(tokens.amb_keys.shape[0] * est, cfg.min_bucket),
            k=self.k, seed1=self.table.seed1, seed2=self.table.seed2,
            log_eps=float(self.log_eps), eps=float(self.eps),
        )
        fn = functools.partial(_place_batch_device, **statics)
        args = (
            self._dev_table, self._dev_postings, self._dev_row_off,
            jnp.asarray(e_hi), jnp.asarray(e_lo),
            jnp.asarray(self._pad_i32(tokens.exact_read, E, R)),
            jnp.asarray(a_hi), jnp.asarray(a_lo),
            jnp.asarray(self._pad_i32(tokens.amb_read, A, R)),
            jnp.asarray(self._pad_i32(tokens.amb_order, A, 2**31 - 1)),
            jnp.asarray(m_f32),
        )
        return fn, args

    # -- host-side row assembly ------------------------------------------------

    def _assemble(
        self, seqs, sequence_map, m_signed, scores_k, idx_k, counts_k, wr_k, n_touched, zero_sum, K
    ) -> ArrayPlacedCollection:
        return assemble_arrays(
            seqs, sequence_map, m_signed, scores_k, idx_k, counts_k, wr_k,
            n_touched, zero_sum, K,
            distal=self.distal, pendant=self.pendant, log_eps=self.log_eps,
            k=self.k, B=self.B, keep_at_most=self.config.keep_at_most,
            keep_factor=self.config.keep_factor,
        )


def assemble_arrays(
    seqs, sequence_map, m_signed, scores_k, idx_k, counts_k, wr_k,
    n_touched, zero_sum, K, *, distal, pendant, log_eps, k, B,
    keep_at_most, keep_factor,
) -> ArrayPlacedCollection:
    """Vectorized jplace-row decisions; returns an array-backed batch.

    Shared by the single-chip and sharded placers.  Object construction
    (engine/types.py::ArrayPlacedCollection) is deferred to first use --
    the jplace writer serializes straight from these arrays (io/jplace.py
    fast path), so in production no Python ``Placement`` objects are ever
    built.
    """
    n_eff = np.minimum(n_touched, K)
    # keep-factor filter precomputed: threshold = best_wr * kf (quirk Q3
    # zeroes kf); placements are score-desc so wr_k[:, 0] is the best
    kf = np.where(zero_sum, 0.0, keep_factor)
    thresh = wr_k[:, 0] * kf
    jcols = np.arange(K)[None, :]
    keep = (jcols < n_eff[:, None]) & (wr_k >= thresh[:, None])

    ids = idx_k.astype(np.int32, copy=True)
    scores = scores_k.astype(np.float32, copy=True)
    wr = wr_k.astype(np.float64, copy=True)
    counts = counts_k.astype(np.int32, copy=True)
    dist = distal[idx_k]
    pend = pendant[idx_k]

    fb = n_touched == 0
    if fb.any() and keep_at_most > K:
        # the fallback fabricates keep_at_most rows even when the tree
        # has fewer branches (reference loops 0..keep_at_most regardless,
        # place.cpp:141-152); widen the batch to hold them
        pad = ((0, 0), (0, keep_at_most - K))
        ids = np.pad(ids, pad)
        scores = np.pad(scores, pad)
        wr = np.pad(wr, pad)
        counts = np.pad(counts, pad)
        dist = np.pad(dist, pad)
        pend = np.pad(pend, pad)
        keep = np.pad(keep, pad)  # padded columns stay filtered out
        K = keep_at_most
    if fb.any():
        # no-match fallback, vectorized (quirk Q2; reference:
        # place.cpp:141-152,164-184): K fabricated placements on branches
        # 0..K-1, score ts = f32(log_eps * m / k) with the size_t-wrapped
        # window count m (quirk Q1), weight ratio power/(B*power) in
        # double with underflow-to-zero (Q3).
        m_f64 = m_signed.astype(np.float64)
        m_w32 = np.where(
            m_signed >= 0, m_f64, m_f64 + float(_U64)
        ).astype(np.float32)
        ts32 = log_eps * m_w32 / np.float32(k)  # f32 math
        power = 10.0 ** ts32.astype(np.float64)
        score_sum = float(B) * power
        wr_fb = np.divide(
            power, score_sum,
            out=np.zeros_like(power),
            where=(score_sum != 0.0) & (power != 0.0),
        )
        ids[fb] = np.arange(K, dtype=np.int32)[None, :]
        scores[fb] = ts32[fb][:, None]
        wr[fb] = wr_fb[fb][:, None]
        counts[fb] = 0
        dist[fb] = 0.0
        pend[fb] = 0.0
        # all K fabricated rows survive the ratio filter: equal ratios
        # always pass wr >= wr*kf (and Q3 zeroes kf when the sum is 0)
        keep[fb] = True

    return ArrayPlacedCollection(
        sequence_map, seqs, ids, scores, wr, counts, dist, pend, keep
    )
