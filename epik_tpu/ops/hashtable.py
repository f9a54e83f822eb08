"""Bucketed cuckoo hash table: host build + device lookup.

The reference queries a Boost-serialized hash map key-by-key from OpenMP
threads (reference: epik/src/epik/place.cpp:301,311 ``db.search(key)``).
A batched device program has no pointer-chasing hash map; the design here
is a **static 2-choice bucketed cuckoo table** living in device memory as
four flat arrays:

    key_hi, key_lo : uint32[nb, BUCKET]   (64-bit k-mer key, split)
    off, len       : uint32[nb, BUCKET]   (CSR posting-list slice)

Lookup of a batch of keys is two vectorized gathers (one bucket per hash
function, ``BUCKET=4`` slots each) + eight lane compares -- O(1) memory
rounds versus log2(n) dependent gathers for binary search, which matters
because memory latency, not FLOPs, bounds this op (SURVEY.md section 2:
"integer-keyed gather from a big table").

All arithmetic is uint32 (wrapping), so the same code runs on the device
without enabling jax x64.  The table is built once on host at DB load time
(SURVEY.md section 5.4: persistable as a cache).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["CuckooTable", "build_table", "lookup"]

BUCKET = 4
_EMPTY32 = np.uint32(0xFFFFFFFF)
#: keys are < 2**62 for every supported codec (DNA k<=16 -> 32 bits; amino
#: k<=14 -> 20**14 < 2**61), so an all-ones hi word can never be a real key.
_EMPTY_HI = _EMPTY32


def _fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3 finalizer (public-domain mixing constants); uint32 wraparound
    is intended."""
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85EBCA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
    return x


def _hash2_np(hi: np.ndarray, lo: np.ndarray, seed1: int, seed2: int, mask: int):
    h1 = _fmix32(lo ^ _fmix32(hi ^ np.uint32(seed1))) & np.uint32(mask)
    h2 = _fmix32(lo ^ _fmix32(hi ^ np.uint32(seed2))) & np.uint32(mask)
    return h1, h2


def _fmix32_jnp(x):
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> jnp.uint32(13))
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> jnp.uint32(16))
    return x


@dataclasses.dataclass
class CuckooTable:
    """Device-shippable lookup structure (a pytree of four arrays + seeds)."""

    key_hi: np.ndarray  # uint32[nb, BUCKET]
    key_lo: np.ndarray  # uint32[nb, BUCKET]
    off: np.ndarray  # uint32[nb, BUCKET]
    length: np.ndarray  # uint32[nb, BUCKET]
    seed1: int
    seed2: int

    @property
    def num_buckets(self) -> int:
        return self.key_hi.shape[0]

    def packed(self) -> np.ndarray:
        """One (nb, 4*BUCKET) uint32 array: [key_hi | key_lo | off | len].

        A bucket probe is then ONE contiguous row gather instead of four
        narrow gathers."""
        return np.concatenate([self.key_hi, self.key_lo, self.off, self.length], axis=1)

    def device_arrays(self):
        return jnp.asarray(self.packed())


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def build_table(
    keys: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    load_factor: float = 0.85,
    max_kicks: int = 512,
    seed: int = 0x9E3779B9,
    min_buckets: int = 1,
) -> CuckooTable:
    """Build the table on host from sorted-unique uint64 keys + CSR slices.

    Bulk pass: vectorized placement of up to BUCKET keys per h1 bucket;
    leftovers go through classic cuckoo random-walk eviction.  On a (rare)
    failure the whole build retries with fresh seeds.  ``min_buckets`` forces
    a common geometry across shards so per-shard tables can be stacked.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    n = keys.shape[0]
    nb = max(
        _next_pow2(max(1, int(np.ceil(n / (BUCKET * load_factor))))), min_buckets
    )
    mask = nb - 1
    rng = np.random.default_rng(seed)

    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    off32 = np.asarray(offsets, dtype=np.uint32)
    len32 = np.asarray(lengths, dtype=np.uint32)

    for _attempt in range(16):
        seed1 = int(rng.integers(1 << 32, dtype=np.uint64))
        seed2 = int(rng.integers(1 << 32, dtype=np.uint64))
        t_hi = np.full((nb, BUCKET), _EMPTY_HI, dtype=np.uint32)
        t_lo = np.full((nb, BUCKET), _EMPTY32, dtype=np.uint32)
        t_off = np.zeros((nb, BUCKET), dtype=np.uint32)
        t_len = np.zeros((nb, BUCKET), dtype=np.uint32)
        if n == 0:
            return CuckooTable(t_hi, t_lo, t_off, t_len, seed1, seed2)

        h1, h2 = _hash2_np(hi, lo, seed1, seed2, mask)

        # --- bulk pass: first BUCKET arrivals per h1 bucket, vectorized ------
        order = np.argsort(h1, kind="stable")
        sh = h1[order]
        idx = np.arange(n)
        new_group = np.empty(n, dtype=bool)
        new_group[0] = True
        new_group[1:] = sh[1:] != sh[:-1]
        group_start = np.maximum.accumulate(np.where(new_group, idx, 0))
        rank = idx - group_start
        fits = rank < BUCKET
        rows = sh[fits]
        cols = rank[fits]
        src = order[fits]
        t_hi[rows, cols] = hi[src]
        t_lo[rows, cols] = lo[src]
        t_off[rows, cols] = off32[src]
        t_len[rows, cols] = len32[src]

        # --- bulk retry rounds: place overflow keys into their alternate
        # bucket (and back), vectorized; only true double-full stragglers
        # reach the scalar eviction walk
        leftovers = order[~fits]
        hh = (h2, h1)
        occupancy = np.count_nonzero(t_hi != _EMPTY_HI, axis=1)
        for round_i in range(6):
            if leftovers.size == 0:
                break
            h = hh[round_i % 2]
            l2 = leftovers[np.argsort(h[leftovers], kind="stable")]
            sh2 = h[l2]
            idx2 = np.arange(l2.shape[0])
            ng2 = np.empty(l2.shape[0], dtype=bool)
            ng2[0] = True
            ng2[1:] = sh2[1:] != sh2[:-1]
            gs2 = np.maximum.accumulate(np.where(ng2, idx2, 0))
            rank2 = idx2 - gs2 + occupancy[sh2]
            fits2 = rank2 < BUCKET
            rows2, cols2, src2 = sh2[fits2], rank2[fits2], l2[fits2]
            t_hi[rows2, cols2] = hi[src2]
            t_lo[rows2, cols2] = lo[src2]
            t_off[rows2, cols2] = off32[src2]
            t_len[rows2, cols2] = len32[src2]
            np.add.at(occupancy, rows2, 1)
            leftovers = l2[~fits2]

        # --- eviction pass for the few remaining keys ------------------------
        ok = True
        for i in leftovers:
            cur = (int(hi[i]), int(lo[i]), int(off32[i]), int(len32[i]))
            b = int(h2[i])  # h1 bucket is full by construction
            placed = False
            for _kick in range(max_kicks):
                empty = np.nonzero(t_hi[b] == _EMPTY_HI)[0]
                if empty.size:
                    c = int(empty[0])
                    t_hi[b, c], t_lo[b, c], t_off[b, c], t_len[b, c] = cur
                    placed = True
                    break
                # evict a random slot, move the victim to its other bucket
                c = int(rng.integers(BUCKET))
                victim = (int(t_hi[b, c]), int(t_lo[b, c]), int(t_off[b, c]), int(t_len[b, c]))
                t_hi[b, c], t_lo[b, c], t_off[b, c], t_len[b, c] = cur
                vh1, vh2 = _hash2_np(
                    np.uint32(victim[0]), np.uint32(victim[1]), seed1, seed2, mask
                )
                b = int(vh2) if b == int(vh1) else int(vh1)
                cur = victim
            if not placed:
                ok = False
                break
        if ok:
            return CuckooTable(t_hi, t_lo, t_off, t_len, seed1, seed2)
    raise RuntimeError(f"cuckoo build failed for n={n} nb={nb} after 16 seed retries")


def lookup(table_packed, seed1: int, seed2: int, key_hi, key_lo):
    """Vectorized device lookup: keys -> (found, off, len).

    ``table_packed``: the (nb, 4*BUCKET) array from
    :meth:`CuckooTable.device_arrays` -- each bucket probe is one contiguous
    row gather.  Misses (including padding sentinels) return len == 0, which
    makes a missing k-mer naturally contribute nothing downstream -- this is
    also what makes hash-sharded multi-device lookup routing-free
    (SURVEY.md section 5.8: a non-owned key simply misses the local shard).
    """
    nb = table_packed.shape[0]
    mask = jnp.uint32(nb - 1)
    key_hi = key_hi.astype(jnp.uint32)
    key_lo = key_lo.astype(jnp.uint32)
    h1 = _fmix32_jnp(key_lo ^ _fmix32_jnp(key_hi ^ jnp.uint32(seed1))) & mask
    h2 = _fmix32_jnp(key_lo ^ _fmix32_jnp(key_hi ^ jnp.uint32(seed2))) & mask

    g1 = table_packed[h1]  # (E, 4*BUCKET) single row gather per probe
    g2 = table_packed[h2]
    b = BUCKET
    cand_hi = jnp.concatenate([g1[..., 0:b], g2[..., 0:b]], axis=-1)
    cand_lo = jnp.concatenate([g1[..., b : 2 * b], g2[..., b : 2 * b]], axis=-1)
    cand_off = jnp.concatenate([g1[..., 2 * b : 3 * b], g2[..., 2 * b : 3 * b]], axis=-1)
    cand_len = jnp.concatenate([g1[..., 3 * b : 4 * b], g2[..., 3 * b : 4 * b]], axis=-1)

    # exclude empty slots: their marker equals the padding sentinel key, and
    # real keys never have an all-ones hi word
    match = (
        (cand_hi == key_hi[..., None])
        & (cand_lo == key_lo[..., None])
        & (cand_hi != jnp.uint32(0xFFFFFFFF))
    )
    found = jnp.any(match, axis=-1)
    slot = jnp.argmax(match, axis=-1)
    off = jnp.take_along_axis(cand_off, slot[..., None], axis=-1)[..., 0]
    length = jnp.take_along_axis(cand_len, slot[..., None], axis=-1)[..., 0]
    length = jnp.where(found, length, jnp.uint32(0))
    return found, off, length
