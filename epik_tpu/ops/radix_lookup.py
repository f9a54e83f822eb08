"""Top-bits radix index: exact key->row lookup via element gathers.

The amino alphabet (sigma=20) has no direct-address table (20**k does
not fit device memory), so instead of per-key bucket ROW gathers from a
cuckoo table this index keeps every device access an ELEMENT gather from
small int32 tables:

* keys are stored sorted (the DB contract, io/db.py), so the row index IS
  the position in the sorted array;
* the top ``key_bits - shift`` bits form an exact radix bucket: ``off``
  (one int32 per bucket + 1) delimits each bucket's slice of the sorted
  key array;
* within a bucket all keys share their top bits, so a single int32
  compare of the low ``shift`` bits identifies the key -- no hashing, no
  fingerprint collisions, exact by construction.

Lookup cost: 2 + max_bucket element-gather passes (off[b], off[b+1], and
one low-bits compare per probe).  ``max_bucket`` is data-dependent
(uniformly-coded DBs: ~6-8 at load 0.5); callers gate on it and fall back
to the host path when a skewed key distribution makes it large.

Reference analog: i2l's phylo_kmer_db hash map queried per key
(epik/src/epik/place.cpp:301,311); this is its batch-oriented device
replacement for alphabets without a direct table.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

__all__ = ["RadixIndex", "LP", "build_radix", "radix_lookup",
           "radix_lookup_packed", "radix_lookup_lp",
           "radix_lookup_dispatch"]


#: ``off_bits`` < 0 selects :func:`radix_lookup_lp` in the shared dispatch
#: (the two device arrays are then v1/lp, not offc/low2); the magnitude is
#: the start-field width ``nb``.
def LP(nb: int) -> int:
    return -nb


@dataclasses.dataclass
class RadixIndex:
    off: np.ndarray  # int32 (2**table_bits + 1,) bucket offsets into keys
    low: np.ndarray  # int32 (n,) low `shift` bits of each sorted key
    shift: int  # low-bits width (<= 31)
    max_bucket: int  # probe count the device loop must unroll
    #: PACKED lookup tables (present when the packable gate holds:
    #: shift <= 15, max_bucket <= 3, n fits the offset field).  offc[b] =
    #: start | (count << off_bits) -- ONE gather replaces the off[b]/off[b+1]
    #: pair; low2[w] = low[2w] | (low[2w+1] << shift) -- any <= 3 consecutive
    #: probe positions live in 2 words.  Lookup passes: 5 -> 3.
    offc: np.ndarray | None = None
    low2: np.ndarray | None = None
    off_bits: int = 0
    #: LOW-PAIR-OVERLAP tables: TWO gather passes total, the first table
    #: capped at 64 MB (pass COUNT and first-table size are what the
    #: lookup's cost follows).  v1[bucket] (<= 2**24
    #: buckets, 64 MB) = start | count << nb | hi(low[start+2]) << (nb+2);
    #: lp[i] (n+3 entries, cached) packs low[i], low[i+1] and the low
    #: 31-2s bits of low[i+2] -- OVERLAPPING triples, so no alignment
    #: padding is needed and lp[start] covers every candidate of a
    #: <= 3-key bucket.  Gate: shift s <= 11, max bucket <= 3,
    #: nb + 2 + max(0, 3s-31) <= 31.
    v1: np.ndarray | None = None
    lp: np.ndarray | None = None
    lp_shift: int = 0
    lp_nb: int = 0

    @property
    def packed(self) -> bool:
        return self.offc is not None

    @property
    def lowpair(self) -> bool:
        return self.v1 is not None

    def device_arrays(self):
        if self.lowpair:
            return jnp.asarray(self.v1), jnp.asarray(self.lp)
        if self.packed:
            return jnp.asarray(self.offc), jnp.asarray(self.low2)
        return jnp.asarray(self.off), jnp.asarray(self.low)

    def dispatch_args(self):
        """(shift, n_probe, off_bits) statics for :func:`radix_lookup_dispatch`,
        matching whatever representation :meth:`device_arrays` returned."""
        if self.lowpair:
            return self.lp_shift, self.max_bucket, LP(self.lp_nb)
        if self.packed:
            return self.shift, self.max_bucket, self.off_bits
        return self.shift, self.max_bucket, 0


def build_radix(keys: np.ndarray, key_bits: int, max_table_bits: int = 24,
                allow_split: bool = True) -> RadixIndex:
    """Build the index from SORTED unique uint64 keys (< 2**key_bits).

    ``table_bits`` targets ~32 buckets per key (load 1/32) capped at
    ``max_table_bits`` (64 MB of offsets): every probe is a full
    element-gather pass over all window keys, so a sparser table buying
    max_bucket 3-4 instead of 7 is worth 64 MB of device memory.
    ``shift`` = key_bits -
    table_bits must stay <= 31 so the low bits fit an int32 compare.
    """
    n = int(keys.shape[0])
    table_bits = min(max_table_bits, max(1, (32 * max(n, 1) - 1).bit_length()))
    shift = max(0, key_bits - table_bits)
    if shift > 31:
        raise ValueError(f"key_bits={key_bits} too wide: low bits {shift} > 31")
    table_bits = key_bits - shift
    buckets = (keys >> np.uint64(shift)).astype(np.int64)
    counts = np.bincount(buckets, minlength=(1 << table_bits))
    off = np.zeros((1 << table_bits) + 1, np.int32)
    np.cumsum(counts, out=off[1:])
    low = (keys & np.uint64((1 << shift) - 1)).astype(np.int32)
    max_bucket = int(counts.max()) if n else 0
    idx = RadixIndex(off=off, low=low, shift=shift, max_bucket=max_bucket)
    # low-pair-overlap variant (see RadixIndex.v1): 2 gather passes, first
    # table capped at 2**24 buckets (64 MB), second the tiny
    # overlapping-triple array.  The
    # bucket table scales with the key count (~32 buckets/key like the
    # generic form) down to the key_bits - 11 floor the lp word packing
    # needs -- a 5k-key DB gets a 128 KB v1, not a fixed 64 MB one.
    s_tb = max(key_bits - 11,
               min(24, key_bits, (32 * max(n, 1) - 1).bit_length()))
    s = key_bits - s_tb
    nb = max(1, int(n).bit_length())
    b3 = max(0, 3 * s - 31)  # third-low bits that spill into v1
    if (allow_split and n and s_tb <= 24 and 0 <= s <= 11
            and nb + 2 + b3 <= 31):
        s_buckets = (keys >> np.uint64(s)).astype(np.int64)
        s_counts = np.bincount(s_buckets, minlength=(1 << s_tb))
        if int(s_counts.max()) <= 3:
            s_off = np.zeros(1 << s_tb, np.int64)
            np.cumsum(s_counts[:-1], out=s_off[1:])
            s_low = (keys & np.uint64((1 << s) - 1)).astype(np.int64)
            lo_pad = np.zeros(n + 3, np.int64)
            lo_pad[:n] = s_low
            lp_lo3 = 31 - 2 * s if s else 0  # low3 bits kept in lp
            lp_w = lo_pad[:-2].copy()
            if s:
                lp_w |= lo_pad[1:-1] << s
                lp_w |= (lo_pad[2:] & ((1 << lp_lo3) - 1)) << (2 * s)
            v1 = s_off | (s_counts.astype(np.int64) << nb)
            if b3:
                # top bits of low[start+2], valid only for 3-key buckets
                hi3 = (lo_pad[2:][s_off] >> lp_lo3) & ((1 << b3) - 1)
                v1 |= hi3 << (nb + 2)
            idx.lp_shift = s
            idx.lp_nb = nb
            idx.v1 = v1.astype(np.int32)
            idx.lp = lp_w.astype(np.int32)
            return idx
    # packed variant (see RadixIndex.offc): 3 gather passes instead of 5
    cb = max(max_bucket, 1).bit_length()
    off_bits = 31 - cb
    if n and max_bucket <= 3 and 0 < shift <= 15 and n < (1 << off_bits):
        idx.off_bits = off_bits
        idx.offc = (off[:-1] | (counts.astype(np.int64) << off_bits)).astype(
            np.int32
        )
        nw = (n + 2) // 2  # +1 pad word so w0+1 is always in bounds
        lp = np.zeros(2 * nw, np.int64)
        lp[:n] = low
        idx.low2 = (lp[0::2] | (lp[1::2] << shift)).astype(np.int32)
    return idx


def _split_bucket_lo(a, b, shift: int):
    i32 = jnp.int32
    u32 = jnp.uint32
    a = a.astype(u32)
    b = b.astype(u32)
    if shift >= 16:
        s16 = shift - 16
        bucket = (a >> u32(s16)).astype(i32)
        lo = (((a & u32((1 << s16) - 1)) << u32(16)) | b).astype(i32)
    else:
        bucket = ((a << u32(16 - shift)) | (b >> u32(shift))).astype(i32)
        lo = (b & u32((1 << shift) - 1)).astype(i32)
    return bucket, lo


def radix_lookup_packed(offc, low2, a, b, *, shift: int, off_bits: int,
                        n_keys: int):
    """Packed device lookup: THREE element-gather passes total.

    ``offc[bucket]`` yields start+count in one gather; two ``low2`` words
    cover every candidate position (max_bucket <= 3, the build gate).
    Misses return ``n_keys``.  All int32 (no x64)."""
    i32 = jnp.int32
    bucket, lo = _split_bucket_lo(a, b, shift)
    oc = jnp.take(offc, bucket, axis=0)
    st = oc & i32((1 << off_bits) - 1)
    cnt = oc >> i32(off_bits)  # oc is non-negative (off_bits <= 29)
    en = st + cnt
    w0 = st >> 1
    nw = low2.shape[0]
    l01 = jnp.take(low2, w0, axis=0)
    l23 = jnp.take(low2, jnp.minimum(w0 + 1, nw - 1), axis=0)
    mask = i32((1 << shift) - 1)
    row = jnp.full(a.shape, n_keys, i32)
    base = w0 * 2
    for j, cand in enumerate((l01 & mask, l01 >> shift,
                              l23 & mask, l23 >> shift)):
        pos = base + j
        hit = (pos >= st) & (pos < en) & (cand == lo)
        row = jnp.where(hit, pos, row)
    return row


def radix_lookup_lp(v1, lp, a, b, *, shift: int, nb: int, n_keys: int):
    """Low-pair-overlap device lookup: TWO element-gather passes.

    Pass 1: ``v1[bucket]`` (<= 64 MB) -> start, count, and (when shift is
    11) the two spill bits of the third candidate's low.  Pass 2:
    ``lp[start]`` (tiny, cache-resident) -> the up-to-three candidate
    lows as an overlapping triple.  Misses return ``n_keys``.  Exact:
    same-bucket keys differ in their low bits, the count field gates
    unused slots, and the third low is reassembled in full."""
    i32 = jnp.int32
    bucket, lo = _split_bucket_lo(a, b, shift)
    o1 = jnp.take(v1, bucket, axis=0)
    st = o1 & i32((1 << nb) - 1)
    cnt = (o1 >> i32(nb)) & i32(3)
    w = jnp.take(lp, st, axis=0)
    mask = i32((1 << shift) - 1) if shift else i32(0)
    b3 = max(0, 3 * shift - 31)
    lo3_bits = 31 - 2 * shift if shift else 0
    if shift:
        c0 = w & mask
        c1 = (w >> i32(shift)) & mask
        c2 = (w >> i32(2 * shift)) & i32((1 << lo3_bits) - 1)
        if b3:
            hi3 = (o1 >> i32(nb + 2)) & i32((1 << b3) - 1)
            c2 = c2 | (hi3 << i32(lo3_bits))
    else:
        c0 = c1 = c2 = jnp.zeros_like(w)
    row = jnp.full(a.shape, n_keys, i32)
    for j, cand in enumerate((c0, c1, c2)):
        hit = (i32(j) < cnt) & (cand == lo)
        row = jnp.where(hit, st + i32(j), row)
    return row


def radix_lookup_dispatch(arr1, arr2, a, b, *, shift: int, n_probe: int,
                          off_bits: int, n_keys: int):
    """Representation-dispatching lookup: ``off_bits`` < 0 selects the
    low-pair-overlap form (arr1/arr2 = v1/lp, nb = -off_bits), > 0 the
    packed form (offc/low2), 0 the generic probe loop (off/low).  Statics
    come from :meth:`RadixIndex.dispatch_args`."""
    if off_bits < 0:
        return radix_lookup_lp(arr1, arr2, a, b, shift=shift,
                               nb=-off_bits, n_keys=n_keys)
    if off_bits > 0:
        return radix_lookup_packed(arr1, arr2, a, b, shift=shift,
                                   off_bits=off_bits, n_keys=n_keys)
    return radix_lookup(arr1, arr2, a, b, shift=shift, n_probe=n_probe,
                        n_keys=n_keys)


def radix_lookup(off, low, a, b, *, shift: int, n_probe: int, n_keys: int):
    """Device lookup: key row indices for keys given as uint32 halves
    ``key = a * 2**16 + b``.  Misses return ``n_keys`` (the all-zero plane
    row).  All arithmetic is uint32/int32 (no x64)."""
    i32 = jnp.int32
    bucket, lo = _split_bucket_lo(a, b, shift)
    st = jnp.take(off, bucket, axis=0)
    en = jnp.take(off, bucket + 1, axis=0)
    row = jnp.full(a.shape, n_keys, i32)
    found = jnp.zeros(a.shape, bool)
    nmax = max(low.shape[0] - 1, 0)
    for p in range(n_probe):
        j = st + p
        jc = jnp.minimum(j, nmax)
        m = (j < en) & (jnp.take(low, jc, axis=0) == lo) & ~found
        row = jnp.where(m, jc, row)
        found = found | m
    return row
