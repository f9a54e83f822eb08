"""Phylo-k-mer database: flat-array container + native serialization.

Re-provides the reference's ``i2l::phylo_kmer_db`` + ``i2l::load`` contract
(reference: epik/src/epik/main.cpp:277 ``i2l::load(db_file, mu, omega,
max_entries)``; epik/src/epik/place.cpp:278-316 ``db.search(key)``).

Device-first re-design
----------------------
The reference stores a Boost-serialized hash map of posting lists and queries
it key-by-key from OpenMP threads.  Here the database is a set of **flat,
device-shippable arrays**:

* ``keys``     uint64[n]  -- k-mer codes, sorted ascending after load
* ``row_off``  int64[n+1] -- CSR offsets into the posting arrays
* ``branches`` uint32[P]  -- post-order branch ids (jplace edge_num)
* ``scores``   float32[P] -- log10 P(kmer | branch)

so the whole DB is a gather target in device memory; lookup happens on-device
through a hash table built from ``keys`` (see epik_tpu/ops/hashtable.py).

File format (``.eptk``, "EPIK-TPU phylo-k-mer database v1")
-----------------------------------------------------------
Little-endian::

    magic   8s   = b"EPIKTPU1"
    hdrlen  u64
    header  JSON (hdrlen bytes)
    arrays  raw little-endian buffers at 64-byte-aligned offsets given
            in header["arrays"]

K-mers are stored in **filter order** (decreasing informativeness) so that
partial loading (``--mu`` / ``--max-ram``) is a prefix read, mirroring the
reference's load-time filtering (reference: main.cpp:252-265 converts
--max-ram bytes to an entry budget via sizeof(i2l::pkdb_value);
CHANGELOG.txt:6 "partial loading of databases with phylo-k-mer filtering").
[inference: i2l stores filter-ordered k-mers so load can stop early; the i2l
source is unavailable.]

An "entry" is one (branch, score) posting -- the reference counts entries,
not k-mers (``sizeof(i2l::pkdb_value)`` = one pair, main.cpp:257;
"Loaded N of M phylo-k-mers", main.cpp:290-292).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..core.alphabet import get_alphabet
from ..core.scoring import log10_score_threshold

__all__ = ["PhyloKmerDB", "load", "save", "PKDB_VALUE_SIZE", "EARLIEST_INDEX"]

_MAGIC = b"EPIKTPU1"
_ALIGN = 64

#: Bytes per stored posting, mirroring ``sizeof(i2l::pkdb_value)`` used for the
#: --max-ram -> entry-count conversion (reference: main.cpp:257).
#: [inference: one (uint32 branch, float32 score) pair = 8 bytes]
PKDB_VALUE_SIZE = 8

#: Minimum supported serialization protocol version
#: (reference: main.cpp:278-283 gates on i2l::protocol::EARLIEST_INDEX;
#: databases built by xpas older than v0.3.2 are rejected).
EARLIEST_INDEX = 4


@dataclasses.dataclass
class PhyloKmerDB:
    """In-memory phylo-k-mer database (CSR over sorted keys)."""

    sequence_type: str  # "nucl" | "amino"
    kmer_size: int
    omega: float  # effective omega after load (quirk Q10)
    tree_newick: str
    keys: np.ndarray  # uint64[n], sorted ascending
    row_off: np.ndarray  # int64[n+1]
    branches: np.ndarray  # uint32[P]
    scores: np.ndarray  # float32[P]
    version: int = EARLIEST_INDEX
    positions_loaded: bool = False
    num_entries_total: int = 0  # entries in the file before filtering
    num_entries_loaded: int = 0  # entries after mu/omega/max-ram filtering

    # -- i2l::phylo_kmer_db surface --------------------------------------------

    def search(self, key: int):
        """Posting list for ``key`` or None (reference: place.cpp:301,311).

        Host-side scalar path -- used by the NumPy differential oracle and
        tests; the device pipeline uses the hash table instead.
        """
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        if i < self.keys.shape[0] and self.keys[i] == np.uint64(key):
            lo, hi = int(self.row_off[i]), int(self.row_off[i + 1])
            return self.branches[lo:hi], self.scores[lo:hi]
        return None

    def tree(self) -> str:
        """Newick string embedded in the DB (reference: main.cpp:294)."""
        return self.tree_newick

    def get_num_entries_loaded(self) -> int:
        return self.num_entries_loaded

    def get_num_entries_total(self) -> int:
        return self.num_entries_total

    @property
    def num_kmers(self) -> int:
        return int(self.keys.shape[0])

    @property
    def num_entries(self) -> int:
        return int(self.branches.shape[0])

    @property
    def sigma(self) -> int:
        return get_alphabet(self.sequence_type).sigma

    def max_posting_len(self) -> int:
        if self.num_kmers == 0:
            return 0
        return int(np.max(np.diff(self.row_off)))

    def validate(self) -> None:
        n, P = self.num_kmers, self.num_entries
        assert self.row_off.shape == (n + 1,)
        assert int(self.row_off[0]) == 0 and int(self.row_off[-1]) == P
        assert self.scores.shape == (P,)
        if n > 1:
            assert bool(np.all(self.keys[:-1] < self.keys[1:])), "keys must be sorted unique"


def _align(off: int) -> int:
    return (off + _ALIGN - 1) // _ALIGN * _ALIGN


def save(db: PhyloKmerDB, path: str | os.PathLike, filter_order: np.ndarray | None = None) -> None:
    """Write a ``.eptk`` file.

    ``filter_order``: permutation of k-mer rows, most informative first; this
    is the storage order used for prefix-based partial loading.  Defaults to
    descending best posting score per k-mer. [inference: IPK's actual filter
    ranks k-mers by mutual information; any fixed order gives the same
    load-time semantics]
    """
    db.validate()
    n = db.num_kmers
    lens = np.diff(db.row_off).astype(np.uint32)
    if filter_order is None:
        if n:
            best = np.full(n, -np.inf, dtype=np.float64)
            seg = np.repeat(np.arange(n), lens.astype(np.int64))
            if db.scores.size:
                np.maximum.at(best, seg, db.scores.astype(np.float64))
            filter_order = np.argsort(-best, kind="stable")
        else:
            filter_order = np.empty(0, dtype=np.int64)
    filter_order = np.asarray(filter_order)

    keys_f = db.keys[filter_order]
    lens_f = lens[filter_order]
    # concatenate posting lists in filter order
    starts = db.row_off[:-1][filter_order]
    idx = _expand_ragged(starts.astype(np.int64), lens_f.astype(np.int64))
    branches_f = db.branches[idx]
    scores_f = db.scores[idx]

    tree_bytes = db.tree_newick.encode("utf-8")
    arrays = {
        "keys": keys_f.astype("<u8"),
        "row_len": lens_f.astype("<u4"),
        "branches": branches_f.astype("<u4"),
        "scores": scores_f.astype("<f4"),
        "tree": np.frombuffer(tree_bytes, dtype=np.uint8),
    }
    meta = {
        "format": "eptk-1",
        "sequence_type": db.sequence_type,
        "kmer_size": db.kmer_size,
        "omega": db.omega,
        "positions": db.positions_loaded,
        "version": db.version,
        "num_kmers": n,
        "num_entries": db.num_entries,
        "arrays": [],
    }
    # two-pass: compute offsets after knowing header length; iterate since the
    # header length depends on the offsets (bounded, converges immediately
    # because we pad the header to a fixed-point).
    for _ in range(4):
        hdr = json.dumps(meta).encode("utf-8")
        off = _align(len(_MAGIC) + 8 + len(hdr))
        entries = []
        for name, arr in arrays.items():
            entries.append({"name": name, "dtype": str(arr.dtype), "len": int(arr.shape[0]), "offset": off})
            off = _align(off + arr.nbytes)
        if entries == meta["arrays"]:
            break
        meta["arrays"] = entries
    hdr = json.dumps(meta).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(np.uint64(len(hdr)).tobytes())
        f.write(hdr)
        for spec, arr in zip(meta["arrays"], arrays.values()):
            f.seek(spec["offset"])
            f.write(arr.tobytes())


def _expand_ragged(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """indices [s0..s0+l0) ++ [s1..s1+l1) ++ ... (host-side helper)."""
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    out_starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    delta = np.zeros(total, dtype=np.int64)
    delta[out_starts] = starts - np.concatenate([[0], starts[:-1] + lens[:-1]])
    return np.cumsum(delta + 1) - 1


def build_filtered(
    *,
    sequence_type: str,
    kmer_size: int,
    stored_omega: float,
    tree_newick: str,
    version: int,
    keys_f: np.ndarray,
    lens_f: np.ndarray,
    branches_f: np.ndarray,
    scores_f: np.ndarray,
    mu: float = 1.0,
    user_omega: float | None = None,
    max_entries: int | None = None,
    positions: bool = False,
) -> PhyloKmerDB:
    """Load-time filtering + CSR build from file-order flat arrays.

    The shared back half of ``i2l::load`` (reference: main.cpp:277) used by
    both the ``.eptk`` loader and the reconstructed ``.ipk`` reader: inputs
    are k-mer rows **in storage order** (filter order: most informative
    first [inference]) as ``keys_f``/``lens_f`` plus their concatenated
    postings.

    * keep the storage-order prefix of k-mers whose cumulative posting
      count stays within ``ceil(mu * total)`` and ``max_entries``;
    * re-threshold postings when the user omega tightens the stored one:
      drop scores below log10((omega_eff/sigma)**k), with
      omega_eff = max(stored, user) (quirk Q10) [inference];
    * sort by key and build the CSR arrays;
    * report loaded/total entry counts (reference: main.cpp:290-292).
    """
    if not (0.0 <= mu <= 1.0):
        raise ValueError("Mu has to a value in [0, 1]")  # reference: main.cpp:196-202
    total_entries = int(lens_f.sum())

    # --- prefix filtering (mu / max-ram) --------------------------------------
    budget = total_entries
    if mu < 1.0:
        budget = min(budget, int(np.ceil(mu * total_entries)))
    if max_entries is not None:
        budget = min(budget, int(max_entries))
    cum = np.cumsum(lens_f)
    keep_n = int(np.searchsorted(cum, budget, side="right"))
    # keep_n k-mers fit entirely within the budget
    keys_f = keys_f[:keep_n]
    lens_f = lens_f[:keep_n]
    kept_entries = int(cum[keep_n - 1]) if keep_n else 0
    branches_f = branches_f[:kept_entries]
    scores_f = scores_f[:kept_entries]

    # --- omega re-threshold (quirk Q10) ---------------------------------------
    eff_omega = stored_omega if user_omega is None else max(stored_omega, float(user_omega))
    sigma = get_alphabet(sequence_type).sigma
    if eff_omega > stored_omega:
        log_eps = np.float32(log10_score_threshold(eff_omega, kmer_size, sigma))
        keep_mask = scores_f >= log_eps
        seg = np.repeat(np.arange(keep_n), lens_f)
        lens_f = np.bincount(seg[keep_mask], minlength=keep_n).astype(np.int64)
        branches_f = branches_f[keep_mask]
        scores_f = scores_f[keep_mask]
        nz = lens_f > 0
        keys_f, lens_f = keys_f[nz], lens_f[nz]
        # re-slice postings to drop empty rows: they are already contiguous
        # (mask filtering preserved order), nothing else to do.

    # --- sort by key, build CSR ----------------------------------------------
    order = np.argsort(keys_f, kind="stable")
    keys = keys_f[order]
    lens = lens_f[order]
    starts_f = np.concatenate([[0], np.cumsum(lens_f)[:-1]]).astype(np.int64)
    idx = _expand_ragged(starts_f[order], lens)
    branches = branches_f[idx]
    scores = scores_f[idx]
    row_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)

    db = PhyloKmerDB(
        sequence_type=sequence_type,
        kmer_size=kmer_size,
        omega=eff_omega,
        tree_newick=tree_newick,
        keys=keys,
        row_off=row_off,
        branches=branches,
        scores=scores,
        version=version,
        positions_loaded=positions,
        num_entries_total=total_entries,
        num_entries_loaded=int(branches.shape[0]),
    )
    db.validate()
    return db


def load(
    path: str | os.PathLike,
    mu: float = 1.0,
    user_omega: float | None = None,
    max_entries: int | None = None,
) -> PhyloKmerDB:
    """Load a database with load-time filtering.

    Mirrors ``i2l::load(db_file, mu, omega, max_entries)``
    (reference: main.cpp:277).  Dispatches on content: native ``.eptk``
    files load directly; Boost-archive ``.ipk`` files (plain, gzip, or
    zlib-compressed) route through the reconstructed reader
    (io/ipk_boost.py) with the same filtering semantics.
    """
    if not (0.0 <= mu <= 1.0):
        raise ValueError("Mu has to a value in [0, 1]")  # reference: main.cpp:196-202
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            if _looks_like_ipk(magic):
                from .ipk_boost import load_ipk

                return load_ipk(
                    path, mu=mu, user_omega=user_omega, max_entries=max_entries
                )
            raise ValueError(f"{path}: not an EPIK-TPU database (bad magic {magic!r})")
        (hdrlen,) = np.frombuffer(f.read(8), dtype="<u8")
        meta = json.loads(f.read(int(hdrlen)).decode("utf-8"))
    if meta.get("version", 0) < EARLIEST_INDEX:
        raise ValueError(
            f"The serialization protocol version is too old (v{meta.get('version')})."
        )
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    arrs = {}
    for spec in meta["arrays"]:
        dt = np.dtype(spec["dtype"])
        start = spec["offset"]
        nbytes = spec["len"] * dt.itemsize
        arrs[spec["name"]] = np.frombuffer(mm[start : start + nbytes].tobytes(), dtype=dt)

    return build_filtered(
        sequence_type=meta["sequence_type"],
        kmer_size=int(meta["kmer_size"]),
        stored_omega=float(meta["omega"]),
        tree_newick=bytes(arrs["tree"]).decode("utf-8"),
        version=int(meta["version"]),
        keys_f=arrs["keys"].astype(np.uint64),
        lens_f=arrs["row_len"].astype(np.int64),
        branches_f=arrs["branches"].astype(np.uint32),
        scores_f=arrs["scores"].astype(np.float32),
        mu=mu,
        user_omega=user_omega,
        max_entries=max_entries,
        positions=bool(meta.get("positions", False)),
    )


def _looks_like_ipk(magic: bytes) -> bool:
    """First-bytes sniff for a Boost archive (plain or compressed)."""
    if magic[:2] == b"\x1f\x8b":  # gzip container
        return True
    if len(magic) >= 2 and magic[0] == 0x78 and ((magic[0] << 8) | magic[1]) % 31 == 0:
        return True  # zlib stream
    # plain archive: size_t(22) signature-length prefix, u64 (64-bit build)
    # or u32 immediately followed by the signature text (32-bit build)
    import struct

    if magic == struct.pack("<Q", 22):
        return True
    return magic[:4] == struct.pack("<I", 22) and magic[4:8] == b"seri"
