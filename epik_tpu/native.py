"""ctypes bindings for the native host library (native/epik_host.cpp).

Loads ``libepik_host.so``, compiling it into ``build/`` with the host C++
compiler the first time.  Every native entry point has a pure-Python
equivalent -- the bindings are an acceleration, not a requirement:

* :func:`native_tokenize_batch`  <->  core.kmers.tokenize_batch
* :class:`NativeFastaReader`     <->  io.fasta.batch_fasta
* :class:`NativeScalarPlacer`    <->  engine.reference.ReferencePlacer
  (top-k scores only; used as the benchmark baseline and a third
  implementation for differential testing)
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

from .core.alphabet import Alphabet
from .core.kmers import BatchTokens

__all__ = [
    "load_native",
    "native_available",
    "native_tokenize_batch",
    "native_format_jplace",
    "NativeFastaReader",
    "NativeScalarPlacer",
    "NativePlacer",
]

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO, "native", "epik_host.cpp")
_BUILD_DIR = os.path.join(_REPO, "build")

_lock = threading.Lock()
_lib = None
_tried = False
_build_error = ""


def _lib_path() -> str:
    """Where the library built from the current source lives: the name
    carries a hash of ``epik_host.cpp``, so an edited source builds anew
    and a stale library is never loaded."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libepik_host-{digest}.so")


def _build(out: str) -> bool:
    """Compile ``out`` with the host C++ compiler: ``$CXX``, then g++, then
    c++, with OpenMP (the native placer's ``-j N`` loop) where the
    compiler supports it, else without (that loop then runs on one
    thread).  A file lock serializes processes that build at once (test
    workers); the library appears atomically, fully written or not at
    all.  A failure's compiler output is kept for
    :func:`native_build_error`."""
    global _build_error
    os.makedirs(_BUILD_DIR, exist_ok=True)
    compilers = list(dict.fromkeys(
        c for c in (os.environ.get("CXX"), "g++", "c++") if c))
    with open(os.path.join(_BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return True
        tmp = f"{out}.{os.getpid()}.tmp"
        errors = []
        for openmp in (["-fopenmp"], []):
            for cxx in compilers:
                cmd = [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", *openmp,
                       _SRC, "-o", tmp]
                try:
                    subprocess.run(cmd, check=True, capture_output=True,
                                   text=True, timeout=600)
                except subprocess.CalledProcessError as e:
                    errors.append(f"{' '.join(cmd)}: {e.stderr.strip()[-1000:]}")
                    continue
                except (OSError, subprocess.SubprocessError) as e:
                    errors.append(f"{' '.join(cmd)}: {e}")
                    continue
                os.replace(tmp, out)
                return True
        _build_error = "\n".join(errors)
        return False


def load_native():
    """The loaded CDLL, built from ``native/epik_host.cpp`` on first use,
    or None when no compiler can build it."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        lib = ctypes.CDLL(path)
        _declare(lib)
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None


def native_build_error() -> str:
    """Why the last build failed ("" when it did not fail)."""
    return _build_error


c_i64p = ctypes.POINTER(ctypes.c_int64)
c_charp = ctypes.POINTER(ctypes.c_char)


def _declare(lib) -> None:
    lib.eh_fasta_open.restype = ctypes.c_void_p
    lib.eh_fasta_open.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.eh_fasta_close.argtypes = [ctypes.c_void_p]
    lib.eh_fasta_bytes_read.restype = ctypes.c_long
    lib.eh_fasta_bytes_read.argtypes = [ctypes.c_void_p]
    lib.eh_fasta_next.restype = ctypes.c_long
    lib.eh_fasta_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(c_charp), ctypes.POINTER(c_i64p),
        ctypes.POINTER(c_charp), ctypes.POINTER(c_i64p),
    ]
    lib.eh_tokenize.restype = ctypes.c_void_p
    lib.eh_tokenize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.eh_tokens_sizes.argtypes = [ctypes.c_void_p, c_i64p, c_i64p]
    lib.eh_tokens_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
    lib.eh_tokens_free.argtypes = [ctypes.c_void_p]
    lib.eh_scalar_db_new.restype = ctypes.c_void_p
    lib.eh_scalar_db_new.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
    ]
    lib.eh_scalar_db_free.argtypes = [ctypes.c_void_p]
    lib.eh_place_scalar.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.eh_place_scalar_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.eh_format_jplace.restype = ctypes.c_int64
    lib.eh_format_jplace.argtypes = [
        ctypes.c_long, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.eh_ipk_scan.restype = ctypes.c_int64
    lib.eh_ipk_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.eh_ipk_extract.restype = ctypes.c_int64
    lib.eh_ipk_extract.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.eh_pack_reads.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
    ]


def _np_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _alphabet_tables(alphabet: Alphabet):
    n_sym = len(alphabet.ambig_expansions)
    max_fan = alphabet.max_expansion
    exp_table = np.zeros((max(n_sym, 1), max_fan), dtype=np.uint8)
    exp_len = np.zeros(max(n_sym, 1), dtype=np.uint8)
    for i, e in enumerate(alphabet.ambig_expansions):
        exp_table[i, : len(e)] = e
        exp_len[i] = len(e)
    return np.ascontiguousarray(alphabet.char_code, dtype=np.uint8), exp_table, exp_len


def native_tokenize_batch(seqs: list[bytes], k: int, alphabet: Alphabet) -> BatchTokens:
    """C++ tokenizer with the same output contract as tokenize_batch."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native library not available")
    n = len(seqs)
    seq_lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    buf = np.frombuffer(b"".join(seqs), dtype=np.uint8) if n else np.empty(0, np.uint8)
    offsets = np.concatenate([[0], np.cumsum(seq_lengths)]).astype(np.int64)
    char_code, exp_table, exp_len = _alphabet_tables(alphabet)
    h = lib.eh_tokenize(
        _np_ptr(np.ascontiguousarray(buf)), _np_ptr(offsets), n, k,
        alphabet.sigma, _np_ptr(char_code), _np_ptr(exp_table), _np_ptr(exp_len),
        exp_table.shape[1],
    )
    try:
        n_exact = ctypes.c_int64()
        n_amb = ctypes.c_int64()
        lib.eh_tokens_sizes(h, ctypes.byref(n_exact), ctypes.byref(n_amb))
        ek = np.empty(n_exact.value, np.uint64)
        er = np.empty(n_exact.value, np.int32)
        ak = np.empty(n_amb.value, np.uint64)
        ar = np.empty(n_amb.value, np.int32)
        ao = np.empty(n_amb.value, np.int32)
        lib.eh_tokens_fill(h, _np_ptr(ek), _np_ptr(er), _np_ptr(ak), _np_ptr(ar), _np_ptr(ao))
    finally:
        lib.eh_tokens_free(h)
    return BatchTokens(
        num_reads=n,
        num_windows=np.maximum(seq_lengths - k + 1, 0),
        seq_lengths=seq_lengths,
        exact_keys=ek, exact_read=er,
        amb_keys=ak, amb_read=ar, amb_order=ao,
    )


def native_pack_reads(seqs: list[bytes], lens_arr: np.ndarray,
                      alphabet: Alphabet, Lmax: int, R_pad: int):
    """One-pass packed read-buffer staging (engine/placer.py::pack_reads
    + the char_code gather + ambiguity scan, fused in C++; the C call
    releases the GIL).  Returns ``(buf (R_pad, Lmax//4 + Lmax//8 + 2)
    uint8, amb_mask (n,) bool)``; Lmax must be a multiple of 8."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native library not available")
    n = len(seqs)
    flat = np.frombuffer(b"".join(seqs), dtype=np.uint8) if n else np.empty(0, np.uint8)
    offsets = np.empty(n + 1, np.int64)
    offsets[0] = 0
    np.cumsum(lens_arr, out=offsets[1:])
    char_code = np.ascontiguousarray(alphabet.char_code, dtype=np.uint8)
    stride = Lmax // 4 + Lmax // 8 + 2
    out = np.empty((R_pad, stride), np.uint8)
    amb = np.empty(max(n, 1), np.uint8)
    lib.eh_pack_reads(
        _np_ptr(np.ascontiguousarray(flat)), _np_ptr(offsets), n,
        _np_ptr(char_code), Lmax, R_pad, _np_ptr(out), _np_ptr(amb),
    )
    return out, amb[:n].astype(bool)


class NativeFastaReader:
    """C++ FASTA batch reader with the batch_fasta surface."""

    def __init__(self, path: str, batch_size: int = 2000):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native library not available")
        self._lib = lib
        self._h = lib.eh_fasta_open(os.fspath(path).encode(), batch_size)
        if not self._h:
            raise FileNotFoundError(path)

    def bytes_read(self) -> int:
        return int(self._lib.eh_fasta_bytes_read(self._h))

    def next_batch(self) -> list[tuple[str, bytes]]:
        sb = c_charp()
        so = c_i64p()
        hb = c_charp()
        ho = c_i64p()
        n = self._lib.eh_fasta_next(
            self._h, ctypes.byref(sb), ctypes.byref(so), ctypes.byref(hb), ctypes.byref(ho)
        )
        out = []
        for i in range(n):
            s = ctypes.string_at(ctypes.addressof(sb.contents) + so[i], so[i + 1] - so[i])
            hdr = ctypes.string_at(ctypes.addressof(hb.contents) + ho[i], ho[i + 1] - ho[i])
            out.append((hdr.decode("utf-8", "replace"), s))
        return out

    def close(self):
        if self._h:
            self._lib.eh_fasta_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeScalarPlacer:
    """C++ faithful scalar scoring (top-K edges/scores/counts per read).

    The benchmark baseline: the reference's algorithm at native speed,
    mirroring epik/src/epik/place.cpp:320-440.  ``threads`` mirrors the
    reference's ``-j/--threads`` OpenMP placement loop
    (epik/src/epik/place.cpp:218-229); the default 1 is the reference's
    default (main.cpp:213).
    """

    def __init__(self, db, keep_at_most: int = 7, threads: int = 1):
        from .core.scoring import score_threshold
        from .core.alphabet import get_alphabet

        lib = load_native()
        if lib is None:
            raise RuntimeError("native library not available")
        self._lib = lib
        self.db = db
        self.K = keep_at_most
        self.threads = max(1, int(threads))
        self.alphabet = get_alphabet(db.sequence_type)
        # keep arrays referenced: the C side stores raw pointers
        self._keys = np.ascontiguousarray(db.keys, dtype=np.uint64)
        self._row_off = np.ascontiguousarray(db.row_off, dtype=np.int64)
        self._branches = np.ascontiguousarray(db.branches, dtype=np.uint32)
        self._scores = np.ascontiguousarray(db.scores, dtype=np.float32)
        from .core.tree import parse_newick

        self.B = parse_newick(db.tree()).get_node_count()
        thr = np.float32(score_threshold(db.omega, db.kmer_size, self.alphabet.sigma))
        self._h = lib.eh_scalar_db_new(
            _np_ptr(self._keys), self._keys.shape[0], _np_ptr(self._row_off),
            _np_ptr(self._branches), _np_ptr(self._scores), self.B,
            db.kmer_size, ctypes.c_float(float(thr)),
        )

    def place_scores(self, seqs: list[bytes]):
        """Returns (edges, scores, counts, n_touched, sum_placed) arrays
        of shape (n, K) / (n,).  ``sum_placed`` is the double-precision
        LWR numerator sum over ALL touched branches (reference:
        place.cpp:164-184).  Uses the native tokenizer."""
        k = self.db.kmer_size
        t = native_tokenize_batch(seqs, k, self.alphabet)
        n = len(seqs)
        # size_t semantics: negative int64 -> uint64 two's-complement wrap
        m = (t.seq_lengths - k + 1).astype(np.int64).view(np.uint64)
        edges = np.empty((n, self.K), np.int32)
        scores = np.empty((n, self.K), np.float32)
        counts = np.empty((n, self.K), np.int64)
        n_touched = np.empty(n, np.int32)
        sum_placed = np.empty(n, np.float64)
        if self.threads > 1:
            self._lib.eh_place_scalar_mt(
                self._h, n, _np_ptr(np.ascontiguousarray(m)),
                _np_ptr(t.exact_keys), _np_ptr(t.exact_read), t.exact_keys.shape[0],
                _np_ptr(t.amb_keys), _np_ptr(t.amb_read), _np_ptr(t.amb_order),
                t.amb_keys.shape[0], self.K, self.threads,
                _np_ptr(edges), _np_ptr(scores), _np_ptr(counts),
                _np_ptr(n_touched), _np_ptr(sum_placed),
            )
        else:
            self._lib.eh_place_scalar(
                self._h, n, _np_ptr(np.ascontiguousarray(m)),
                _np_ptr(t.exact_keys), _np_ptr(t.exact_read), t.exact_keys.shape[0],
                _np_ptr(t.amb_keys), _np_ptr(t.amb_read), _np_ptr(t.amb_order),
                t.amb_keys.shape[0], self.K,
                _np_ptr(edges), _np_ptr(scores), _np_ptr(counts),
                _np_ptr(n_touched), _np_ptr(sum_placed),
            )
        return edges, scores, counts, n_touched, sum_placed

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.eh_scalar_db_free(self._h)
        except Exception:
            pass


class NativePlacer:
    """Full CPU placement engine over the native scalar placer.

    The reference's OpenMP run (-j N, epik/src/epik/place.cpp:218-229) as
    a drop-in engine with the ``place(records) -> PlacedCollection``
    surface: the C++ core scores + top-K selects + sums the LWR numerator
    per read; this wrapper mirrors the oracle's LWR normalization, quirk-
    Q2 fallback, and keep-factor filter (engine/reference.py::
    ReferencePlacer.place, reference: place.cpp:134-199,230-268).  For
    CPU-only deployments via ``epik place --engine native``."""

    def __init__(self, db, tree, keep_at_most: int = 7,
                 keep_factor: float = 0.01, threads: int = 1):
        from .core.scoring import score_threshold
        from .core.alphabet import get_alphabet

        self.db = db
        self.tree = tree
        self.keep_at_most = keep_at_most
        self.keep_factor = keep_factor
        self._scalar = NativeScalarPlacer(db, keep_at_most=keep_at_most,
                                          threads=threads)
        self.B = self._scalar.B
        alphabet = get_alphabet(db.sequence_type)
        thr = np.float32(score_threshold(db.omega, db.kmer_size,
                                         alphabet.sigma))
        self._log_thr = np.float32(np.log10(thr))
        num, tot = tree.tree_index()
        self._distal = tree.branch_lengths / 2.0
        mean = np.where(num > 1, tot / np.maximum(num, 1), 0.0)
        self._pendant = mean + self._distal

    def place(self, records):
        from .engine.types import PlacedCollection, PlacedSequence, Placement

        sequence_map: dict[bytes, list[str]] = {}
        for header, seq in records:
            sequence_map.setdefault(seq, []).append(header)
        seqs = list(sequence_map)
        if not seqs:
            return PlacedCollection(sequence_map=sequence_map, placed_seqs=[])
        edges, scores, counts, n_touched, sum_placed = (
            self._scalar.place_scores(seqs)
        )
        k = self.db.kmer_size
        f32 = np.float32
        placed_seqs = []
        for i, seq in enumerate(seqs):
            m = (len(seq) - k + 1) % (1 << 64)
            n = int(n_touched[i])
            keep_factor = self.keep_factor
            # sum over not-placed branches (place.cpp:164-184; f32 inner
            # arithmetic, double pow -- identical op order to the oracle)
            exponent = f32(f32(m) * self._log_thr / f32(k))
            score_sum = float(f32(self.B) - f32(n)) * (10.0 ** float(exponent))
            score_sum += float(sum_placed[i])
            if n == 0:
                # quirk Q2 fallback: keep_at_most fabricated placements
                ts = float(self._log_thr * f32(m) / f32(k))
                pl = [Placement(j, ts, 0.0, 0, 0.0, 0.0)
                      for j in range(self.keep_at_most)]
            else:
                keep = min(n, self.keep_at_most)
                pl = [
                    Placement(
                        branch_id=int(edges[i, j]),
                        score=float(scores[i, j]),
                        weight_ratio=0.0,
                        count=int(counts[i, j]),
                        distal_length=float(self._distal[edges[i, j]]),
                        pendant_length=float(self._pendant[edges[i, j]]),
                    )
                    for j in range(keep)
                ]
            for p in pl:
                if score_sum == 0:
                    p.weight_ratio = 0.0
                    keep_factor = 0.0  # quirk Q3
                else:
                    power = 10.0 ** float(f32(p.score))
                    p.weight_ratio = 0.0 if power == 0.0 else power / score_sum
            best = pl[0].weight_ratio if pl else 0.0
            ratio_threshold = best * keep_factor
            pl = [p for p in pl if p.weight_ratio >= ratio_threshold]
            placed_seqs.append(PlacedSequence(sequence=seq, placements=pl))
        return PlacedCollection(sequence_map=sequence_map,
                                placed_seqs=placed_seqs)


def native_ipk_records(data: bytes, start: int, n_kmers: int,
                       size_width: int, head_pad: int = 0):
    """Scan + extract the .ipk k-mer record section at C speed.

    Walks ``n_kmers`` records of ``[u64 key | size_t count | head_pad
    skipped bytes | count x (u32 branch, f32 score)]`` from byte
    ``start`` (head_pad = 4 under the item-version layout hypotheses).
    Returns
    ``(keys, lens, branches, scores, end_offset)``; raises ValueError with
    the failing byte offset on truncation or an implausible count (the
    .ipk reader converts that to its UnverifiedFormatError).  Returns None
    when the native library is unavailable (caller falls back to Python).
    """
    lib = load_native()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    keys = np.empty(n_kmers, np.uint64)
    lens = np.empty(n_kmers, np.int64)
    end = lib.eh_ipk_scan(
        _np_ptr(buf), buf.shape[0], start, n_kmers, size_width, head_pad,
        _np_ptr(keys), _np_ptr(lens),
    )
    if end < 0:
        raise ValueError(-end - 1)  # failing byte offset
    total = int(lens.sum())
    branches = np.empty(total, np.uint32)
    scores = np.empty(total, np.float32)
    end2 = lib.eh_ipk_extract(
        _np_ptr(buf), buf.shape[0], start, n_kmers, size_width, head_pad,
        _np_ptr(branches), _np_ptr(scores),
    )
    if end2 < 0:
        raise ValueError(-end2 - 1)
    return keys, lens, branches, scores, int(end)


def native_format_jplace(ids, scores, wr, dist, pend, keep,
                         headers_per_read: list[list[str]],
                         first_placement: bool) -> tuple[str, int]:
    """Serialize one batch of placement objects via the C++ formatter.

    Byte-identical to the Python writer loop (io/jplace.py; reference:
    epik/src/epik/jplace.cpp:21-38,121-158).  Returns (text, num_reads);
    raises RuntimeError when the native library is unavailable.
    """
    import json

    lib = load_native()
    if lib is None:
        raise RuntimeError("native library not available")
    R, K = ids.shape
    # headers pre-escaped host-side: json.dumps handles unicode/control
    # escaping at C speed; the C++ side copies tokens verbatim
    toks = [json.dumps(h).encode() for hs in headers_per_read for h in hs]
    nm_cnt = np.array([len(hs) for hs in headers_per_read], dtype=np.int32)
    lens = np.array([len(t) for t in toks], dtype=np.int64)
    nm_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    nm_buf = b"".join(toks)

    ids = np.ascontiguousarray(ids, dtype=np.int32)
    scores = np.ascontiguousarray(scores, dtype=np.float32)
    wr = np.ascontiguousarray(wr, dtype=np.float64)
    dist = np.ascontiguousarray(dist, dtype=np.float64)
    pend = np.ascontiguousarray(pend, dtype=np.float64)
    keep = np.ascontiguousarray(keep, dtype=np.uint8)

    cap = 128 * R + 136 * int(keep.sum()) + len(nm_buf) + 32 * len(toks) + 1024
    while True:
        out = ctypes.create_string_buffer(cap)
        n = lib.eh_format_jplace(
            R, K, _np_ptr(ids), _np_ptr(scores), _np_ptr(wr), _np_ptr(dist),
            _np_ptr(pend), _np_ptr(keep), nm_buf, _np_ptr(nm_off),
            _np_ptr(nm_cnt), int(first_placement), out, cap,
        )
        if n >= 0:
            return out.raw[:n].decode("utf-8"), int(nm_cnt.sum())
        cap *= 2
