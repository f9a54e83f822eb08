"""Vectorized k-mer window tokenizer with the one-ambiguity policy.

Replaces the reference's per-read, per-window serial iterator
``i2l::to_kmers<i2l::one_ambiguity_policy>(seq, k)``
(reference: epik/src/epik/place.cpp:294-314).  The reference walks windows one
at a time inside each OpenMP worker; here a whole read (and, one level up, a
whole batch) is tokenized in flat numpy ops so the result can be shipped to
the device as dense key streams (SURVEY.md section 5.7: flatten all windows of a
batch; the accumulate becomes a segment reduction independent of read length).

Semantics reproduced exactly (see SURVEY.md quirk ledger):

* A window with zero ambiguous characters yields exactly one key
  (reference: place.cpp:297-305 handles ``keys.size() == 1``).
* A window with exactly one ambiguous IUPAC character yields one key per
  compatible state (reference: place.cpp:306-313 iterates expanded keys; the
  policy name ``one_ambiguity_policy`` -- windows with more than one ambiguous
  position yield no keys).
* Characters outside alphabet+IUPAC invalidate the window. [inference: i2l
  source unavailable; an unrecognized character cannot be encoded, so its
  windows cannot produce keys]
* ``num_windows`` counts ALL length-k windows (len-k+1) regardless of how many
  produced keys -- the score correction divides by it
  (reference: place.cpp:322,418-422).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .alphabet import _AMBIG_BASE, _INVALID, Alphabet

__all__ = ["ReadKmers", "tokenize_read", "tokenize_batch", "BatchTokens"]


@dataclasses.dataclass
class ReadKmers:
    """Key streams for a single read."""

    num_windows: int  # len - k + 1 (0 when len < k; see quirk Q1)
    exact_keys: np.ndarray  # uint64[n_exact], in window order
    amb_keys: np.ndarray  # uint64[n_amb], window order then expansion order
    amb_order: np.ndarray  # int32[n_amb], 0..n_amb-1 (processing order,
    # drives the first-hit-per-branch semantics of quirk Q6/Q7)


def _window_sums(flags: np.ndarray, k: int) -> np.ndarray:
    """Sum of a 0/1 per-char flag over each length-k window (length L-k+1)."""
    c = np.concatenate([[0], np.cumsum(flags, dtype=np.int32)])
    return c[k:] - c[:-k]


def tokenize_read(seq: bytes | str | np.ndarray, k: int, alphabet: Alphabet) -> ReadKmers:
    """Tokenize one read into exact / ambiguous key streams."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    codes = alphabet.encode_codes(seq)
    L = codes.shape[0]
    empty64 = np.empty(0, dtype=np.uint64)
    empty32 = np.empty(0, dtype=np.int32)
    if L < k:
        return ReadKmers(0, empty64, empty64, empty32)
    m = L - k + 1

    is_inv = codes == _INVALID
    is_amb = (codes >= _AMBIG_BASE) & ~is_inv
    inv_per_win = _window_sums(is_inv, k)
    amb_per_win = _window_sums(is_amb, k)

    exact_win = (inv_per_win == 0) & (amb_per_win == 0)
    one_amb_win = (inv_per_win == 0) & (amb_per_win == 1)

    sigma = np.uint64(alphabet.sigma)
    mult = sigma ** np.arange(k - 1, -1, -1, dtype=np.uint64)  # first char most significant

    # Partial keys treating ambiguous codes as 0 (their digit is patched below).
    digits = np.where(codes < sigma, codes, 0).astype(np.uint64)
    # windowed dot product digits[i:i+k] . mult via cumsum of digit*mult shifted:
    # key(w) = sum_j digits[w+j] * sigma^(k-1-j). Use a strided view for clarity;
    # reads are short (hundreds of chars) so this is cheap and cache-friendly.
    win = np.lib.stride_tricks.sliding_window_view(digits, k)
    base_keys = (win * mult).sum(axis=1, dtype=np.uint64)

    exact_keys = base_keys[exact_win]

    amb_keys_list: list[np.ndarray] = []
    amb_counts: list[int] = []
    if one_amb_win.any():
        amb_pos_per_char = np.flatnonzero(is_amb)
        # For each one-amb window find the (single) ambiguous position inside it.
        wins = np.flatnonzero(one_amb_win)
        # For each window start w, the ambiguous char index p satisfies w <= p < w+k.
        p = amb_pos_per_char[np.searchsorted(amb_pos_per_char, wins)]
        amb_sym = codes[p] - _AMBIG_BASE
        for w, pos, sym in zip(wins, p, amb_sym):
            exp = alphabet.ambig_expansions[int(sym)]
            keys = base_keys[w] + np.asarray(exp, dtype=np.uint64) * mult[pos - w]
            amb_keys_list.append(keys)
            amb_counts.append(len(keys))
    if amb_keys_list:
        amb_keys = np.concatenate(amb_keys_list)
        amb_order = np.arange(amb_keys.shape[0], dtype=np.int32)
    else:
        amb_keys, amb_order = empty64, empty32
    return ReadKmers(int(m), exact_keys, amb_keys, amb_order)


@dataclasses.dataclass
class BatchTokens:
    """Flat key streams for a batch of (unique) reads.

    The device pipeline consumes these as padded dense arrays; `read_id`
    vectors are the segment ids of SURVEY.md section 5.7.
    """

    num_reads: int
    num_windows: np.ndarray  # int64[num_reads]  (m per read; 0 when len < k)
    seq_lengths: np.ndarray  # int64[num_reads]  (raw lengths, for quirk Q1)
    exact_keys: np.ndarray  # uint64[E]
    exact_read: np.ndarray  # int32[E]
    amb_keys: np.ndarray  # uint64[A]
    amb_read: np.ndarray  # int32[A]
    amb_order: np.ndarray  # int32[A] per-read processing order


def tokenize_batch_slow(seqs: list[bytes], k: int, alphabet: Alphabet) -> BatchTokens:
    """Per-read tokenization (behavioral specification; differential oracle
    for the single-pass version below)."""
    n = len(seqs)
    num_windows = np.zeros(n, dtype=np.int64)
    seq_lengths = np.zeros(n, dtype=np.int64)
    e_keys, e_read = [], []
    a_keys, a_read, a_order = [], [], []
    for i, s in enumerate(seqs):
        t = tokenize_read(s, k, alphabet)
        num_windows[i] = t.num_windows
        seq_lengths[i] = len(s)
        if t.exact_keys.size:
            e_keys.append(t.exact_keys)
            e_read.append(np.full(t.exact_keys.shape[0], i, dtype=np.int32))
        if t.amb_keys.size:
            a_keys.append(t.amb_keys)
            a_read.append(np.full(t.amb_keys.shape[0], i, dtype=np.int32))
            a_order.append(t.amb_order)
    cat64 = lambda xs: np.concatenate(xs) if xs else np.empty(0, dtype=np.uint64)
    cat32 = lambda xs: np.concatenate(xs) if xs else np.empty(0, dtype=np.int32)
    return BatchTokens(
        num_reads=n,
        num_windows=num_windows,
        seq_lengths=seq_lengths,
        exact_keys=cat64(e_keys),
        exact_read=cat32(e_read),
        amb_keys=cat64(a_keys),
        amb_read=cat32(a_read),
        amb_order=cat32(a_order),
    )


def tokenize_batch(seqs: list[bytes], k: int, alphabet: Alphabet) -> BatchTokens:
    """Single-pass vectorized batch tokenizer.

    All reads are concatenated with k-1 invalid separator bytes; windows,
    ambiguity classification, and rolling keys are computed over the whole
    buffer in flat numpy sweeps (no per-read Python loop).  Windows crossing
    read boundaries land on separator bytes and are discarded by the same
    invalid-character rule that drops bad characters inside reads.  This is
    the host-side hot path feeding the device pipeline; at 150bp x 2000-read
    batches the per-read loop would cap end-to-end throughput around
    20k reads/s, far below the device rate.
    """
    n = len(seqs)
    num_windows = np.zeros(n, dtype=np.int64)
    seq_lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    empty = BatchTokens(
        num_reads=n,
        num_windows=num_windows,
        seq_lengths=seq_lengths,
        exact_keys=np.empty(0, np.uint64),
        exact_read=np.empty(0, np.int32),
        amb_keys=np.empty(0, np.uint64),
        amb_read=np.empty(0, np.int32),
        amb_order=np.empty(0, np.int32),
    )
    if n == 0:
        return empty
    num_windows[:] = np.maximum(seq_lengths - k + 1, 0)

    sep = b"\x00" * (k - 1) if k > 1 else b""
    buf = sep.join(seqs)
    codes = alphabet.encode_codes(buf)
    L = codes.shape[0]
    if L < k:
        return empty

    # read id per buffer position; separators belong to the preceding read
    # (their windows are invalid anyway)
    starts = np.concatenate([[0], np.cumsum(seq_lengths[:-1] + (k - 1))])
    read_of_pos = np.zeros(L, dtype=np.int32)
    # a trailing empty read starts at L (past the buffer) -- no positions
    in_range = starts[1:][starts[1:] < L]
    np.add.at(read_of_pos, in_range, 1)  # several empty reads may share a start
    read_of_pos = np.cumsum(read_of_pos, dtype=np.int32)

    is_inv = codes == _INVALID
    is_amb = (codes >= _AMBIG_BASE) & ~is_inv
    inv_w = _window_sums(is_inv, k)
    amb_w = _window_sums(is_amb, k)
    exact_w = (inv_w == 0) & (amb_w == 0)
    oneamb_w = (inv_w == 0) & (amb_w == 1)

    sigma = np.uint64(alphabet.sigma)
    mult = sigma ** np.arange(k - 1, -1, -1, dtype=np.uint64)
    digits = np.where(codes < sigma, codes, 0).astype(np.uint64)
    # rolling base keys: k contiguous shifted multiply-adds (a strided
    # sliding_window_view product is ~100x slower on non-contiguous memory)
    n_win = L - k + 1
    base_keys = np.zeros(n_win, dtype=np.uint64)
    for j in range(k):
        base_keys += digits[j : j + n_win] * mult[j]
    win_read = read_of_pos[:n_win]

    exact_keys = base_keys[exact_w]
    exact_read = win_read[exact_w]

    if oneamb_w.any():
        amb_pos = np.flatnonzero(is_amb)
        wins = np.flatnonzero(oneamb_w)
        # the single ambiguous position inside each one-amb window
        p = amb_pos[np.searchsorted(amb_pos, wins)]
        sym = codes[p] - _AMBIG_BASE
        fanout = np.array(
            [len(e) for e in alphabet.ambig_expansions], dtype=np.int64
        )[sym]
        # flatten (window, expansion) pairs
        total = int(fanout.sum())
        w_rep = np.repeat(wins, fanout)
        p_rep = np.repeat(p, fanout)
        # index within each window's expansion list
        exp_starts = np.concatenate([[0], np.cumsum(fanout)[:-1]])
        j = np.arange(total, dtype=np.int64) - np.repeat(exp_starts, fanout)
        # expansion code table: [symbol, j] -> exact code
        max_fan = alphabet.max_expansion
        exp_table = np.zeros((len(alphabet.ambig_expansions), max_fan), dtype=np.uint64)
        for si, e in enumerate(alphabet.ambig_expansions):
            exp_table[si, : len(e)] = e
        codes_rep = exp_table[np.repeat(sym, fanout), j]
        amb_keys = base_keys[w_rep] + codes_rep * mult[p_rep - w_rep]
        amb_read = win_read[w_rep]
        # per-read processing order: windows in order, expansion order within
        first_of_read = np.zeros(total, dtype=bool)
        first_of_read[0] = True
        first_of_read[1:] = amb_read[1:] != amb_read[:-1]
        idx = np.arange(total, dtype=np.int64)
        read_start = np.maximum.accumulate(np.where(first_of_read, idx, 0))
        amb_order = (idx - read_start).astype(np.int32)
    else:
        amb_keys = np.empty(0, np.uint64)
        amb_read = np.empty(0, np.int32)
        amb_order = np.empty(0, np.int32)

    return BatchTokens(
        num_reads=n,
        num_windows=num_windows,
        seq_lengths=seq_lengths,
        exact_keys=exact_keys,
        exact_read=exact_read.astype(np.int32),
        amb_keys=amb_keys,
        amb_read=amb_read.astype(np.int32),
        amb_order=amb_order,
    )
