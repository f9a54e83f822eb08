"""Faithful scalar (NumPy) placement engine -- the differential oracle.

This is a from-scratch reimplementation of the reference's placement
algorithm (reference: epik/src/epik/place.cpp) in plain Python/NumPy, kept
deliberately close to the scalar C++ semantics **including float32
accumulation and the quirk ledger Q1-Q11 of SURVEY.md**.  It is the
second implementation for differential testing (the pattern of
reference: scripts/ppdiff.py:235-255) and the golden oracle for the device
engine; it is NOT the fast path.

Numeric model:
* per-branch scores accumulate in float32, in posting-list order
  (place.cpp:358-367);
* pow(10, x) and the LWR sum use float64, matching gcc's
  ``epik::impl::pow = std::pow(double,double)`` (place.h:29, place.cpp:39-48);
* size_t wraparound semantics for reads shorter than k are reproduced
  (quirk Q1, place.cpp:322: ``seq.size() - k + 1`` underflows).
"""

from __future__ import annotations

import numpy as np

from ..core.alphabet import get_alphabet
from ..core.kmers import tokenize_read
from ..core.scoring import score_threshold
from ..core.tree import PhyloTree
from ..io.db import PhyloKmerDB
from .types import PlacedCollection, PlacedSequence, Placement

__all__ = ["ReferencePlacer"]

_U64 = 1 << 64


class ReferencePlacer:
    """Scalar placer mirroring ``epik::placer`` (place.cpp:83-126)."""

    def __init__(
        self,
        db: PhyloKmerDB,
        tree: PhyloTree,
        keep_at_most: int = 7,
        keep_factor: float = 0.01,
    ):
        self.db = db
        self.tree = tree
        self.alphabet = get_alphabet(db.sequence_type)
        # reference: place.cpp:87-88 -- threshold from db.omega() AFTER load
        # (quirk Q10), stored float32, log10 in float32.
        self.threshold = np.float32(score_threshold(db.omega, db.kmer_size, self.alphabet.sigma))
        self.log_threshold = np.float32(np.log10(self.threshold))
        self.keep_at_most = keep_at_most
        self.keep_factor = keep_factor

        # reference: place.cpp:98-125 -- precompute pendant lengths.
        num, tot = tree.tree_index()
        n = tree.get_node_count()
        self.distal_lengths = tree.branch_lengths / 2.0
        mean = np.where(num > 1, tot / np.maximum(num, 1), 0.0)
        self.pendant_lengths = mean + self.distal_lengths

    # -- the hot loop (reference: place.cpp:320-440) ---------------------------

    def place_seq(self, seq: bytes) -> PlacedSequence:
        db, k = self.db, self.db.kmer_size
        n_branches = self.tree.get_node_count()
        # quirk Q1: size_t underflow for len < k
        num_of_kmers = (len(seq) - k + 1) % _U64

        S = np.zeros(n_branches, dtype=np.float32)
        C = np.zeros(n_branches, dtype=np.int64)
        S_amb = np.zeros(n_branches, dtype=np.float32)
        C_amb = np.zeros(n_branches, dtype=np.int64)
        edges: list[int] = []

        tokens = tokenize_read(seq, k, self.alphabet)

        # exact accumulation (place.cpp:349-371)
        for key in tokens.exact_keys:
            res = db.search(int(key))
            if res is None:
                continue
            branches, scores = res
            for b, s in zip(branches, scores):
                b = int(b)
                if C[b] == 0:
                    edges.append(b)
                C[b] += 1
                S[b] += s  # float32 += float32

        # ambiguous accumulation (place.cpp:373-415, quirks Q6/Q7):
        # each expanded key is its own group (query_kmers pushes one search
        # result per key, place.cpp:306-313); l_amb collects branches first
        # touched by THIS key; C_amb/S_amb persist across the whole read.
        for key in tokens.amb_keys:
            res = db.search(int(key))
            if res is None:
                continue
            l_amb: list[int] = []
            branches, scores = res
            for b, s in zip(branches, scores):
                b = int(b)
                if C_amb[b] == 0:
                    l_amb.append(b)
                C_amb[b] += 1
                # std::pow(10, score) in double, cast to float32 (place.cpp:391)
                S_amb[b] += np.float32(10.0 ** float(s))
            w_size = k  # quirk Q6: kmer_size, not the expansion fan-out
            for b in l_amb:
                average_prob = np.float32(
                    (S_amb[b] + np.float32(w_size - C_amb[b]) * self.threshold)
                    / np.float32(w_size)
                )
                if C[b] == 0:
                    edges.append(b)
                C[b] += 1
                S[b] += average_prob  # probability units added to log units (Q6)

        # score correction (place.cpp:417-422); size_t wrap for (m - C) kept
        for e in edges:
            diff = (num_of_kmers - int(C[e])) % _U64
            S[e] += np.float32(diff) * self.log_threshold
            S[e] = np.float32(S[e] / np.float32(k))

        placements = [
            Placement(
                branch_id=e,
                score=float(S[e]),
                weight_ratio=0.0,
                count=int(C[e]),
                distal_length=float(self.distal_lengths[e]),
                pendant_length=float(self.pendant_lengths[e]),
            )
            for e in edges
        ]
        return PlacedSequence(sequence=seq, placements=placements)

    # -- LWR + selection (reference: place.cpp:134-199,230-268) ---------------

    def _sum_scores(self, placements: list[Placement], seq_len: int) -> float:
        """reference: place.cpp:164-184 (quirk Q4: normalize over ALL branches)."""
        k = self.db.kmer_size
        num_branches = np.float32(self.tree.get_node_count())
        num_placements = np.float32(len(placements))
        num_kmers = np.float32((seq_len - k + 1) % _U64)
        kmer_size = np.float32(k)
        exponent = np.float32(num_kmers * self.log_threshold / kmer_size)
        sum_not_placed = float(num_branches - num_placements) * (10.0 ** float(exponent))
        sum_placed = 0.0
        for p in placements:
            sum_placed += 10.0 ** float(np.float32(p.score))
        return sum_not_placed + sum_placed

    def _select_best(self, placements: list[Placement], num_kmers: int) -> list[Placement]:
        """reference: place.cpp:134-159 incl. the no-match fallback (quirk Q2)."""
        return_size = min(self.keep_at_most, len(placements))
        if return_size == 0:
            return_size = self.keep_at_most
            threshold_score = float(
                self.log_threshold * np.float32(num_kmers) / np.float32(self.db.kmer_size)
            )
            placements = [
                Placement(i, threshold_score, 0.0, 0, 0.0, 0.0)
                for i in range(self.keep_at_most)
            ]
        placements = sorted(placements, key=lambda p: -p.score)
        return placements[:return_size]

    def place(self, records: list[tuple[str, bytes]]) -> PlacedCollection:
        """reference: place.cpp:201-275 (dedup quirk Q8 + LWR quirk Q3)."""
        sequence_map: dict[bytes, list[str]] = {}
        for header, seq in records:
            sequence_map.setdefault(seq, []).append(header)

        placed_seqs = []
        for seq in sequence_map:
            keep_factor = self.keep_factor
            placed = self.place_seq(seq)
            score_sum = self._sum_scores(placed.placements, len(seq))
            num_kmers = (len(seq) - self.db.kmer_size + 1) % _U64
            placed.placements = self._select_best(placed.placements, num_kmers)
            for p in placed.placements:
                if score_sum == 0:
                    # quirk Q3: all ratios zero, disable the ratio filter
                    p.weight_ratio = 0.0
                    keep_factor = 0.0
                else:
                    power = 10.0 ** float(np.float32(p.score))
                    p.weight_ratio = 0.0 if power == 0.0 else power / score_sum
            # filter_by_ratio (place.cpp:188-199)
            best = placed.placements[0].weight_ratio if placed.placements else 0.0
            ratio_threshold = best * keep_factor
            placed.placements = [p for p in placed.placements if p.weight_ratio >= ratio_threshold]
            placed_seqs.append(placed)
        return PlacedCollection(sequence_map=sequence_map, placed_seqs=placed_seqs)
