"""Sequence alphabets and k-mer codecs.

Re-design of the reference's compile-time state alphabets
(reference: epik/CMakeLists.txt:70-76,122-128 links two binaries against
``i2l::dna`` / ``i2l::aa``; the state alphabet is a template parameter of the
i2l phylo-k-mer core).  Here the alphabet is a runtime object: a single engine
handles both DNA and amino-acid placement, selected by the database header.

Key encoding
------------
A k-mer is encoded as an integer in base ``sigma`` (alphabet size) with the
*first* character most significant::

    key(s) = sum_i code(s[i]) * sigma**(k-1-i)

* DNA: ``sigma=4`` (A=0, C=1, G=2, T=3; U->T).  k<=16 fits in uint32,
  k<=31 in uint64.
* Amino: ``sigma=20`` (alphabetical one-letter codes ACDEFGHIKLMNPQRSTVWY).
  k<=14 fits in uint64.

[inference] The exact bit layout of i2l's ``phylo_kmer::key_type`` could not
be read (the i2l submodule is empty in the reference checkout); this encoding
is reconstructed from the phylo-k-mer paper (arXiv:2209.09242) and from usage
(reference: epik/src/epik/main.cpp:325 shows keys are plain integers).  Our
database format stores the codec name so files are self-describing.

IUPAC ambiguity
---------------
``one_ambiguity_policy`` (reference: epik/src/epik/place.cpp:294): a window
with exactly one ambiguous position expands to one key per compatible state;
windows with two or more ambiguous positions yield no keys.  Characters
outside the alphabet + IUPAC set invalidate the window.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

__all__ = ["Alphabet", "DNA", "AMINO", "get_alphabet"]

# Sentinel codes in the per-character lookup table.
_INVALID = 0xFF  # character never contributes a key
_AMBIG_BASE = 0x80  # codes >= _AMBIG_BASE index the ambiguity table


@dataclasses.dataclass(frozen=True)
class Alphabet:
    """A state alphabet with a dense character->code map and IUPAC expansion.

    Attributes:
      name: "nucl" or "amino" (matches the reference CLI ``-s`` choices,
        reference: epik.py:34-38).
      sigma: alphabet size (4 or 20).
      letters: canonical letters, index == code.
      char_code: uint8[256] mapping ASCII byte -> code; ``_INVALID`` for
        characters that invalidate a window; ``_AMBIG_BASE + j`` for the
        j-th ambiguity symbol.
      ambig_expansions: tuple of tuples; entry j lists the exact codes the
        j-th ambiguity symbol expands to.
    """

    name: str
    sigma: int
    letters: str
    char_code: np.ndarray
    ambig_expansions: tuple[tuple[int, ...], ...]
    max_expansion: int

    def encode_codes(self, seq: bytes | np.ndarray) -> np.ndarray:
        """Map a byte sequence to per-character codes (uint8)."""
        arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else np.asarray(seq, dtype=np.uint8)
        return self.char_code[arr]

    def kmer_key(self, kmer: str) -> int:
        """Encode one unambiguous k-mer string to its integer key (python int)."""
        key = 0
        for ch in kmer.upper():
            code = int(self.char_code[ord(ch)])
            if code >= _AMBIG_BASE:
                raise ValueError(f"ambiguous/invalid character {ch!r} in k-mer {kmer!r}")
            key = key * self.sigma + code
        return key

    def decode_key(self, key: int, k: int) -> str:
        """Inverse of :meth:`kmer_key` (for tests / debugging)."""
        out = []
        for _ in range(k):
            out.append(self.letters[key % self.sigma])
            key //= self.sigma
        return "".join(reversed(out))

    @property
    def key_dtype(self):
        """Smallest numpy unsigned dtype able to hold any key for practical k."""
        return np.uint64


def _build(name: str, letters: str, ambigs: dict[str, str], extra_exact: dict[str, str] | None = None) -> Alphabet:
    table = np.full(256, _INVALID, dtype=np.uint8)
    for i, ch in enumerate(letters):
        table[ord(ch)] = i
        table[ord(ch.lower())] = i
    if extra_exact:
        for ch, target in extra_exact.items():
            table[ord(ch)] = letters.index(target)
            table[ord(ch.lower())] = letters.index(target)
    expansions = []
    for j, (ch, targets) in enumerate(sorted(ambigs.items())):
        table[ord(ch)] = _AMBIG_BASE + j
        table[ord(ch.lower())] = _AMBIG_BASE + j
        expansions.append(tuple(letters.index(t) for t in targets))
    max_exp = max((len(e) for e in expansions), default=1)
    return Alphabet(
        name=name,
        sigma=len(letters),
        letters=letters,
        char_code=table,
        ambig_expansions=tuple(expansions),
        max_expansion=max_exp,
    )


#: DNA alphabet. IUPAC ambiguity codes expand per the standard:
#: R=AG Y=CT S=CG W=AT K=GT M=AC B=CGT D=AGT H=ACT V=ACG N=ACGT.
DNA = _build(
    "nucl",
    "ACGT",
    {
        "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
        "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
    },
    extra_exact={"U": "T"},
)

#: Amino-acid alphabet (20 standard residues, alphabetical one-letter codes).
#: Ambiguity: B=D/N, Z=E/Q, J=I/L, X=any.
AMINO = _build(
    "amino",
    "ACDEFGHIKLMNPQRSTVWY",
    {
        "B": "DN", "Z": "EQ", "J": "IL", "X": "ACDEFGHIKLMNPQRSTVWY",
    },
)


@lru_cache(maxsize=None)
def get_alphabet(name: str) -> Alphabet:
    """Look up an alphabet by name ("nucl"/"dna" or "amino"/"aa")."""
    name = name.lower()
    if name in ("nucl", "dna", "nucleotides"):
        return DNA
    if name in ("amino", "aa", "proteins"):
        return AMINO
    raise ValueError(f"unknown alphabet: {name!r}")
