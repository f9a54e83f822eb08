"""Segment accumulate: per-(read, branch) sums of posting-tile cells.

The big-tree tiles path (engine/placer.py::_place_batch_tiles_bytes)
gathers one posting tile row per window, which leaves every read with a
row of (branch, score) cells.  This module sums those cells into a
``(R, B)`` matrix -- the analog of the reference's SIMD ``update_vector``
gather-add (reference: epik/include/epik/intrinsic.h).

It is one XLA scatter-add.  On a GPU, XLA lowers a scatter-add with
duplicate indices to atomic adds, so the work is one add per posting.
Invalid cells hold the trash branch, an in-bounds column past ``B`` that
is sliced away.

Two payloads:

* packed int32 cells ``(branch << 16) | q`` with ``q`` a quantized shifted
  score: summed in int32, which is exact and independent of the order in
  which the adds land;
* separate branch / float32 score arrays: summed in float32, whose
  rounding depends on the order of the adds (a run-to-run variation far
  inside the 1e-4 parity tolerance).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["segment_sums", "segment_sums_packed", "trash_branch"]

#: column granularity of the accumulator (the width is padded to it)
_COL_ALIGN = 128


def trash_branch(num_branches: int) -> int:
    """The in-bounds column used for invalid cells (always >= num_branches):
    the last column of the ``num_branches + 1`` columns padded to 128."""
    return -(-(num_branches + 1) // _COL_ALIGN) * _COL_ALIGN - 1


def _scatter_rows(branch, vals, num_branches: int, dtype):
    R = branch.shape[0]
    rows = lax.broadcasted_iota(jnp.int32, branch.shape, 0)
    acc = jnp.zeros((R, trash_branch(num_branches) + 1), dtype)
    acc = acc.at[rows, branch].add(vals.astype(dtype), mode="promise_in_bounds")
    return acc[:, :num_branches]


def segment_sums_packed(cells, num_branches: int):
    """int32[R, B] sums of ``q`` per (read, branch) from packed cells
    ``(branch << 16) | q``; trash cells hold ``trash_branch(B) << 16``
    (q == 0).  The caller divides by the quantization scale once."""
    return _scatter_rows(cells >> 16, cells & 0xFFFF, num_branches, jnp.int32)


def segment_sums(branch, score, num_branches: int):
    """float32[R, B] sums of ``score`` per (read, branch); invalid cells
    hold ``trash_branch(B)`` (their score is ignored)."""
    return _scatter_rows(branch, score, num_branches, jnp.float32)
