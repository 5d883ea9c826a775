"""Batched fuzzy matching over a vocabulary region (torch).

The reference resolves fuzzy query tokens with a BK-tree pruned by the
triangle inequality (src/algo/bktree.c:219, src/algo/levdist.c:67);
nxsearch_tpu replaced it with a brute-force bit-parallel Myers sweep
over a length-sorted vocabulary (nxsearch_tpu/ops/levenshtein.py).
This module is the same sweep in PyTorch: the distances come from the
hand-written CUDA kernel (ops/kernels.py, csrc/myers.cu) on the card
and from its plain twin on the CPU; the selection stays torch ops.

Totals are carried as int64: torch's uint32 has few kernels, and the
matcher clips live totals to 0..2**32-1 before upload, so the values
and every comparison equal the reference's u32 ones.
"""

from __future__ import annotations

import torch

from .kernels import MAX_BYTES, myers_distances, myers_distances_ref

MAX_QUERY_BYTES = MAX_BYTES   # query pattern must fit the u32 DP column
MAX_TERM_BYTES = MAX_BYTES    # vocab snapshot width; longer -> host path

__all__ = ["MAX_QUERY_BYTES", "MAX_TERM_BYTES", "fuzzy_best_region",
           "myers_distances", "myers_distances_ref", "select_best_ids"]

_NO_ID = 0x7FFFFFFF


def select_best_ids(dist, vocab_len, term_total, term_ids, tolerance: int):
    """Winning ORIGINAL term index per query row, or -1.

    ``dist`` int32[M, W]; the region's ``vocab_len`` int32[W],
    ``term_total`` int64[W] and ``term_ids`` int32[W].  Eligible:
    distance <= tolerance and live total > 0;
    the highest total wins, ties on the total pick the lowest original
    index (the length-sorted snapshot no longer encodes term age in
    row order).  Same reductions as the reference's select_best_ids.
    """
    eligible = ((vocab_len > 0)[None, :] & (dist <= tolerance)
                & (term_total > 0)[None, :])
    best_total = torch.where(eligible, term_total[None, :],
                             0).amax(dim=1)
    at_best = eligible & (term_total[None, :] == best_total[:, None])
    best_id = torch.where(at_best, term_ids[None, :].to(torch.int64),
                          _NO_ID).amin(dim=1)
    found = (best_total > 0) & (best_id < _NO_ID)
    return torch.where(found, best_id, -1).to(torch.int32)


def fuzzy_best_region(vocab: torch.Tensor,       # uint8[T, 32]
                      vocab_len: torch.Tensor,   # int32[T]
                      term_total: torch.Tensor,  # int64[T]
                      term_ids: torch.Tensor,    # int32[T]
                      q_bytes: torch.Tensor,     # uint8[M, 32]
                      q_len: torch.Tensor,       # int32[M]
                      lo: int, tolerance: int, *, W: int) -> torch.Tensor:
    """Best fuzzy match of M query rows over the sorted-row region
    [lo, lo + W) of the length-sorted snapshot (fuzzy.py).

    Sweeping a SUPERSET of the query's length band is always correct:
    rows outside it are beyond tolerance by construction.  ``lo`` is
    clamped like the reference's dynamic_slice start.  Returns int32[M]
    original term indexes (-1: no match).
    """
    lo = max(min(int(lo), vocab.shape[0] - W), 0)
    vb = vocab[lo: lo + W]
    vl = vocab_len[lo: lo + W]
    dist = myers_distances(vb, vl, q_bytes, q_len)
    return select_best_ids(dist, vl, term_total[lo: lo + W],
                           term_ids[lo: lo + W], tolerance)
