"""Batched fuzzy matching over a vocabulary region (torch).

The reference resolves fuzzy query tokens with a BK-tree pruned by the
triangle inequality (src/algo/bktree.c:219, src/algo/levdist.c:67);
nxsearch_tpu replaced it with a brute-force bit-parallel Myers sweep
over a length-sorted vocabulary (nxsearch_tpu/ops/levenshtein.py).
This module is the same sweep in PyTorch: the distances come from the
hand-written CUDA kernels (ops/kernels.py: csrc/myers.cu forward and
single-query, csrc/myers_rev.cu transposed) on the card
and from their plain twins on the CPU; the selection stays torch ops.

Every function takes the row-major uint8[T, 32] vocabulary where its
JAX counterpart takes the position-major [32, T_pad] Pallas layout.
The JAX package's plain-jnp sweep (fuzzy_best, fuzzy_best_batch) maps
to the plain torch sweeps here, on any device.

Totals are carried as int64: torch's uint32 has few kernels, and the
matcher clips live totals to 0..2**32-1 before upload, so the values
and every comparison equal the reference's u32 ones.
"""

from __future__ import annotations

import torch

from .kernels import (MAX_BYTES, myers_distances, myers_distances_one_ref,
                      myers_distances_ref, myers_rev_distances,
                      myers_rev_distances_ref)

MAX_QUERY_BYTES = MAX_BYTES   # query pattern must fit the u32 DP column
MAX_TERM_BYTES = MAX_BYTES    # vocab snapshot width; longer -> host path

__all__ = ["MAX_QUERY_BYTES", "MAX_TERM_BYTES", "fuzzy_best",
           "fuzzy_best_batch", "fuzzy_best_kernel", "fuzzy_best_kernel_batch",
           "fuzzy_best_kernel_batch_rev", "fuzzy_best_region",
           "myers_distances", "myers_distances_one_ref",
           "myers_distances_ref", "myers_rev_distances",
           "myers_rev_distances_ref", "select_best", "select_best_ids"]

_NO_ID = 0x7FFFFFFF


def select_best(dist, vocab_len, term_total, tolerance: int):
    """(winning row or -1, distance at the winner), int32 each, per row
    of ``dist`` ([T] or [M, T]; the reference's select_best, whose
    batch callers vmap it over rows).

    Eligible: distance <= tolerance and live total > 0.  The highest
    total wins; ties pick the lowest row (the oldest term).  Without a
    winner the distance is row 0's, as the reference returns it."""
    n_terms = dist.shape[-1]
    idx = torch.arange(n_terms, device=dist.device)
    eligible = (vocab_len > 0) & (dist <= tolerance) & (term_total > 0)
    best_total = torch.where(eligible, term_total, 0).amax(dim=-1)
    at_best = eligible & (term_total == best_total.unsqueeze(-1))
    best = torch.where(at_best, idx, n_terms).amin(dim=-1)
    found = (best_total > 0) & (best < n_terms)
    best = torch.where(found, best, 0)
    return (torch.where(found, best, -1).to(torch.int32),
            dist.gather(-1, best.unsqueeze(-1)).squeeze(-1).to(torch.int32))


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
                      lo: int, tolerance: int, *, W: int,
                      mode: str) -> torch.Tensor:
    """Best fuzzy match of M query rows over the sorted-row region
    [lo, lo + W) of the length-sorted snapshot (fuzzy.py).

    ``mode`` "fwd" sweeps with myers_distances (the forward kernel; at
    M == 1 its single-query kernel), "rev" with
    myers_rev_distances (the transposed kernel).  The reference's "jnp"
    mode has no counterpart: on the CPU each mode runs its own kernel's
    twin.  Sweeping a SUPERSET of the query's length band is always
    correct: rows outside it are beyond tolerance by construction.
    ``lo`` is clamped like the reference's dynamic_slice start.
    Returns int32[M] original term indexes (-1: no match).
    """
    sweep = {"fwd": myers_distances, "rev": myers_rev_distances}.get(mode)
    if sweep is None:
        raise ValueError(f"fuzzy_best_region: unknown mode {mode!r}")
    lo = max(min(int(lo), vocab.shape[0] - W), 0)
    vb = vocab[lo: lo + W]
    vl = vocab_len[lo: lo + W]
    dist = sweep(vb, vl, q_bytes, q_len)
    return select_best_ids(dist, vl, term_total[lo: lo + W],
                           term_ids[lo: lo + W], tolerance)


def fuzzy_best(vocab_bytes, vocab_len, term_total, q_bytes, q_len,
               tolerance: int):
    """Best fuzzy match of one query (uint8[32], its length) by the
    plain single-query sweep: the counterpart of the reference's jnp
    fuzzy_best.  Returns (row or -1, distance at the winner)."""
    dist = myers_distances_one_ref(vocab_bytes, vocab_len, q_bytes, q_len)
    return select_best(dist, vocab_len, term_total, tolerance)


def fuzzy_best_batch(vocab_bytes, vocab_len, term_total, q_bytes, q_len,
                     tolerance: int):
    """fuzzy_best for M query rows (uint8[M, 32], int32[M]) by the plain
    batched sweep: the counterpart of the reference's jnp
    fuzzy_best_batch.  Returns (rows int32[M], distances int32[M])."""
    dist = myers_distances_ref(vocab_bytes, vocab_len, q_bytes, q_len)
    return select_best(dist, vocab_len, term_total, tolerance)


def fuzzy_best_kernel(vocab_bytes, vocab_len, term_total, q_bytes, q_len,
                      tolerance: int):
    """Best fuzzy match of one query through the single-query kernel
    (mirrors the reference's fuzzy_best_pallas).  Returns (row or -1,
    distance at the winner)."""
    q_len = torch.as_tensor(q_len, dtype=torch.int32,
                            device=vocab_bytes.device).reshape(1)
    dist = myers_distances(vocab_bytes, vocab_len, q_bytes[None, :],
                           q_len)[0]
    return select_best(dist, vocab_len, term_total, tolerance)


def fuzzy_best_kernel_batch(vocab_bytes, vocab_len, term_total, q_bytes,
                            q_len, tolerance: int):
    """M queries in one forward-kernel launch (mirrors the reference's
    fuzzy_best_pallas_batch).  Returns (rows, distances), int32[M]."""
    dist = myers_distances(vocab_bytes, vocab_len, q_bytes, q_len)
    return select_best(dist, vocab_len, term_total, tolerance)


def fuzzy_best_kernel_batch_rev(vocab_bytes, vocab_len, term_total, q_bytes,
                                q_len, tolerance: int):
    """M queries in one transposed-kernel launch, the char table built
    once per block and shared by every query (mirrors the reference's
    fuzzy_best_pallas_batch_rev).  Returns (rows, distances), int32[M]."""
    dist = myers_rev_distances(vocab_bytes, vocab_len, q_bytes, q_len)
    return select_best(dist, vocab_len, term_total, tolerance)
