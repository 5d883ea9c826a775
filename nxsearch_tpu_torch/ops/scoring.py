"""Elementwise ranking formulas (src/algo/ranking.c:41,99) in torch,
and the flat gather plan of the candidate / dense executors.

Same operation order as nxsearch_tpu/ops/scoring.py, in f32: a python
scalar operand of a float32 tensor op is rounded to f32 first, like
JAX's weakly typed scalars, so the CPU results match the reference to
the last ulp.  ``host_idf`` and the constants are pure Python and are
kept identical.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# BM25 constants (reference: src/algo/ranking.c:141-142).
BM25_K1 = 1.2
BM25_B = 0.75

ALGO_BM25 = 0
ALGO_TFIDF = 1


def flatten_ranges(q_start: torch.Tensor, q_len: torch.Tensor, budget: int):
    """Flatten each row's Q variable-length CSR ranges into one
    fixed-size plan of ``budget`` positions (>= every row's total).

    q_start / q_len: int[..., Q] (a leading batch axis is optional).
    Returns (src, qid, valid), each [..., budget]: the postings index,
    the owning query-term index and whether the position addresses a
    real posting.  Ranges lie back to back in term order; the
    right-sided search skips zero-length ranges, as in the reference.
    ``src`` of an invalid position may point past the postings (the
    caller clamps its gathers)."""
    lead = q_len.shape[:-1]
    n_terms = q_len.shape[-1]
    q_len = q_len.to(torch.int64).reshape(-1, n_terms)
    q_start = q_start.to(torch.int64).reshape(-1, n_terms)
    cum = torch.nn.functional.pad(torch.cumsum(q_len, dim=1), (1, 0))
    b = torch.arange(budget, dtype=torch.int64, device=q_len.device)
    b = b.expand(q_len.shape[0], budget).contiguous()
    qid = torch.searchsorted(cum, b, right=True) - 1
    qid = qid.clamp(0, n_terms - 1)
    src = q_start.gather(1, qid) + (b - cum.gather(1, qid))
    valid = b < cum[:, -1:]
    return (src.reshape(lead + (budget,)), qid.reshape(lead + (budget,)),
            valid.reshape(lead + (budget,)))


def bm25(ltf, dl, idf, adl):
    """BM25 (ranking.c:99-174): tf'/(tf' + k*(1 - b + b*dl/adl)) * idf.

    ``ltf`` is the snapshot's stored log(tf+1), ``idf`` the host-f64
    log((N - df + 0.5)/(df + 0.5) + 1) rounded to f32, and ``adl`` the
    reference's *integer* division token_count // doc_count
    (ranking.c:160 divides unsigned longs).
    """
    return ltf / (ltf + BM25_K1 * (1.0 - BM25_B + BM25_B * dl / adl)) * idf


def tf_idf(ltf, idf):
    """TF-IDF (ranking.c:41-96): log(tf+1) * (log(N/df) + 1).

    ``idf`` = log(N/df) + 1, host-precomputed per query term.
    """
    return ltf * idf


def host_idf(algo: int, doc_count: int, df: int) -> float:
    """Per-term IDF in f64 on the host, matching the C arithmetic.

    TF-IDF: log((float)N / df) + 1 -- the N/df division is f32 in the
    reference (ranking.c:91 casts), mirrored here before the log.
    BM25:   log((N - df + 0.5)/(df + 0.5) + 1) in f64 (ranking.c:171).
    """
    if algo == ALGO_TFIDF:
        ratio = float(np.float32(doc_count) / np.float32(df))
        return math.log(ratio) + 1.0
    return math.log((doc_count - df + 0.5) / (df + 0.5) + 1.0)
