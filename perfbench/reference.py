"""The plain reference: BM25 top-k over the benchmark's own corpus.

Plain PyTorch (on the card after the window, or on the CPU in tests),
in float64.  It imports nothing of the engine and takes nothing that
the engine made: it works out again, from the corpus arrays and the
structured queries the benchmark made,

- the terms (the words are filter-stable, see corpus.py: a query word
  is its term; a term's id is its rank + 1, since the harness
  registers the vocabulary in rank order),
- document lengths, document frequencies and total occurrences,
- BM25 with the engine's constants,
- the boolean forms (traffic.py),
- each typo's resolution,
- the top k, ties to the lowest device slot.

Frozen rules of the engine (nxsearch's ranking.c and idxterm.c, as the
port's numpy oracles in chip_smoke.py state them):

- BM25: idf = log((N - df + 0.5) / (df + 0.5) + 1); ltf = log(tf + 1);
  score = sum over the query's tokens of
  ltf / (ltf + k1 * (1 - b + b * dl / adl)) * idf, k1 = 1.2, b = 0.75,
  adl = (total tokens) // N (integer division); tokens are distinct by
  their text, so a typo that resolves to a term the query also names
  counts that term twice;
- a query scores every token it names, NOT's too, over the documents
  that match it (AND intersects, OR unites, AND NOT subtracts); a
  token that resolves to nothing is the empty set;
- a typo resolves to the term of largest total occurrences among terms
  within Levenshtein distance 2 over bytes, ties to the lowest term id;
- device slots ascend by document length (stable), and equal scores
  rank the lower slot first.
"""

from __future__ import annotations

import math

import numpy as np

K1, B = 1.2, 0.75
FUZZY_TOL = 2


class Reference:
    def __init__(self, corpus, device, dtype=None):
        import torch

        self.torch = torch
        self.device = device
        self.dtype = dtype or torch.float64
        c = corpus
        self.n = c.n_docs
        self.vocab = len(c.strings)
        rank = torch.from_numpy(c.pair_rank).to(device)
        count = torch.from_numpy(c.pair_count).to(device)
        n_pairs = torch.from_numpy(np.diff(c.doc_ptr)).to(device)
        doc = torch.repeat_interleave(
            torch.arange(self.n, dtype=torch.int32, device=device), n_pairs)
        self.df = torch.bincount(rank, minlength=self.vocab)
        self.total = torch.bincount(rank, weights=count.to(torch.float64),
                                    minlength=self.vocab).to(torch.int64)
        _, order = torch.sort(rank, stable=True)
        del rank
        self.post_doc = doc[order]
        self.post_tf = count[order]
        del order, doc, count
        self.starts = torch.zeros(self.vocab + 1, dtype=torch.int64,
                                  device=device)
        torch.cumsum(self.df, 0, out=self.starts[1:])
        dl = torch.from_numpy(c.doc_len).to(device)
        self.adl = int(c.doc_len.sum()) // self.n
        self.norm = K1 * (1.0 - B + B * dl.to(torch.float64) / self.adl)
        self.norm = self.norm.to(self.dtype)
        # Device slot of each document: stable ascending length order.
        perm = np.argsort(c.doc_len, kind="stable")
        slot = np.empty(self.n, dtype=np.int64)
        slot[perm] = np.arange(self.n)
        self.slot = slot
        self.words = torch.from_numpy(c.words).to(device)
        self.lens = self.words.ne(0).sum(1)

    # -- terms ---------------------------------------------------------

    def resolve(self, text: str):
        """Rank of the term a typo resolves to, or None."""
        torch = self.torch
        q = text.encode()
        lo, hi = max(1, len(q) - FUZZY_TOL), len(q) + FUZZY_TOL
        band = torch.nonzero((self.lens >= lo) & (self.lens <= hi)
                             & (self.total > 0)).flatten()
        if not len(band):
            return None
        rows = self.words[band].to(torch.int16)
        lens = self.lens[band]
        w = rows.shape[1]
        prev = torch.arange(w + 1, dtype=torch.int16,
                            device=self.device).expand(len(band), w + 1)
        for i, ch in enumerate(q, 1):
            cost = rows.ne(ch).to(torch.int16)
            cur = torch.empty_like(prev)
            cur[:, 0] = i
            diag = prev[:, :-1] + cost
            up = prev[:, 1:] + 1
            best = torch.minimum(diag, up)
            for j in range(1, w + 1):
                cur[:, j] = torch.minimum(best[:, j - 1], cur[:, j - 1] + 1)
            prev = cur
        dist = prev.gather(1, lens[:, None]).flatten()
        hit = band[dist <= FUZZY_TOL]
        if not len(hit):
            return None
        tot = self.total[hit]
        best = hit[tot == tot.max()].min()
        return int(best)

    # -- scoring -------------------------------------------------------

    def term_scores(self, r: int):
        """(documents, scores) of term rank r, in self.dtype."""
        torch = self.torch
        lo, hi = int(self.starts[r]), int(self.starts[r + 1])
        docs = self.post_doc[lo:hi].to(torch.int64)
        df = hi - lo
        idf = math.log((self.n - df + 0.5) / (df + 0.5) + 1.0)
        ltf = torch.log(self.post_tf[lo:hi].to(torch.float64) + 1.0)
        ltf = ltf.to(self.dtype)
        idf_t = torch.tensor(idf, dtype=torch.float64).to(self.dtype)
        return docs, ltf / (ltf + self.norm[docs]) * idf_t

    def answer(self, q, limit: int):
        """[(doc id, score)] of the top ``limit`` for a traffic Query,
        and the score of every document (for the near-tie rule)."""
        torch = self.torch
        ranks = list(q.ranks)
        if q.typo >= 0:
            ranks[q.typo] = self.resolve(q.typo_text)
        acc = torch.zeros(self.n, dtype=self.dtype, device=self.device)
        sets = []
        for r in ranks:
            m = torch.zeros(self.n, dtype=torch.bool, device=self.device)
            if r is not None:
                docs, sc = self.term_scores(r)
                m[docs] = True
                acc.index_add_(0, docs, sc)
            sets.append(m)
        if q.form == "and":
            match = sets[0] & sets[1]
            for m in sets[2:]:
                match |= m
        elif q.form == "andnot":
            match = sets[-2] & ~sets[-1]
            for m in sets[:-2]:
                match |= m
        else:
            match = sets[0]
            for m in sets[1:]:
                match |= m
        acc = torch.where(match, acc, torch.zeros_like(acc))
        hits = int(match.sum())
        k = min(limit, hits)
        if k == 0:
            return [], acc
        kth = torch.topk(acc.to(torch.float64), k).values[-1]
        cand = torch.nonzero(match & (acc.to(torch.float64) >= kth))
        cand = cand.flatten().cpu().numpy()
        sc = acc[cand].to(torch.float64).cpu().numpy()
        order = np.lexsort((self.slot[cand], -sc))[:k]
        return [(int(cand[i]) + 1, float(sc[i])) for i in order], acc


def compare(got, want, acc, tol: float) -> tuple[int, float]:
    """(rank misses, widest score gap) of one answer.

    A rank misses where the answer's length differs from the
    reference's (each missing or extra rank counts), or where its id
    differs from the reference's and the reference scores that id more
    than ``tol`` away from its own score at that rank: two documents
    within ``tol`` of each other may stand in either order, as the
    configuration's guarantee allows."""
    misses = abs(len(got) - len(want))
    gap = 0.0
    for (dg, sg), (dw, sw) in zip(got, want):
        gap = max(gap, abs(sg - sw))
        if dg != dw:
            ok = 1 <= dg <= len(acc) and abs(float(acc[dg - 1]) - sw) <= tol
            misses += 0 if ok else 1
    return misses, gap
