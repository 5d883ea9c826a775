"""A configuration's corpus, made from the seed as arrays.

Nothing here imports the engine.  The same seed on the same device
gives the same words, documents and counts, byte for byte.

Words are made so that the engine's default filter pipeline
(normalizer, stopwords, Porter2 stemmer) leaves each one as it is:
lowercase ASCII letters in strict consonant / vowel alternation, no
``y``, and a last letter that ends no Porter2 suffix.  So the engine
indexes exactly the benchmark's words, and the plain reference needs
no stemmer.  A letter swap of two neighbours (the traffic's typo) keeps
the last letter, so a typo passes the filters unchanged too, and it
breaks the alternation, so it is never a word of the vocabulary.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

VOWELS = np.frombuffer(b"aeiou", dtype=np.uint8)
CONSONANTS = np.frombuffer(b"bcdfghjklmnprstvwxz", dtype=np.uint8)
# Porter2 removes or rewrites only suffixes ending in s, d, g, y, i, l,
# r, c, t, m, n or e; none ends in one of these.
FINALS = np.frombuffer(b"bfhjkpvwxz", dtype=np.uint8)
MAX_WORD = 16
DOC_CHUNK = 1 << 20      # documents drawn per generator call


def derive(seed: int, *labels) -> int:
    """A 63-bit seed for one purpose of one run, from the run's seed."""
    h = hashlib.blake2b(repr((int(seed),) + labels).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def make_words(n: int, seed: int, len_min: int = 3, len_max: int = 16,
               len_mean: float = 8.0) -> np.ndarray:
    """``n`` distinct words as uint8 rows [n, MAX_WORD], NUL padded.
    Lengths are len_min + Binomial(len_max - len_min, p), mean len_mean
    before duplicates of the shortest lengths are dropped."""
    rng = np.random.default_rng(derive(seed, "words"))
    p = (len_mean - len_min) / (len_max - len_min)
    have = np.zeros((0, MAX_WORD), dtype=np.uint8)
    while len(have) < n:
        m = int((n - len(have)) * 1.25) + 1024
        lens = len_min + rng.binomial(len_max - len_min, p, m)
        pos = np.arange(MAX_WORD)
        cons = (lens[:, None] - 1 - pos) % 2 == 0
        rows = np.where(cons,
                        CONSONANTS[rng.integers(0, len(CONSONANTS),
                                                (m, MAX_WORD))],
                        VOWELS[rng.integers(0, len(VOWELS), (m, MAX_WORD))])
        rows[np.arange(m), lens - 1] = FINALS[rng.integers(0, len(FINALS),
                                                           m)]
        rows[pos >= lens[:, None]] = 0
        both = np.concatenate([have, rows.astype(np.uint8)])
        _, first = np.unique(np.ascontiguousarray(both).view(
            f"S{MAX_WORD}").ravel(), return_index=True)
        have = both[np.sort(first)]
    return have[:n]


def word_strings(rows: np.ndarray) -> list[str]:
    return [w.decode("ascii") for w in
            np.ascontiguousarray(rows).view(f"S{MAX_WORD}").ravel()]


def word_lengths(rows: np.ndarray) -> np.ndarray:
    return (rows != 0).sum(axis=1).astype(np.int64)


def zipf_probs(vocab: int, offset: float) -> np.ndarray:
    """P(rank r) proportional to 1 / (r + offset)."""
    p = 1.0 / (np.arange(vocab, dtype=np.float64) + offset)
    return p / p.sum()


@dataclass
class Corpus:
    """Documents 1..n_docs (document id = index + 1) as a CSR over
    (document, term rank) pairs, each pair once, ranks ascending
    within a document; ``doc_len`` counts every token, repeats
    included."""
    words: np.ndarray        # uint8 [V, MAX_WORD]
    strings: list            # the words as str, rank order
    doc_len: np.ndarray      # int64 [N]
    doc_ptr: np.ndarray      # int64 [N + 1]
    pair_rank: np.ndarray    # int32 [P]
    pair_count: np.ndarray   # int32 [P]

    @property
    def n_docs(self) -> int:
        return len(self.doc_len)


def doc_chunks(cfg: dict, seed: int, device):
    """Yield (doc_len int64[n], n_pairs int64[n], rank int32[P],
    count int32[P]) on the host, DOC_CHUNK documents at a time, drawn
    on ``device`` with a torch Generator seeded per chunk."""
    import torch

    n_docs, vocab = int(cfg["documents"]), int(cfg["vocabulary"])
    cdf = torch.from_numpy(np.cumsum(zipf_probs(vocab, cfg["zipf_offset"])))
    cdf = cdf.to(device)
    for c, lo in enumerate(range(0, n_docs, DOC_CHUNK)):
        n = min(DOC_CHUNK, n_docs - lo)
        g = torch.Generator(device=device)
        g.manual_seed(derive(seed, "docs", c))
        rate = torch.full((n,), float(cfg["mean_doc_words"]),
                          dtype=torch.float32, device=device)
        lens = torch.poisson(rate, generator=g).to(torch.int64).clamp_(min=1)
        total = int(lens.sum())
        u = torch.rand(total, dtype=torch.float64, device=device,
                       generator=g)
        rank = torch.searchsorted(cdf, u, right=True).clamp_(max=vocab - 1)
        doc = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int64, device=device), lens)
        key, _ = torch.sort(doc * vocab + rank)
        del u, rank, doc
        key, count = torch.unique_consecutive(key, return_counts=True)
        n_pairs = torch.bincount(key // vocab, minlength=n)
        yield (lens.cpu().numpy(), n_pairs.cpu().numpy(),
               (key % vocab).to(torch.int32).cpu().numpy(),
               count.to(torch.int32).cpu().numpy())
        del key, count, lens, n_pairs


def make_corpus(cfg: dict, seed: int, device, on_chunk=None) -> Corpus:
    """The whole corpus; ``on_chunk(first_doc_index, doc_len, n_pairs,
    rank, count)`` sees each chunk as it is drawn (the harness indexes
    it there)."""
    words = make_words(int(cfg["vocabulary"]), seed, cfg["word_len_min"],
                       cfg["word_len_max"], cfg["word_len_mean"])
    strings = word_strings(words)
    lens, nps, ranks, counts = [], [], [], []
    lo = 0
    for dl, npairs, rank, count in doc_chunks(cfg, seed, device):
        if on_chunk is not None:
            on_chunk(lo, dl, npairs, rank, count, strings)
        lo += len(dl)
        lens.append(dl)
        nps.append(npairs)
        ranks.append(rank)
        counts.append(count)
    doc_len = np.concatenate(lens)
    doc_ptr = np.zeros(len(doc_len) + 1, dtype=np.int64)
    np.cumsum(np.concatenate(nps), out=doc_ptr[1:])
    return Corpus(words, strings, doc_len, doc_ptr,
                  np.concatenate(ranks), np.concatenate(counts))
