#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (nxsearch_tpu_torch) on one card.

Drives the port's paths -- BM25 top-10 batch search with fuzzy (typo)
resolution, boolean (AND / NOT) search on the masked sliced route and on
the blockdense route -- at the benchmark's 1M-document tier, through the
entry points a user calls (Nxs, Index.add_many, search_pipelined,
search_many), and checks every hand-written kernel of those paths
against its plain PyTorch twin.  Phases (any failure exits non-zero
and prints no result):

1. card check and kernel build: needs torch.cuda; prints the card's
   name and power limit; builds csrc/*.cu with nvcc (first use), one
   nvcc per source, all started together;
2. kernel phase: the Myers kernel against myers_distances_ref at the
   main path's shape (one chunk of M = 64 typo rows over the length
   band's region, which in the bench vocabulary -- all 200,000 terms
   are 6 bytes -- is W = 200,000 terms), exact equality, both timed
   with CUDA events (median of runs);
3. slice phase: ingest bench.py's 1M tier (zipf_range, vocab 200k,
   mean length 40) into a temporary basedir; after one warm-up pass,
   three passes of search_pipelined over 8192 make_queries queries in
   batches of 2048, each followed by search_many over 512 fresh
   make_fuzzy_queries (medians reported); asserts the snapshot lives on
   the card, that the Myers kernel launched during that run and that both
   the prefix and the sliced executors served rows; checks 64 sampled
   plain and 16 sampled fuzzy queries against a straightforward numpy
   oracle -- Levenshtein over the host's term dictionary for words it
   lacks, BM25 over the host CSR -- (same top-10 ids under the
   lowest-device-slot tie rule, scores within 1e-4);
4. mixed phase: bench.make_mixed_queries (8192 queries: 25 % AND /
   AND NOT rows, 5 % typos) through search_pipelined in batches of
   2048 on the default route, after one warm-up pass; three passes,
   median QPS; asserts masked sliced rows and masked dense-row hybrid
   rows > 0;
5. blockdense phase: 512 masked queries that each hold a dense-row
   term (``d AND a``, ``a b AND NOT d``) through search_many with the
   masked hybrid off (search._MASKED_HYBRID, as NXS_MASKED_HYBRID=0
   sets it), so they take the blockdense route; asserts blockdense rows
   and segsum launches > 0 and every answer equal to the same query on
   the default route (both are exact: same ids up to an adjacent swap
   of scores within 1e-4, scores within 1e-4);
6. segsum phase: the segsum kernel against blockdense_scores_ref at the
   blockdense route's shape (the 64 first blockdense queries: bounds
   rows from the snapshot's cache, 8 terms, every slot, BM25, presence
   bits), scores and bits equal bit for bit, both timed with CUDA
   events;
7. boolean oracle: 64 sampled masked queries of each of phases 4 and 5,
   their parsed query trees walked over per-term document sets of the
   host CSR, BM25 over the matching documents (same tie rule and
   tolerance as phase 3).

The next-to-last lines are the kernel table (JSON) and the card line;
the last line is {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N_DOCS = 1_000_000        # bench.py's 1M tier, not cut
VOCAB = 200_000
MEAN_LEN = 40
KERNEL_M, KERNEL_W = 64, VOCAB
FUZZY_TOL = 2
N_QUERIES = 8192
BATCH = 2048
N_FUZZY = 512
N_ORACLE = 64
N_FUZZY_ORACLE = 16
N_MIXED = 8192
N_BD = 512
N_SEGSUM = 64           # blockdense queries in the segsum kernel phase
N_BOOL_ORACLE = 64      # per masked phase
PASSES = 3              # measured passes (median reported)
TOL = 1e-4               # score tolerance of the reference's own tests


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, runs: int) -> float:
    """Median device time of ``fn`` over ``runs`` calls (CUDA events)."""
    import torch
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2]


def kernel_phase(seed: int = 0) -> dict:
    """Myers kernel vs its plain twin at the main path's shape."""
    import numpy as np
    import torch

    from nxsearch_tpu_torch.ops import kernels

    m_q, w = KERNEL_M, KERNEL_W
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefgh", dtype=np.uint8)
    vl = rng.integers(1, 33, size=w).astype(np.int32)
    vb = alphabet[rng.integers(0, len(alphabet), size=(w, 32))]
    vb[np.arange(32)[None, :] >= vl[:, None]] = 0
    ql = rng.integers(1, 33, size=m_q).astype(np.int32)
    ql[0], ql[1] = 32, 0                  # full-width row, q_len 0 row
    qb = alphabet[rng.integers(0, len(alphabet), size=(m_q, 32))]
    qb[np.arange(32)[None, :] >= ql[:, None]] = 0
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev) for a in (vb, vl, qb, ql)]

    out_k = kernels.myers_distances(*args)
    out_r = kernels.myers_distances_ref(*args)
    torch.cuda.synchronize()
    max_err = int((out_k - out_r).abs().max())
    if not torch.equal(out_k, out_r):
        raise AssertionError(
            f"Myers kernel disagrees with its twin: max |diff| {max_err}")
    kernel_ms = cuda_time_ms(lambda: kernels.myers_distances(*args), 21)
    plain_ms = cuda_time_ms(lambda: kernels.myers_distances_ref(*args), 5)
    log(f"kernel phase: myers M={m_q} W={w}: exact; kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms}


def oracle_top(csr, host, term_ids, dev_rank, limit: int):
    """Straightforward numpy BM25 top-k over the host CSR (f64): scores
    summed per live document, ties to the lowest device slot.  Returns
    (top ids, top scores, every slot's score)."""
    import numpy as np

    n_slots = len(csr["doc_len"])
    doc_count = host.doc_count
    adl = float(host.token_count // doc_count)
    acc = np.zeros(n_slots, dtype=np.float64)
    dl = csr["doc_len"].astype(np.float64)
    for t in term_ids:
        lo, hi = int(csr["term_starts"][t - 1]), int(csr["term_starts"][t])
        slots = csr["postings_slot"][lo:hi]
        if not len(slots):
            continue
        df = int(host.term_df.a[t - 1])
        idf = np.log((doc_count - df + 0.5) / (df + 0.5) + 1.0)
        ltf = np.log(csr["postings_tf"][lo:hi].astype(np.float64) + 1.0)
        acc[slots] += ltf / (ltf + 1.2 * (0.25 + 0.75 * dl[slots] / adl)) \
            * idf
    acc[~csr["doc_alive"]] = 0.0
    hit = np.nonzero(acc > 0.0)[0]
    order = np.lexsort((dev_rank[hit], -acc[hit]))[:limit]
    return csr["doc_ids"][hit[order]], acc[hit[order]], acc


def check_against_oracle(resp, ids_o, scores_o, acc, slot_of_id, q):
    ids_p = [d for d, _ in resp.results]
    sc_p = [s for _, s in resp.results]
    if len(ids_p) != len(ids_o):
        raise AssertionError(f"{q!r}: {len(ids_p)} results, oracle "
                             f"{len(ids_o)}")
    for i, (dp, do) in enumerate(zip(ids_p, ids_o)):
        if abs(sc_p[i] - scores_o[i]) > TOL:
            raise AssertionError(f"{q!r} rank {i}: score {sc_p[i]} vs "
                                 f"oracle {scores_o[i]}")
        # Ids agree, or rank i holds a near-tie of the oracle's doc (f32
        # on the card vs f64 here may order scores 1 ulp apart).
        if dp != do and abs(acc[slot_of_id[dp]] - scores_o[i]) > TOL:
            raise AssertionError(f"{q!r} rank {i}: doc {dp} vs oracle "
                                 f"{do}")


def fuzzy_oracle(host, by_len, q: bytes):
    """Term id of the most popular term within FUZZY_TOL edits of ``q``
    (ties to the lowest id), or None: Wagner-Fischer in numpy, one
    vectorized DP per term length of the band."""
    import numpy as np

    totals = host.term_total.view()
    best_total, best_id = 0, None
    for n in range(max(1, len(q) - FUZZY_TOL), len(q) + FUZZY_TOL + 1):
        if n not in by_len:
            continue
        ids, rows = by_len[n]                      # int64[k], u8[k, n]
        prev = np.tile(np.arange(n + 1), (len(ids), 1))
        for i, c in enumerate(q, 1):
            cur = np.empty_like(prev)
            cur[:, 0] = i
            cost = (rows != c).astype(np.int64)
            for j in range(1, n + 1):
                cur[:, j] = np.minimum(np.minimum(
                    prev[:, j] + 1, cur[:, j - 1] + 1),
                    prev[:, j - 1] + cost[:, j - 1])
            prev = cur
        hit = ids[(prev[:, n] <= FUZZY_TOL) & (totals[ids] > 0)]
        for t in hit[np.lexsort((hit, -totals[hit].astype(np.int64)))][:1]:
            if totals[t] > best_total or (totals[t] == best_total
                                          and t + 1 < best_id):
                best_total, best_id = int(totals[t]), int(t) + 1
    return best_id


def ingest(workdir: str):
    """Index bench.py's 1M tier with Index.add_many on the card:
    (nxs, idx, ingest seconds)."""
    import bench
    from nxsearch_tpu_torch import Nxs
    from nxsearch_tpu_torch.utils.malloc import tune_host_allocator

    tune_host_allocator(prefault_mb=min(
        24_576, max(512, N_DOCS * MEAN_LEN * 24 >> 20)))
    nxs = Nxs(workdir, device="cuda")
    idx = nxs.index_create("bench")
    t0 = time.perf_counter()
    for base in range(0, N_DOCS, bench._ZIPF_BLOCK):
        idx.add_many(bench.zipf_range(
            base, min(base + bench._ZIPF_BLOCK, N_DOCS), VOCAB, MEAN_LEN))
    ingest_s = time.perf_counter() - t0
    log(f"ingest: {N_DOCS} docs in {ingest_s:.1f} s")
    return nxs, idx, ingest_s


def vocab():
    """bench.py's vocabulary and its Zipf term probabilities."""
    import numpy as np

    ranks = np.arange(VOCAB, dtype=np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    return np.array([f"w{i:05d}" for i in range(VOCAB)]), probs


def workload():
    """bench.py's query mix: (queries, batches of BATCH, four sets of
    N_FUZZY typo queries with distinct salts)."""
    import numpy as np

    import bench

    words, probs = vocab()
    rng = np.random.default_rng(42)
    queries = bench.make_queries(N_QUERIES, words, probs, rng)
    batches = [queries[i: i + BATCH] for i in range(0, N_QUERIES, BATCH)]
    # Fuzzy resolutions are memoized per index generation, so every
    # pass draws fresh typo tokens (salt letters other than "w").
    fuzzy = [bench.make_fuzzy_queries(N_FUZZY, words, probs, rng, salt)
             for salt in "xyzv"]
    return queries, batches, fuzzy


class HostOracle:
    """The host CSR in host slot order and what the oracles need
    beside it: each slot's rank in device order (the tie rule), the
    slot of each doc id, and the term dictionary by byte length."""

    def __init__(self, idx):
        import numpy as np

        self.idx = idx
        self.host = host = idx.host
        self.csr = csr = host.build_csr()
        dl_host = np.asarray(csr["doc_len"][: host.doc_ids.n],
                             dtype=np.float32)
        self.dev_rank = np.empty(len(dl_host), dtype=np.int64)
        self.dev_rank[np.argsort(dl_host, kind="stable")] = \
            np.arange(len(dl_host))
        self.slot_of_id = {int(d): s for s, d in enumerate(csr["doc_ids"])}
        encoded = [v.encode("utf-8") for v in host.term_values]
        self.by_len = {}
        for n in {len(e) for e in encoded}:
            ids = np.array([i for i, e in enumerate(encoded) if len(e) == n])
            self.by_len[n] = (ids, np.frombuffer(
                b"".join(encoded[i] for i in ids),
                dtype=np.uint8).reshape(-1, n))
        self.n_typos = 0

    def resolve(self, value: str):
        """Term id of a raw query word: the pipeline's filtered form in
        the dictionary, else its numpy Levenshtein match, else None."""
        f = self.idx.pipeline.run(value)
        if f is None:
            return None
        t = self.host.term_lookup(f)
        if t is None:
            t = fuzzy_oracle(self.host, self.by_len, f.encode("utf-8"))
            self.n_typos += t is not None
        return t

    def check_plain(self, q, resp):
        tids = []
        for v in q.split():
            t = self.resolve(v)
            if t is not None and t not in tids:
                tids.append(t)
        ids_o, sc_o, acc = oracle_top(self.csr, self.host, tids,
                                      self.dev_rank, 10)
        check_against_oracle(resp, ids_o, sc_o, acc, self.slot_of_id, q)

    def check_boolean(self, q, resp):
        """Walk the parsed query tree over per-term document sets (AND
        intersects, OR unites, NOT subtracts, an unresolved word is the
        empty set), then BM25 over the matching documents."""
        import numpy as np

        from nxsearch_tpu_torch.query.ast import (EXPR_OP_AND, EXPR_OP_OR,
                                                  EXPR_VAL_TOKEN)
        from nxsearch_tpu_torch.query.parser import parse_query

        csr = self.csr
        n_slots = len(csr["doc_len"])
        tids = []

        def docs(expr):
            if expr.type == EXPR_VAL_TOKEN:
                out = np.zeros(n_slots, dtype=np.bool_)
                t = self.resolve(expr.value)
                if t is not None:
                    if t not in tids:
                        tids.append(t)
                    lo, hi = csr["term_starts"][t - 1], csr["term_starts"][t]
                    out[csr["postings_slot"][lo:hi]] = True
                return out
            left, right = (docs(e) for e in expr.elements)
            if expr.type == EXPR_OP_AND:
                return left & right
            if expr.type == EXPR_OP_OR:
                return left | right
            return left & ~right                   # NOT: L AND NOT R

        match = docs(parse_query(q))
        _ids, _sc, acc = oracle_top(csr, self.host, tids, self.dev_rank, 10)
        acc = np.where(match, acc, 0.0)
        hit = np.nonzero(acc > 0.0)[0]
        order = np.lexsort((self.dev_rank[hit], -acc[hit]))[:10]
        check_against_oracle(resp, csr["doc_ids"][hit[order]],
                             acc[hit[order]], acc, self.slot_of_id, q)


def slice_phase(idx, sp, ingest_s: float, oracle: HostOracle) -> dict:
    import numpy as np
    import torch

    from nxsearch_tpu_torch import search as search_mod
    from nxsearch_tpu_torch.ops import kernels

    dev = idx.dev
    queries, batches, fuzzy = workload()
    # Warm-up (allocator, pinned buffers, fuzzy snapshot upload).
    idx.search_pipelined(batches, sp)
    idx.search_many(fuzzy[0], sp)
    torch.cuda.synchronize()

    # The measured main-path run: counters from zero.
    reset_counts()
    qps_samples, fz_samples = [], []
    for p in range(PASSES):
        t0 = time.perf_counter()
        out = idx.search_pipelined(batches, sp)
        qps_samples.append(N_QUERIES / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        fz_out = idx.search_many(fuzzy[1 + p], sp)
        fz_samples.append(N_FUZZY / (time.perf_counter() - t0))
        if p == 0:                # the first pass's answers are checked
            results, fz_results = out, fz_out
    launches = {"myers_distances": kernels.MYERS.launches}
    stats = dict(sorted(search_mod.EXEC_STATS.items()))
    qps = float(np.median(qps_samples))
    fz_qps = float(np.median(fz_samples))
    log(f"search_pipelined ({N_QUERIES} queries, batches of {BATCH}): "
        f"median {qps:.1f} QPS of {[round(x, 1) for x in qps_samples]}; "
        f"fuzzy search_many ({N_FUZZY} queries): median {fz_qps:.1f} QPS "
        f"of {[round(x, 1) for x in fz_samples]}")
    log(f"exec stats: {stats}; kernel launches: {launches}")

    fz = idx._fuzzy
    on_card = {"postings_pack": dev.postings_pack, "doc_len": dev.doc_len,
               "alive_mask": dev.alive_mask, "dense_rows": dev.dense_rows,
               "fuzzy vocab": fz._dev_bytes if fz else None}
    for name, t in on_card.items():
        if t is None or not t.is_cuda:
            raise AssertionError(f"snapshot tensor {name} is not on the "
                                 "card")
    if launches["myers_distances"] <= 0:
        raise AssertionError("the Myers kernel never launched on the "
                             "main path")
    if stats.get("prefix", 0) <= 0 or stats.get("sliced", 0) <= 0:
        raise AssertionError(f"prefix and sliced rows expected: {stats}")
    if len(results) != len(batches) or len(fz_results) != N_FUZZY:
        raise AssertionError("missing responses")
    check_finite([r for b in results for r in b])

    # Oracle check of sampled queries.  Words the dictionary lacks
    # resolve through the numpy Levenshtein oracle, so the fuzzy
    # answers are checked independently of the kernel.
    flat = [r for b in results for r in b]
    rng = np.random.default_rng(7)
    sample = ([(queries[int(i)], flat[int(i)]) for i in
               rng.choice(N_QUERIES, N_ORACLE, replace=False)]
              + [(fuzzy[1][int(i)], fz_results[int(i)]) for i in
                 rng.choice(N_FUZZY, N_FUZZY_ORACLE, replace=False)])
    oracle.n_typos = 0
    for q, resp in sample:
        oracle.check_plain(q, resp)
    if oracle.n_typos < N_FUZZY_ORACLE:
        raise AssertionError(f"only {oracle.n_typos} typo tokens resolved")
    log(f"oracle: {N_ORACLE} plain and {N_FUZZY_ORACLE} fuzzy sampled "
        f"queries agree ({oracle.n_typos} typo tokens resolved)")
    return {"qps": qps, "fuzzy_qps": fz_qps, "qps_samples": qps_samples,
            "fuzzy_qps_samples": fz_samples, "launches": launches,
            "stats": stats}


def reset_counts() -> None:
    """Every kernel's launch count and the route counters to 0."""
    from nxsearch_tpu_torch import search as search_mod
    from nxsearch_tpu_torch.ops import kernels

    kernels.MYERS.launches = 0
    kernels.SEGSUM.launches = 0
    search_mod.EXEC_STATS.clear()


def check_finite(responses) -> None:
    import numpy as np

    n_hits = sum(len(r.results) for r in responses)
    if n_hits == 0 or not all(np.isfinite(s) for r in responses
                              for _, s in r.results):
        raise AssertionError("empty or non-finite results")


def mixed_phase(idx, sp) -> dict:
    """bench's mixed trace on the default route (masked sliced rows,
    masked dense-row hybrid rows)."""
    import numpy as np
    import torch

    import bench
    from nxsearch_tpu_torch import search as search_mod
    from nxsearch_tpu_torch.ops import kernels

    words, probs = vocab()
    queries = bench.make_mixed_queries(N_MIXED, words, probs,
                                       np.random.default_rng(43))
    batches = [queries[i: i + BATCH] for i in range(0, N_MIXED, BATCH)]
    idx.search_pipelined(batches, sp)           # warm-up
    torch.cuda.synchronize()
    reset_counts()
    samples = []
    for p in range(PASSES):
        t0 = time.perf_counter()
        out = idx.search_pipelined(batches, sp)
        samples.append(N_MIXED / (time.perf_counter() - t0))
        if p == 0:
            results = [r for b in out for r in b]
    stats = dict(sorted(search_mod.EXEC_STATS.items()))
    # Typos resolved by the warm-up stay cached, so the measured passes
    # may launch no kernel at all; reported, not asserted.
    launches = {"myers_distances": kernels.MYERS.launches,
                "blockdense_scores": kernels.SEGSUM.launches}
    qps = float(np.median(samples))
    n_masked = sum(" AND " in q for q in queries)
    log(f"mixed search_pipelined ({N_MIXED} queries, {n_masked} masked, "
        f"batches of {BATCH}): median {qps:.1f} QPS of "
        f"{[round(x, 1) for x in samples]}")
    log(f"mixed route split: {stats}; kernel launches: {launches}")
    if (stats.get("sliced_masked", 0) <= 0
            or stats.get("sliced_masked_rows", 0) <= 0):
        raise AssertionError(f"masked sliced and masked-hybrid rows "
                             f"expected: {stats}")
    if len(results) != N_MIXED:
        raise AssertionError("missing responses")
    check_finite(results)
    return {"qps": qps, "qps_samples": samples, "stats": stats,
            "launches": launches, "queries": queries, "results": results}


def bd_queries(idx) -> list[str]:
    """N_BD masked queries, each holding a dense-row term d: ``d AND a``
    and ``a b AND NOT d`` with a, b from the mixed trace's word mix."""
    import numpy as np

    words, probs = vocab()
    qp = probs ** 0.35
    qp /= qp.sum()
    values = idx.host.term_values
    dense = [values[t - 1] for t in sorted(idx.dev.dense_row_of)]
    if not dense:
        raise AssertionError("the snapshot has no dense rows")
    rng = np.random.default_rng(44)
    out = []
    for i in range(N_BD):
        d = dense[int(rng.integers(0, len(dense)))]
        a, b = (str(w) for w in words[rng.choice(len(words), 2, p=qp)])
        out.append(f"{d} AND {a}" if i % 2 == 0 else f"{a} {b} AND NOT {d}")
    return out


def same_answer(ref, got, q) -> None:
    """Ids identical in order except an adjacent swap of scores within
    TOL; scores within TOL."""
    ids_r = [d for d, _ in ref.results]
    sc_r = [s for _, s in ref.results]
    ids_g = [d for d, _ in got.results]
    sc_g = [s for _, s in got.results]
    if len(ids_g) != len(ids_r) or any(abs(a - b) > TOL
                                       for a, b in zip(sc_g, sc_r)):
        raise AssertionError(f"{q!r}: {list(zip(ids_g, sc_g))} vs "
                             f"{list(zip(ids_r, sc_r))}")
    i = 0
    while i < len(ids_g):
        if ids_g[i] != ids_r[i]:
            if not (i + 1 < len(ids_g) and ids_g[i] == ids_r[i + 1]
                    and ids_g[i + 1] == ids_r[i]
                    and abs(sc_r[i] - sc_r[i + 1]) <= TOL):
                raise AssertionError(f"{q!r} rank {i}: {ids_g} vs {ids_r}")
            i += 1
        i += 1


def bd_phase(idx, sp) -> dict:
    """Masked queries with dense-row terms on the blockdense route (the
    masked hybrid off), held to the default route's answers."""
    import torch

    from nxsearch_tpu_torch import search as search_mod
    from nxsearch_tpu_torch.ops import kernels

    queries = bd_queries(idx)
    search_mod._MASKED_HYBRID = False
    try:
        idx.search_many(queries[:64], sp)       # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got = idx.search_many(queries, sp)
        qps = N_BD / (time.perf_counter() - t0)
        launches = kernels.SEGSUM.launches
        stats = dict(sorted(search_mod.EXEC_STATS.items()))
    finally:
        search_mod._MASKED_HYBRID = True
    log(f"blockdense search_many ({N_BD} queries): {qps:.1f} QPS; route "
        f"split {stats}; segsum launches {launches}")
    if stats.get("blockdense", 0) <= 0 or launches <= 0:
        raise AssertionError(f"blockdense rows and segsum launches "
                             f"expected: {stats}, {launches}")
    want = idx.search_many(queries, sp)         # the default route
    for q, w, g in zip(queries, want, got):
        same_answer(w, g, q)
    check_finite(got)
    log(f"blockdense route: {N_BD} answers equal the default route's")
    return {"qps": qps, "stats": stats, "launches": launches,
            "queries": queries, "results": got}


def segsum_phase(idx, queries: list[str]) -> dict:
    """The segsum kernel against its plain twin at the blockdense
    route's shape: the first N_SEGSUM blockdense queries' kernel terms
    (bounds rows from the snapshot's cache), every slot, BM25."""
    import numpy as np
    import torch

    from nxsearch_tpu_torch import Params
    from nxsearch_tpu_torch import search as search_mod
    from nxsearch_tpu_torch.ops import executor, kernels

    dev = idx.dev
    sp = search_mod.get_search_params(idx.algo,
                                      Params().set_uint("limit", 10))
    prepared = search_mod._prepare_many(dev, idx.pipeline,
                                        queries[:N_SEGSUM], sp)
    plans = search_mod._build_plans(dev, prepared, sp)
    if any(p is None or not p.use_mask for p in plans):
        raise AssertionError("segsum phase: every query must plan masked")
    q_crow = np.stack([search_mod._kernel_crows(dev, p) for p in plans])
    q_idf = np.stack([p.q_idf for p in plans])
    bounds = dev._bounds_cache[torch.from_numpy(q_crow).to(
        dev.device, torch.int64)].contiguous()
    c2 = np.float32(1.2 * 0.75) / np.float32(max(dev.adl, 1e-9))
    coef = np.stack([q_idf, np.full_like(q_idf, np.float32(1.2 * 0.25)),
                     np.full_like(q_idf, c2), np.zeros_like(q_idf)], axis=2)
    args = (dev.postings_slot, dev.postings_ltf, dev.doc_len,
            executor.alive_factors(dev.alive_mask), bounds,
            torch.from_numpy(coef).to(dev.device))

    def kernel():
        return kernels.blockdense_scores(*args, algo=0, use_mask=True)

    def plain():
        return kernels.blockdense_scores_ref(*args, algo=0, use_mask=True)

    got_s, got_b = kernel()
    want_s, want_b = plain()
    torch.cuda.synchronize()
    max_err = float((got_s - want_s).abs().max())
    if not (torch.equal(got_s, want_s) and torch.equal(got_b, want_b)):
        raise AssertionError(
            f"segsum kernel disagrees with its twin: max |diff| {max_err}, "
            f"{int((got_b != want_b).sum())} bit words differ")
    if not bool((want_s > 0).any()):
        raise AssertionError("segsum phase scored nothing")
    kernel_ms = cuda_time_ms(kernel, 21)
    plain_ms = cuda_time_ms(plain, 5)
    n_post = int((bounds[:, :, -1] - bounds[:, :, 0]).sum())
    log(f"segsum phase: N={bounds.shape[0]} Q={bounds.shape[1]} "
        f"S={dev.n_slots} ({n_post} postings): scores and bits exact; "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms}


def boolean_oracle(oracle: HostOracle, mixed: dict, bd: dict) -> None:
    import numpy as np

    rng = np.random.default_rng(8)
    n = 0
    for phase in (mixed, bd):
        masked = [i for i, q in enumerate(phase["queries"]) if " AND " in q]
        for i in rng.choice(masked, N_BOOL_ORACLE, replace=False):
            oracle.check_boolean(phase["queries"][int(i)],
                                 phase["results"][int(i)])
            n += 1
    log(f"boolean oracle: {n} sampled masked queries agree")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is "
            "false)")
        return 1
    sys.path.insert(0, ROOT)
    from concurrent.futures import ThreadPoolExecutor

    from nxsearch_tpu_torch import Params
    from nxsearch_tpu_torch.ops import kernels

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda k: k.build(), (kernels.MYERS, kernels.SEGSUM)))
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")

    kern = kernel_phase()
    sp = Params().set_uint("limit", 10)
    with tempfile.TemporaryDirectory() as workdir:
        nxs, idx, ingest_s = ingest(workdir)
        try:
            t0 = time.perf_counter()
            idx.search("w00001", sp)    # first search builds the snapshot
            torch.cuda.synchronize()
            snapshot_s = time.perf_counter() - t0
            dev = idx.dev
            log(f"snapshot build: {snapshot_s:.1f} s, {dev.n_postings} "
                f"padded postings, {dev.dense_rows.shape[0]} dense rows, "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                "allocated")
            oracle = HostOracle(idx)
            sl = slice_phase(idx, sp, ingest_s, oracle)
            mixed = mixed_phase(idx, sp)
            bd = bd_phase(idx, sp)
            seg = segsum_phase(idx, bd["queries"])
            boolean_oracle(oracle, mixed, bd)
        finally:
            nxs.close()
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    log(json.dumps({
        "slice": {k: sl[k] for k in ("qps", "qps_samples", "fuzzy_qps",
                                     "fuzzy_qps_samples", "stats")},
        "mixed": {k: mixed[k] for k in ("qps", "qps_samples", "stats",
                                        "launches")},
        "blockdense": {k: bd[k] for k in ("qps", "stats", "launches")},
        "snapshot_s": snapshot_s, "ingest_s": ingest_s, "docs": N_DOCS}))

    print(json.dumps({"kernels": [{
        "name": "myers_distances", "route": "cuda",
        "source": "nxsearch_tpu_torch/csrc/myers.cu",
        "replaces": "nxsearch_tpu/ops/pallas/fuzzy.py:52",
        "launches": sl["launches"]["myers_distances"],
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"]}, {
        "name": "blockdense_scores", "route": "cuda",
        "source": "nxsearch_tpu_torch/csrc/segsum.cu",
        "replaces": "nxsearch_tpu/ops/pallas/segsum.py:162",
        "launches": bd["launches"],
        "max_abs_err": seg["max_abs_err"], "ms": seg["ms"],
        "plain_ms": seg["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
