#!/usr/bin/env python3
"""Benchmark of the PyTorch / CUDA port: BM25 top-10 search QPS
on bench.py's synthetic corpus, through nxsearch_tpu_torch.

The port's counterpart of bench.py and, with ``--build-only``, of
tools/build_corpus.py.  Same options, tier rule, corpus cache, traffic
and JSON line as bench.py: the 8.8M-document north-star tier (vocab
1,000,000, mean length 60) when its cached corpus exists, else the 1M
tier; ``.bench_cache/d{docs}-v{vocab}-l{len}-s42`` holds a built
corpus (both packages read one index format, so one cached corpus
serves both); a warm-up pass, 3-6 ``search_pipelined`` passes (a pass
is added while their spread exceeds 20 %), two sequential passes of 64
``Index.search`` calls and the 512-typo fuzzy tier with its 16-query
p50.  Beside bench.py's ``detail`` fields the line carries what a port
must say: the device (the card's name and power limit, as nvidia-smi
gives them), the seconds to open the index and to build its device
snapshot, the snapshot's device bytes, peak device memory and the
process's peak host RSS.

``--device`` defaults to ``cuda``, which raises where no card is
present; ``--device cpu`` runs on the CPU.  A fresh build indexes with
one writer (``Index.add_many`` in document order, the texts made by
GEN_WORKERS spawned processes) or, with ``--ingest-workers N``, with N
writer processes (``parallel_ingest``); either way into
``<key>.partial``, renamed to the cache key only once checkpointed, so
a build that is cut never looks like a cached corpus.

Usage: python3 bench_torch.py [--docs N] [--vocab N] [--mean-len N]
           [--queries N] [--batch N] [--limit N] [--mixed] [--verbose]
           [--no-cache] [--ingest-workers N] [--device cuda|cpu]
           [--build-only]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from bench import (make_fuzzy_queries, make_mixed_queries,  # noqa: E402
                   make_queries, zipf_range)

CACHE_ROOT = os.path.join(ROOT, ".bench_cache")
NORTH_STAR = (8_800_000, 1_000_000, 60)   # docs, vocab, mean length
DEFAULT_TIER = (1_000_000, 200_000, 40)
GEN_WORKERS = 8        # text generators of a one-writer build
GEN_CHUNK = 1 << 17    # documents per add_many call of such a build


def cache_key(docs: int, vocab: int, mean_len: int) -> str:
    return f"d{docs}-v{vocab}-l{mean_len}-s42"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=0,
                    help="0 = auto: the 8.8M north-star tier when its "
                         "corpus cache exists, else the 1M tier")
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--mean-len", type=int, default=0)
    ap.add_argument("--queries", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--limit", type=int, default=10)
    ap.add_argument("--mixed", action="store_true",
                    help="boolean + fuzzy trace mix instead of ranked OR")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--no-cache", action="store_true",
                    help="always rebuild the corpus index")
    ap.add_argument("--ingest-workers", type=int, default=1,
                    help="fresh builds: N parallel writer processes "
                         "(nxsearch_tpu_torch.parallel_ingest)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: cuda)")
    ap.add_argument("--build-only", action="store_true",
                    help="build and cache the tier's corpus, then exit "
                         "without searching (tools/build_corpus.py)")
    args = ap.parse_args(argv)
    if not args.docs:
        # Auto tier, as bench.py: the north-star corpus when cached.
        north = os.path.join(CACHE_ROOT, cache_key(*NORTH_STAR), "data",
                             "bench")
        args.docs, args.vocab, args.mean_len = (
            NORTH_STAR if os.path.isdir(north) else DEFAULT_TIER)
    args.vocab = args.vocab or max(args.docs // 5, 1000)
    args.mean_len = args.mean_len or 40
    return args


def tune_allocator(docs: int, mean_len: int) -> None:
    """bench.enable_compile_cache's host half: the glibc tuning and a
    prefault arena sized to the tier (snapshot open allocates about
    12 B a posting of fresh memory; an arena not sized to the tier made
    the 8.8M-document open take 266 s instead of 17 s on the
    reference's host)."""
    from nxsearch_tpu_torch.utils.malloc import tune_host_allocator

    postings_mb = docs * mean_len * 12 >> 20
    tune_host_allocator(
        prefault_mb=min(24_576, max(512, int(postings_mb * 2.0) + 1024)))


def add_zipf(idx, n_docs: int, vocab: int, mean_len: int, *,
             workers: int = GEN_WORKERS, chunk: int = GEN_CHUNK) -> float:
    """bench.zipf_range documents [0, n_docs) into ``idx`` by one
    writer: Index.add_many in document order, ``chunk`` documents a
    call, the texts made ahead by min(workers, cpus) spawned processes
    (a window of 2 chunks per process); returns the seconds."""
    import collections
    import functools
    import itertools
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    gen = functools.partial(zipf_range, vocab=vocab, mean_len=mean_len)
    ranges = iter([(lo, min(lo + chunk, n_docs))
                   for lo in range(0, n_docs, chunk)])
    workers = min(workers, os.cpu_count() or 1, -(-n_docs // chunk))
    t0 = time.perf_counter()
    if workers <= 1:
        for lo, hi in ranges:
            idx.add_many(gen(lo, hi))
        return time.perf_counter() - t0
    with ProcessPoolExecutor(workers,
                             mp_context=mp.get_context("spawn")) as pool:
        ahead = collections.deque(pool.submit(gen, *r) for r in
                                  itertools.islice(ranges, 2 * workers))
        while ahead:
            docs = ahead.popleft().result()
            nxt = next(ranges, None)
            if nxt is not None:
                ahead.append(pool.submit(gen, *nxt))
            idx.add_many(docs)
    return time.perf_counter() - t0


def build_corpus(basedir: str, args, log) -> float:
    """Index the tier's corpus into ``basedir`` (through
    ``<basedir>.partial``, renamed once checkpointed); host work only,
    every handle on the CPU.  Returns the ingest seconds."""
    import functools

    from nxsearch_tpu_torch import Nxs, parallel_ingest

    partial = basedir + ".partial"
    shutil.rmtree(partial, ignore_errors=True)
    os.makedirs(partial)
    nxs = Nxs(partial, device="cpu")
    try:
        idx = nxs.index_create("bench")
        if args.ingest_workers > 1:
            nxs.close()
            t0 = time.perf_counter()
            parallel_ingest(partial, "bench", functools.partial(
                zipf_range, vocab=args.vocab, mean_len=args.mean_len),
                args.docs, workers=args.ingest_workers)
            ingest_s = time.perf_counter() - t0
            nxs = Nxs(partial, device="cpu")
            idx = nxs.index_open("bench")
        else:
            ingest_s = add_zipf(idx, args.docs, args.vocab, args.mean_len)
        log(f"indexed {args.docs} docs in {ingest_s:.1f}s "
            f"({args.docs / ingest_s:.0f} docs/s, "
            f"{args.ingest_workers} writer(s))")
        t0 = time.perf_counter()
        idx.checkpoint()
        log(f"checkpoint in {time.perf_counter() - t0:.1f}s")
    finally:
        nxs.close()
    shutil.rmtree(basedir, ignore_errors=True)
    os.rename(partial, basedir)
    return ingest_s


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def snapshot_bytes(dev) -> dict:
    """Device bytes of the snapshot's tensors, by name, and their sum."""
    tensors = {"postings_pack": dev.postings_pack, "doc_len": dev.doc_len,
               "alive_mask": dev.alive_mask, "dense_rows": dev.dense_rows,
               "slot_column": dev._slot_exact}
    out = {k: t.numel() * t.element_size() for k, t in tensors.items()
           if t is not None}
    out["total"] = sum(out.values())
    return out


def peak_rss() -> int:
    """This process's peak resident set in bytes: VmHWM, which starts
    afresh at exec (ru_maxrss carries the peak of the process that
    forked it across fork and exec), else ru_maxrss."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def measure(idx, queries, args, words, probs, rng, log) -> dict:
    """bench.py's measured traffic on an open index: the warm-up pass
    and prewarm, pipelined passes, sequential latency and the fuzzy
    tier.  Returns bench.py's timing fields of ``detail``."""
    from nxsearch_tpu_torch import Params

    sp = Params().set_uint("limit", args.limit)
    batches = [queries[i: i + args.batch]
               for i in range(0, len(queries), args.batch)]

    t0 = time.perf_counter()
    for batch in batches:
        idx.search_many(batch, sp)
    idx.prewarm(sp, rows=(1, 64, 512))
    log(f"warmup pass in {time.perf_counter() - t0:.1f}s")

    samples: list[float] = []
    passes, max_passes = 3, 6
    while len(samples) < passes:
        t0 = time.perf_counter()
        idx.search_pipelined(batches, sp)
        elapsed = time.perf_counter() - t0
        samples.append(len(queries) / elapsed)
        log(f"pipelined ({args.batch}/batch x {len(batches)}): "
            f"{len(queries)} queries in {elapsed:.2f}s "
            f"-> {len(queries) / elapsed:.0f} QPS")
        spread = (max(samples) - min(samples)) / max(samples)
        if len(samples) == passes and passes < max_passes \
                and spread > 0.2:
            log(f"pass spread {spread:.0%} > 20%: adding a pass")
            passes += 1
    qps = max(samples)

    # Two sequential passes over the same queries: the first absorbs
    # first-of-their-shape costs (the cold tail), the second is warm.
    n_seq = min(64, len(queries))

    def seq_pass():
        lat = []
        for q in queries[:n_seq]:
            t0 = time.perf_counter()
            idx.search(q, sp)
            lat.append(time.perf_counter() - t0)
        return np.sort(np.asarray(lat)) * 1e3

    cold_ms = seq_pass()
    lat_ms = seq_pass()
    p50 = float(lat_ms[int(0.50 * (n_seq - 1))])
    p99 = float(lat_ms[int(0.99 * (n_seq - 1))])
    n_cold = int((cold_ms > 5.0 * max(p50, 1e-3)).sum())
    cold_max = float(cold_ms[-1])
    log(f"sequential: {n_seq} queries, warm p50 {p50:.1f} ms, "
        f"warm p99 {p99:.1f} ms; first pass {n_cold} cold events, "
        f"max {cold_max:.0f} ms")

    # Fuzzy tier: fresh typo tokens per pass (resolutions are
    # memoized); pass "x" warms, "y" is measured, "z" one at a time.
    n_fz = 512
    for salt in ("x", "y"):
        fq = make_fuzzy_queries(n_fz, words, probs, rng, salt)
        t0 = time.perf_counter()
        idx.search_many(fq, sp)
        fz_el = time.perf_counter() - t0
    fz_qps = n_fz / fz_el
    lat = []
    for q in make_fuzzy_queries(16, words, probs, rng, "z"):
        t0 = time.perf_counter()
        idx.search(q, sp)
        lat.append(time.perf_counter() - t0)
    fz_p50 = float(np.median(lat)) * 1e3
    log(f"fuzzy: batched {fz_qps:.0f} QPS, sequential p50 {fz_p50:.1f} ms")
    return {"samples": samples, "qps": qps, "p50": p50, "p99": p99,
            "n_cold": n_cold, "cold_max": cold_max, "fz_qps": fz_qps,
            "fz_p50": fz_p50}


def main(argv=None) -> int:
    args = parse_args(argv)

    def log(msg):
        if args.verbose:
            print(msg, file=sys.stderr, flush=True)

    tune_allocator(args.docs, args.mean_len)
    basedir = os.path.join(CACHE_ROOT, cache_key(args.docs, args.vocab,
                                                 args.mean_len))
    if args.no_cache:
        shutil.rmtree(basedir, ignore_errors=True)
    fresh = not os.path.isdir(os.path.join(basedir, "data", "bench"))
    if args.build_only:
        ingest_s = build_corpus(basedir, args, log) if fresh else None
        print(json.dumps({"cache": basedir, "built": fresh,
                          "docs": args.docs, "vocab": args.vocab,
                          "mean_len": args.mean_len, "ingest_s": ingest_s,
                          "ingest_workers": args.ingest_workers,
                          "host_peak_rss_bytes": peak_rss()}), flush=True)
        return 0

    import torch

    from nxsearch_tpu_torch import Nxs
    from nxsearch_tpu_torch import search as search_mod
    from nxsearch_tpu_torch.nxs import resolve_device

    device = resolve_device(args.device)      # cuda without a card raises
    on_card = device.type == "cuda"
    card = card_line() if on_card else None
    rng = np.random.default_rng(42)
    ranks = np.arange(args.vocab, dtype=np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    words = np.array([f"w{i:05d}" for i in range(args.vocab)])
    queries = (make_mixed_queries if args.mixed else make_queries)(
        args.queries, words, probs, rng)

    os.makedirs(CACHE_ROOT, exist_ok=True)
    ingest_s = build_corpus(basedir, args, log) if fresh else None
    nxs = Nxs(basedir, device=device)
    try:
        t0 = time.perf_counter()
        idx = nxs.index_open("bench")
        open_s = time.perf_counter() - t0
        log(f"opened the index in {open_s:.1f}s")
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        idx.search(queries[0], None)          # builds the device snapshot
        if on_card:
            torch.cuda.synchronize(device)
        snapshot_s = time.perf_counter() - t0
        search_mod.EXEC_STATS.clear()     # bench.py's traffic from here
        snap = snapshot_bytes(idx.dev)
        log(f"device snapshot in {snapshot_s:.1f}s, {snap} bytes")
        m = measure(idx, queries, args, words, probs, rng, log)
        exec_stats = dict(sorted(search_mod.EXEC_STATS.items()))
        log(f"exec stats: {exec_stats}")
        peak = torch.cuda.max_memory_allocated(device) if on_card else None
    finally:
        nxs.close()
    samples, qps = m["samples"], round(m["qps"], 1)

    # vs_baseline from the printed value, so the two fields agree where
    # the rate lies near a rounding boundary.
    print(json.dumps({
        "metric": "bm25_top10_search_qps",
        "value": qps,
        "unit": "queries/s",
        "vs_baseline": round(qps / 10_000.0, 4),
        "detail": {
            "docs": args.docs,
            "vocab": args.vocab,
            "mean_len": args.mean_len,
            "batch": args.batch,
            "batched_qps": round(qps, 1),
            "qps_samples": [round(s, 1) for s in samples],
            "qps_median": round(float(np.median(samples)), 1),
            "steal_variance": round((max(samples) - min(samples))
                                    / max(samples), 4),
            "seq_p50_ms": round(m["p50"], 2),
            "seq_p99_ms": round(m["p99"], 2),
            "seq_cold_events": m["n_cold"],
            "seq_cold_max_ms": round(m["cold_max"], 1),
            "fuzzy_qps": round(m["fz_qps"], 1),
            "fuzzy_p50_ms": round(m["fz_p50"], 2),
            "exec_stats": exec_stats,
            "real_corpora": "unavailable offline; synthetic Zipf "
                            "shape-equivalents",
            **({"ingest_docs_per_s": round(args.docs / ingest_s, 1),
                "ingest_workers": args.ingest_workers}
               if ingest_s else {}),
            "device": {"type": device.type,
                       "name": (torch.cuda.get_device_name(device)
                                if on_card else None),
                       "card": card},
            "open_s": round(open_s, 3),
            "snapshot_s": round(snapshot_s, 3),
            "snapshot_bytes": snap,
            "peak_device_bytes": peak,
            "host_peak_rss_bytes": peak_rss(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
