#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (nxsearch_tpu_torch) on one card.

Drives the port's paths -- BM25 top-10 batch search with fuzzy (typo)
resolution by the forward, transposed (NXS_FUZZY_REV=1) and
single-query Myers kernels, boolean (AND / NOT) search on the masked
sliced route and on the blockdense route, and the fallback routes
(the dense and candidate executors, impact-prefix plans with wide
terms) -- at the benchmark's 1M-document tier, a snapshot of
17,825,792 device slots (phase 15) and the north-star tier's shapes
(phase 16), through the entry points a user calls (Nxs,
Index.add_many, search, search_pipelined, search_many,
parallel_ingest, the REST service in process and as ``python -m``, the
benchmark CLI, bench_torch.py), and checks every hand-written kernel
of those paths against its plain PyTorch twin.  Phases (any failure exits non-zero and prints no result):

1. card check and kernel build: needs torch.cuda; prints the card's
   name and power limit; builds csrc/*.cu with nvcc (first use), one
   nvcc per source, all started together, and beside them compiles the
   Myers step (csrc/myers_step.cuh) alone and counts its SASS integer
   instructions with cuobjdump (the Myers kernels' operations bound),
   and compiles each source with -Xptxas -v (registers, shared memory
   and spills per kernel, logged);
2. kernel phase: the forward and transposed Myers kernels against their
   twins and against each other, exact equality, on M = 64 query rows
   (one chunk) over W = 200,000 terms three times: terms and queries of
   1-32 random bytes from 8 letters (32-byte and q_len 0 rows
   included), the same over all 256 byte values (more distinct query
   bytes than the transposed kernel's 32-row table holds), and the main
   path's band (the bench vocabulary, whose 200,000 terms are 6 or 7
   bytes, and 64 of its 6-8 byte typos); at M = 1 (three rows of each
   set), the single-query kernel against its plain version, the
   batched kernel and the transposed kernel, and the transposed kernel
   against its twin; kernels timed with CUDA events behind a sleep
   kernel (device time only), forward and transposed in turns (fwd,
   rev, rev, fwd) on each set, and at M = 1 the single-query, batched
   and transposed kernels in turns; beside them the per-call floor of
   an empty kernel launched back to back, and the single-query kernel
   one call at a time after a 64 MB write (L2 cold); then the segsum
   kernel on two synthetic launches made on the card from a seed
   (segsum_synthetic): the north-star tier's launch shape (7 rows of
   9,437,184 slots, 8 terms, rows drawn as phase 7's from the tier's
   damped Zipf law) and heavy terms (the same shape, 8 terms of
   1,000,000 postings in every row), each equal bit for bit to its
   twin, timed in turns with torch.zeros of the same output bytes;
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
4. rev phase: with the transposed sweep on (fuzzy._USE_REV_KERNEL, as
   NXS_FUZZY_REV=1 sets it), three search_many passes over 512 fresh
   make_fuzzy_queries each, interleaved with forward passes over their
   own fresh sets (medians of both reported); asserts rev launches > 0
   and no forward launch during the rev passes, every rev answer equal
   to the same query's answer on the forward route (typos re-resolved),
   and 16 sampled rev answers against the numpy oracle;
5. single-query phase: 64 Index.search calls of one fresh typo query
   each; asserts one single-query kernel launch per distinct uncached
   typo and every answer equal to the same query's through search_many
   (typos re-resolved);
6. mixed phase: bench.make_mixed_queries (8192 queries: 25 % AND /
   AND NOT rows, 5 % typos) through search_pipelined in batches of
   2048 on the default route, after one warm-up pass; three passes,
   median QPS; asserts masked sliced rows and masked dense-row hybrid
   rows > 0;
7. blockdense phase: 512 masked queries that each hold a dense-row
   term (``d AND a``, ``a b AND NOT d``) through search_many with the
   masked hybrid off (search._MASKED_HYBRID, as NXS_MASKED_HYBRID=0
   sets it), so they take the blockdense route; asserts blockdense rows
   and segsum launches > 0 and every answer equal to the same query on
   the default route (both are exact: same ids up to an adjacent swap
   of scores within 1e-4, scores within 1e-4);
8. segsum phase: the segsum kernel against blockdense_scores_ref at the
   blockdense route's shape (the 64 first blockdense queries: bounds
   rows from the snapshot's cache, 8 terms, every slot, BM25, presence
   bits), scores and bits equal bit for bit, both timed with CUDA
   events, the kernel in turns with torch.zeros of its output bytes
   (store_floor_ms); the bound counts the per-slot columns only in
   blocks where some row has a posting, and a posting several rows
   share once;
9. boolean oracle: 64 sampled masked queries of each of phases 6 and 7,
   their parsed query trees walked over per-term document sets of the
   host CSR, BM25 over the matching documents (same tie rule and
   tolerance as phase 3);
10. fallback-routes phase, the routes off the default path (no kernel
   of their own), each number logged beside the card's name and power
   limit: (a) 256 masked queries of 33-48 words (seed 47) through
   search_many on the dense executor (``dense`` == 256), 32 held to
   the boolean oracle, a second pass identical bit for bit, QPS;
   (b) the first 512 mixed-trace queries (seed 43) through search_many
   with the prefix, sliced and blockdense routers off (every row on
   the candidate or dense executor), ms per call, answers equal to
   the default routes'; (c) impact-prefix plans with wide terms
   (search._PREFIX_MAX_WIDE = 4): 2048 make_queries (seed 42) and each
   wide term alone through search_many, search_pipelined (batches of
   512) and 64 + 8 through Index.search, every answer equal to the
   MAX_WIDE = 0 answer, at least one R > 0 row certified (R > 0 plans
   counted from ``_build_plans``), search_many's R > 0
   ``prefix_topk_packed`` groups replayed on the CPU and equal, the
   prefix / prefix_exact / prefix_fallback / prefix_spec_used counters
   and the region's wide terms, bytes and build seconds;
11. parallel ingest phase: nxsearch_tpu_torch.parallel_ingest of the
   same tier into a second basedir (bench.zipf_range through
   functools.partial, min(8, cpu count) spawned workers, each on the
   CPU); seconds and docs/s beside phase 3's serial add_many; doc,
   term and token counts equal phase 3's; the new index opened on the
   card and 64 sampled make_queries answered through search_many equal
   phase 3's (scores in rank order within 1e-4, ids up to ties within
   1e-4: parallel ingest gives documents other slots); then closed and
   deleted;
12. service phase: after a checkpoint of phase 3's index,
   SearchService(workdir, device="cuda") in this process behind a
   ThreadingHTTPServer on 127.0.0.1: a warm-up and a measured pass of
   8 keep-alive clients POSTing /bench/search_batch?limit=10 with 256
   of the 8192 make_queries per request (service QPS, request p50 /
   p99; the route counters equal the library's on the same queries),
   the same requests from one client and the library's search_many
   over the same chunks on one thread (QPS of both), one request of
   typos that builds the service handle's fuzzy matcher, 512 fresh
   typo queries in requests of 256 (forward Myers launches
   > 0), sequential /bench/search for 64 fresh typo and 64 plain
   queries (p50 / p99; one single-query launch per distinct uncached
   typo) and 64 make_mixed_queries rows; every answer equal to the
   library handle's (same_answer), /bench/stats equal to phase 3's
   counts, POST /~ answered 400, every other request 200;
13. entry-point phase: python -m nxsearch_tpu_torch.service --device
   cuda on a free port as a subprocess (ready within 300 s), one typo
   /bench/search equal to the library's answer, then terminated; and
   python -m nxsearch_tpu_torch.benchmark -s <query> --limit 10
   --device cuda, exit 0 and its JSON equal to the library's answer;
   their open seconds and the card memory the service took;
14. mesh phase: a second Nxs over phase 3's basedir with
   mesh=make_mesh([cuda:0] * 4) (four doc shards of the one card;
   with more cards make_mesh() would take them all): the shards' build
   seconds, bytes and dense rows per shard; 8192 make_queries through
   search_pipelined (every row on the R = 0 prefix body, or the sliced
   dense-row hybrid body where a row holds a dense-row term), 8192
   make_mixed_queries (sliced and fallback rows), the 512 blockdense
   queries of phase 7 through search_many (every row on the kernel
   body; segsum launches once per shard and 8-term group, one launch's
   inputs replayed through blockdense_scores_ref, equal), 64 > 32-term
   masked queries (the dense body), 64 Index.search calls, half with
   typos (single-query Myers launches), and a removal (the alive
   bitmaps flip, the shards stay); every answer equal to the
   single-device port's on the same index (scores within 1e-4, ids up
   to an adjacent swap, or, where three or more scores lie within 1e-4,
   up to that group; the count logged); QPS beside phases 3 and 6's;
   each drive with the launch counts from zero; then
   dryrun_multichip(2, devices=[cuda:0] * 2);
15. large-snapshot phase, after phase 3's index is closed: 17,000,000
   bench.zipf_range documents at mean length 5 (the 1M tier's
   vocabulary; texts made by spawned processes, indexed by
   Index.add_many in chunks) into a basedir of its own, and a snapshot
   of 17,825,792 device slots on the card with its exact int32 slot
   column (build seconds, device bytes, peak memory logged); every row
   on the candidate or dense executor, as the reference routes such a
   snapshot: 8192 make_queries through search_pipelined, 512 typo and
   2048 mixed-trace queries through search_many (forward Myers
   launches), 64 Index.search calls, half typos (one single-query
   launch per distinct typo), 8 > 32-term masked queries (the dense
   plane), each drive with the counts from zero and its routes
   asserted; the numpy oracles on 64 plain, 16 fuzzy, 32 boolean and
   the 8 dense answers; 16 documents in odd and 4 in even device slots
   from 2**24 up, each found by a term of df <= 1000 with the oracle's
   scores; the answers that f32 slots would have sent to another
   document counted; the index on a mesh of one card (a shard of
   17,825,792 slots): 16 documents in odd and 4 in even global slots
   from 2**24 up and the 8 dense queries through the mesh's candidate
   and dense bodies, with the oracle's answers under the mesh's tie
   rule (lowest host slot); one of the targeted documents removed and
   gone from its term's answer;
16. north-star phase: bench.py's north-star tier (vocab 1,000,000, mean
   length 60, zipf_range seed 42) cut to 1,048,576 of its 8,800,000
   documents for the script's time (the cut is logged), the dense-row
   byte budget lowered so that it holds the 35 rows it holds at the
   full tier (logged); bench_torch.py's traffic -- 8192 make_queries
   through search_pipelined, 8192 make_mixed_queries, 512 typo queries
   through search_many -- then 64 Index.search calls (half typos), the
   typos on the transposed kernel, 512 dense-row-term queries on the
   blockdense route and 8 > 32-term queries on the dense executor,
   each drive with the counts from zero and its routes and launches
   asserted; the numpy oracles on 64 plain, 16 fuzzy, 32 boolean and
   the dense answers, the transposed and blockdense answers equal to
   the forward and default routes'; the widest dispatch group per route
   (qs, T, terms, budget) logged; the four kernels at the phase's
   shapes (Myers over every term of the tier, segsum at one blockdense
   launch's rows) against their twins and timed, with their bounds;
   the snapshot's seconds, bytes and dense rows, peak device memory and
   host RSS; then bench_torch.py as a subprocess on a small fresh tier
   (its JSON line checked).

Each phase logs its seconds and numbers beside the card's name and
power limit, and the device memory it allocates.

The next-to-last lines are the kernel table (JSON: per kernel its
launches on its path, on the mesh's, on the large snapshot's and on
the north-star tier's, exactness, kernel / plain times, and its bound,
also at the north-star phase's shapes:
the larger of the bytes it must move over the card's memory rate and
its operations over the card's peak rate for their type) and the card
line; the last line is {"ok": true, "device": {...}}.

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

from bench_torch import card_line  # noqa: E402  (the card's name, power)

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
N_SINGLE = 64           # Index.search calls of the single-query phase
N_DENSE = 256           # > 32-term masked queries (dense executor)
N_DENSE_ORACLE = 32
N_CAND = 512            # mixed-trace queries on the candidate executor
N_WIDE = 2048           # make_queries with wide prefix terms (R > 0)
WIDE_BATCH = 512
N_WIDE_SINGLE = 64
PASSES = 3              # measured passes (median reported)
INGEST_WORKERS = 8      # parallel ingest: min(this, os.cpu_count())
N_PAR_CHECK = 64        # parallel build's answers held to phase 3's
PAR_DEEP = 100          # ... ranked this deep (ties at the cut)
SVC_CLIENTS = 8         # keep-alive HTTP clients (tools/bench_service.py)
SVC_REQ = 256           # queries per /search_batch request
N_SEQ = 64              # sequential typo, plain and boolean requests
SVC_OPEN_LIMIT_S = 300  # a subprocess service must answer within this
MESH_SHARDS = 4         # phase 14: shards of the one card
N_MESH_DENSE = 64       # > 32-term masked queries on the mesh
N_MESH_SINGLE = 64      # Index.search calls on the mesh
N_LARGE = 17_000_000    # phase 15: 17,825,792 device slots
LARGE_MEAN_LEN = 5      # Poisson(5) clipped at 5: about 6 tokens a doc
LARGE_CHUNK = 1 << 17   # documents per add_many call
LARGE_GEN_WORKERS = 8   # processes generating the texts: min(this, cpus)
LARGE_SLOT_FROM = 1 << 24   # f32 holds every slot below this exactly
N_LARGE_QUERIES = 8192
N_LARGE_FUZZY = 512
N_LARGE_MIXED = 2048
N_LARGE_SINGLE = 64     # half of them typos
N_LARGE_DENSE = 8       # > 32-term masked queries (the dense plane)
N_LARGE_ORACLE = 64     # plain answers held to the oracle
N_LARGE_FUZZY_ORACLE = 16
N_LARGE_BOOL_ORACLE = 32
N_ODD, N_EVEN = 16, 4   # targeted documents past LARGE_SLOT_FROM
LARGE_DF_MAX = 1000     # their query term's df at most this
N_NORTH = 1_048_576     # phase 16: the north-star tier's documents, cut
NORTH_FULL = 8_800_000  # ... from these to fit the script's time
NORTH_VOCAB = 1_000_000
NORTH_MEAN_LEN = 60
N_NORTH_QUERIES = 8192  # bench_torch.py's pure-OR and mixed traces
N_NORTH_FUZZY = 512
N_NORTH_SINGLE = 64     # half of them typos
N_NORTH_DENSE = 8
N_NORTH_ORACLE = 64
N_NORTH_FUZZY_ORACLE = 16
N_NORTH_BOOL_ORACLE = 32
# The bench_torch.py subprocess: a small tier, built afresh.
NORTH_BENCH = ["--docs", "65536", "--queries", "2048", "--batch", "512"]
TOL = 1e-4               # score tolerance of the reference's own tests

# The card's peak rates for the kernels' bounds: HBM3 bytes per second
# and FP32 operations per second of an H100 SXM (NVIDIA's data sheet);
# INT32 operations per second are SMs x INT32 lanes per SM x the SM
# clock nvidia-smi reports as the card's maximum.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_LANES_PER_SM = 64
# Operations of the Myers kernels' bound: the SASS instructions of one
# step (myers_step_instructions).  Segsum: ops per posting (ltf*idf,
# ltf+c1, c2*dl, +, /, and the accumulate).
SEGSUM_POSTING_OPS = 6
# Synthetic segsum launches (segsum_synthetic): the 1M tier's (N =
# N_SEGSUM rows of the real index's launch; bench.py's 1M tier, about
# 40M postings, 50 dense rows) and the north-star tier's (7 rows of
# 9,437,184 slots: the 8.8M-document tier, vocabulary 1M, 516,547,411
# postings, 35 dense rows), and the heavy case: the tier's slots, 8
# terms of 1,000,000 postings in every row (each (row, block) holds
# about 108 postings of every term).
SEGSUM_CASES = {
    "1m": {"rows": 64, "slots": 1 << 20, "docs": 1_000_000,
           "vocab": 200_000, "postings": 40_000_000, "dense": 50,
           "mean_len": 40},
    "tier": {"rows": 7, "slots": 9_437_184, "docs": 8_800_000,
             "vocab": 1_000_000, "postings": 516_547_411, "dense": 35,
             "mean_len": 60},
    "heavy": {"rows": 7, "slots": 9_437_184, "docs": 8_800_000,
              "heavy": 8, "heavy_df": 1_000_000, "mean_len": 60},
}
# csrc/myers_step.cuh alone: probe<K> runs K steps on per-thread state
# loaded from memory, so probe<9> - probe<1> is 8 steps' instructions.
STEP_PROBE = r"""
#include "myers_step.cuh"
template <int kSteps>
__global__ void probe(const uint32_t* __restrict__ in,
                      uint32_t* __restrict__ out) {
  const uint32_t* p = in + 16 * threadIdx.x;
  uint32_t pv = p[0], mv = p[1];
  int score = (int)p[4];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    myers_step(p[5 + i], p[2], p[3], pv, mv, score);
  }
  out[3 * threadIdx.x] = pv;
  out[3 * threadIdx.x + 1] = mv;
  out[3 * threadIdx.x + 2] = (uint32_t)score;
}
template __global__ void probe<1>(const uint32_t*, uint32_t*);
template __global__ void probe<9>(const uint32_t*, uint32_t*);
"""
# SASS opcodes that are not per-lane integer work: memory, control,
# special-register reads and the uniform datapath (U*).
SASS_NOT_ALU = ("LD", "ST", "ATOM", "RED", "BRA", "BRX", "JMP", "EXIT",
                "RET", "CALL", "NOP", "BAR", "BSSY", "BSYNC", "WARPSYNC",
                "YIELD", "MEMBAR", "DEPBAR", "S2R", "CS2R", "S2UR", "U")
SLEEP_CYCLES = 4_000_000    # about 2 ms of the card's clock (cuda_times)
KERNEL_REPS = 10            # kernel calls per timed sample


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sm_clock_max_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def int32_ops_per_s() -> float:
    import torch
    return (torch.cuda.get_device_properties(0).multi_processor_count
            * INT32_LANES_PER_SM * sm_clock_max_mhz() * 1e6)


def sass_alu_counts(sass: str) -> dict:
    """Per function of ``cuobjdump -sass`` output (keyed by its mangled
    name), the count of per-lane integer instructions: every opcode
    that is not memory, control flow, a special-register read or a
    uniform-datapath op (SASS_NOT_ALU)."""
    import re

    counts, name = {}, None
    op = re.compile(r"^\s*/\*[0-9a-f]+\*/\s*\{?\s*(?:@!?\w+\s+)?([A-Z0-9_]+)")
    for line in sass.splitlines():
        head = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if head:
            name = head.group(1)
            counts[name] = 0
            continue
        m = op.match(line)
        if name is not None and m and not m.group(1).startswith(
                SASS_NOT_ALU):
            counts[name] += 1
    return counts


def myers_step_instructions() -> float:
    """Integer instructions of one Myers step (csrc/myers_step.cuh) as
    nvcc compiles it for sm_90a with the kernels' flags: the probe's
    9-step and 1-step functions' counts apart, over 8."""
    from nxsearch_tpu_torch.ops import kernels

    nvcc = kernels._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        cubin = os.path.join(tmp, "probe.cubin")
        with open(src, "w") as f:
            f.write(STEP_PROBE)
        flags = [f for f in kernels.NVCC_FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC")]
        subprocess.run([nvcc, *flags, "-cubin", "-I", kernels.CSRC_DIR,
                        "-o", cubin, src], check=True, capture_output=True,
                       timeout=300)
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True,
                              timeout=60).stdout
    counts = sass_alu_counts(sass)
    one = [v for k, v in counts.items() if "probeILi1E" in k]
    nine = [v for k, v in counts.items() if "probeILi9E" in k]
    if len(one) != 1 or len(nine) != 1:
        raise AssertionError(f"step probe: functions not found in "
                             f"{sorted(counts)}")
    per_step = (nine[0] - one[0]) / 8
    if not 4 <= per_step <= 64:
        raise AssertionError(f"step probe: {per_step} instructions per "
                             f"step ({counts})")
    return per_step


def ptxas_usage(source: str) -> dict:
    """Per kernel function of csrc/``source`` (keyed by its mangled
    name): registers, shared memory bytes and spill bytes, as
    ``nvcc -Xptxas -v`` reports them for sm_90a with the kernels'
    flags."""
    from nxsearch_tpu_torch.ops import kernels

    flags = [f for f in kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [kernels._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
             os.path.join(tmp, "k.cubin"),
             os.path.join(kernels.CSRC_DIR, source)],
            check=True, capture_output=True, text=True, timeout=300)
    return parse_ptxas(proc.stdout + proc.stderr)


def parse_ptxas(text: str) -> dict:
    """The ``ptxas info`` lines of ``-Xptxas -v`` output, per entry
    function: {"registers", "smem_bytes", "spill_stores",
    "spill_loads"}."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": 0, "smem_bytes": 0, "spill_stores": 0,
                         "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(m.group(1)) if m else 0
    return out


def cuda_times(fn, runs: int, reps: int = 1, flush=None) -> list[float]:
    """Device milliseconds per call of ``fn``, ``runs`` samples of
    ``reps`` calls each (CUDA events).  Each sample is queued behind a
    sleep kernel, so the card starts the timed calls only once the host
    has queued them: the wrappers' host work (about 0.03 ms a call)
    stays off the clock unless ``fn`` synchronizes, as the plain
    versions' data-dependent shapes do.  ``flush``, a tensor larger
    than the L2 cache, is written before each sample, so the sample
    starts with none of its inputs in L2."""
    import torch
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        if flush is not None:
            flush.fill_(1)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return times


def median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def cuda_time_ms(fn, runs: int, reps: int = 1, flush=None) -> float:
    """Median device time per call of ``fn`` (see cuda_times)."""
    return median(cuda_times(fn, runs, reps, flush))


def myers_inputs(seed: int = 0) -> dict:
    """Myers inputs on the card by name, each (vocab bytes, vocab
    lengths, query bytes, query lengths) with M = KERNEL_M rows and
    W = KERNEL_W terms.  "random": 1-32 bytes from 8 letters, a 32-byte
    and a q_len 0 query row.  "full": the same over all 256 byte values
    (0 and 255 inside every query row of two bytes or more), so the
    queries' bytes
    exceed one 32-byte alphabet of the transposed kernel's table.
    "band": the bench vocabulary (6 and 7 byte terms) and typos of it
    as make_fuzzy_queries makes them (6-8 bytes)."""
    import numpy as np
    import torch

    import bench

    m_q, w = KERNEL_M, KERNEL_W
    rng = np.random.default_rng(seed)

    def rows(alphabet):
        vl = rng.integers(1, 33, size=w).astype(np.int32)
        vb = alphabet[rng.integers(0, len(alphabet), size=(w, 32))]
        vb[np.arange(32)[None, :] >= vl[:, None]] = 0
        ql = rng.integers(1, 33, size=m_q).astype(np.int32)
        ql[0], ql[1] = 32, 0              # full-width row, q_len 0 row
        qb = alphabet[rng.integers(0, len(alphabet), size=(m_q, 32))]
        qb[np.arange(32)[None, :] >= ql[:, None]] = 0
        return vb, vl, qb, ql

    def pack(tokens):
        out = np.zeros((len(tokens), 32), dtype=np.uint8)
        for i, t in enumerate(tokens):
            out[i, : len(t)] = np.frombuffer(t.encode(), dtype=np.uint8)
        return out, np.array([len(t) for t in tokens], dtype=np.int32)

    # "full" is drawn last, so "random" and "band" keep the inputs that
    # earlier measurements used.
    sets = {"random": rows(np.frombuffer(b"abcdefgh", dtype=np.uint8))}
    words, probs = vocab()
    typos = [q.split()[1] for q in bench.make_fuzzy_queries(
        m_q, words, probs, rng, "k")]
    sets["band"] = (*pack(list(words)), *pack(typos))
    sets["full"] = rows(np.arange(256, dtype=np.uint8))
    _vb, _vl, qb, ql = sets["full"]
    wide = np.nonzero(ql >= 2)[0]
    qb[wide, 0], qb[wide, ql[wide] - 1] = 0, 255
    dev = torch.device("cuda")
    return {name: [torch.from_numpy(a).to(dev) for a in arrays]
            for name, arrays in sets.items()}


def myers_ops(vl, ql, rev: bool, step_ops: float) -> float:
    """Integer operations of a Myers sweep on these inputs: a forward
    sweep runs min(len(term), 32) steps per (query, term) pair, a
    transposed one min(len(query), 32), each of ``step_ops``."""
    steps_t = float(vl.clamp(0, 32).sum())
    steps_q = float(ql.clamp(0, 32).sum())
    pairs_steps = (steps_q * vl.shape[0] if rev else steps_t * ql.shape[0])
    return step_ops * pairs_steps


def myers_bytes(vb, vl, qb, ql) -> float:
    """Each input read once, the int32[M, W] output written once."""
    return float(vb.numel() + 4 * vl.numel() + qb.numel() + 4 * ql.numel()
                 + 4 * ql.numel() * vl.numel())


def batched_at_one(vb, vl, qb, ql):
    """The batched kernel (MYERS) launched at M = 1, which the wrapper
    never does: the single-query kernel's comparison."""
    import torch

    from nxsearch_tpu_torch.ops import kernels

    out = torch.empty((1, vb.shape[0]), dtype=torch.int32, device=vb.device)
    kernels.MYERS.launch(vb.device, vb.data_ptr(), vl.data_ptr(),
                         qb.data_ptr(), ql.data_ptr(), out.data_ptr(),
                         vb.shape[0], 1)
    return out


def in_turns(fns: dict, order, args, runs: int = 11, **kw) -> dict:
    """Median device ms per call of each of ``fns`` on ``args``, sampled
    in the given order of names (each name's samples pooled)."""
    t = {name: [] for name in fns}
    for name in order:
        t[name] += cuda_times(lambda fn=fns[name]: fn(*args), runs, **kw)
    return {name: median(v) for name, v in t.items()}


def kernel_phase(step_ops: float) -> dict:
    """The three Myers kernels against their plain versions and against
    each other, at the main path's shapes and at M = 1, on three input
    sets; times with CUDA events.  ``step_ops``: integer instructions
    per Myers step (the bound)."""
    import torch

    from nxsearch_tpu_torch.ops import kernels

    sets = myers_inputs()
    max_err = {"fwd": 0, "rev": 0, "one": 0}

    def check(name, got, want, what):
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err[name] = max(max_err[name], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: max |diff| {err}")

    for shape, args in sets.items():
        fwd = kernels.myers_distances(*args)
        rev = kernels.myers_rev_distances(*args)
        check("fwd", fwd, kernels.myers_distances_ref(*args),
              f"forward kernel vs its twin ({shape})")
        check("rev", rev, kernels.myers_rev_distances_ref(*args),
              f"transposed kernel vs its twin ({shape})")
        check("rev", rev, fwd, f"transposed vs forward kernel ({shape})")
        vb, vl, qb, ql = args
        for i in (0, 1, 2):   # random, full: 32 bytes, q_len 0, any
            row = (vb, vl, qb[i: i + 1], ql[i: i + 1])
            one = kernels.myers_distances(*row)
            check("one", one[0], kernels.myers_distances_one_ref(
                vb, vl, qb[i], ql[i]), f"single-query kernel vs its "
                f"plain version ({shape}, row {i})")
            check("one", one, fwd[i: i + 1],
                  f"single-query vs batched kernel ({shape}, row {i})")
            check("one", one, batched_at_one(*row),
                  f"single-query vs batched kernel at M = 1 ({shape}, "
                  f"row {i})")
            rev_one = kernels.myers_rev_distances(*row)
            check("rev", rev_one, kernels.myers_rev_distances_ref(*row),
                  f"transposed kernel at M = 1 vs its twin ({shape}, "
                  f"row {i})")
            check("rev", rev_one, one, f"transposed vs single-query "
                  f"kernel at M = 1 ({shape}, row {i})")

    # Forward and transposed in turns on one card: fwd, rev, rev, fwd.
    fwd_rev = {"fwd": kernels.myers_distances,
               "rev": kernels.myers_rev_distances}
    out = {shape: in_turns(fwd_rev, ("fwd", "rev", "rev", "fwd"), args,
                           reps=KERNEL_REPS)
           for shape, args in sets.items()}
    band = sets["band"]
    vb, vl, qb, ql = band
    one_args = (vb, vl, qb[:1], ql[:1])
    # At M = 1 in turns: the single-query kernel, the batched kernel and
    # the transposed kernel (a rev-mode Index.search).
    m1 = {"one": kernels.myers_distances, "batched_m1": batched_at_one,
          "rev_m1": kernels.myers_rev_distances}
    out["band"].update(in_turns(
        m1, ("one", "batched_m1", "rev_m1", "rev_m1", "batched_m1", "one"),
        one_args, reps=KERNEL_REPS))
    # The per-call floor: an empty kernel launched back to back.
    out["band"]["launch_floor"] = cuda_time_ms(
        lambda: torch.cuda._sleep(0), 11, KERNEL_REPS)
    # One call at a time after a 64 MB write, as a lone Index.search may
    # find the vocabulary out of L2 (50 MB): back-to-back samples above
    # read the 7.2 MB band from L2.
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    out["band"]["one_cold_l2"] = cuda_time_ms(
        lambda: kernels.myers_distances(*one_args), 21, flush=flush)
    del flush
    plain = {
        "fwd": cuda_time_ms(lambda: kernels.myers_distances_ref(*band), 5),
        "rev": cuda_time_ms(
            lambda: kernels.myers_rev_distances_ref(*band), 5),
        "one": cuda_time_ms(lambda: kernels.myers_distances_one_ref(
            vb, vl, qb[0], ql[0]), 5)}
    int_rate = int32_ops_per_s()
    bounds = {
        "fwd": bound(myers_bytes(*band), myers_ops(vl, ql, False, step_ops),
                     int_rate),
        "rev": bound(myers_bytes(*band), myers_ops(vl, ql, True, step_ops),
                     int_rate),
        "one": bound(myers_bytes(*one_args),
                     myers_ops(vl, ql[:1], False, step_ops), int_rate)}
    random_bounds = {
        name: bound(myers_bytes(*sets["random"]),
                    myers_ops(sets["random"][1], sets["random"][3],
                              name == "rev", step_ops), int_rate)
        for name in ("fwd", "rev")}
    log(f"kernel phase: M={KERNEL_M} W={KERNEL_W}; forward, transposed and "
        f"single-query kernels exact against their plain versions and "
        f"each other (random 1-32 byte rows, full-byte-range rows and the "
        f"6-7 byte band; M = 64 and M = 1); times (ms) {out}; plain "
        f"(band): fwd {plain['fwd']:.4f} ms, rev {plain['rev']:.4f} ms, "
        f"single {plain['one']:.4f} ms; INT32 peak {int_rate:.4e} op/s, "
        f"{step_ops} instructions per Myers step; bounds {bounds}; "
        f"random-row bounds {random_bounds}")
    rows = {name: {"max_abs_err": max_err[name], "ms": out["band"][name],
                   "plain_ms": plain[name], **bounds[name]}
            for name in ("fwd", "rev", "one")}
    rows["one"].update(launch_floor_ms=out["band"]["launch_floor"],
                       cold_l2_ms=out["band"]["one_cold_l2"])
    rows["rev"]["m1_ms"] = out["band"]["rev_m1"]
    return rows | {"times": out}


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


def vocab(n: int = 0):
    """bench.py's vocabulary of ``n`` (VOCAB) words and its Zipf term
    probabilities."""
    import numpy as np

    n = n or VOCAB
    return np.array([f"w{i:05d}" for i in range(n)]), zipf_probs(n)


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


class SlotOfId:
    """doc id -> host slot, by a binary search of the sorted ids (a dict
    of 17M ids would cost seconds and gigabytes)."""

    def __init__(self, doc_ids):
        import numpy as np

        self.order = np.argsort(doc_ids, kind="stable")
        self.ids = np.asarray(doc_ids)[self.order]

    def __getitem__(self, doc_id: int) -> int:
        import numpy as np

        at = int(np.searchsorted(self.ids, doc_id))
        if at == len(self.ids) or self.ids[at] != doc_id:
            raise KeyError(doc_id)
        return int(self.order[at])


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
        self.slot_of_id = SlotOfId(csr["doc_ids"])
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

    for kernel in all_kernels():
        kernel.launches = 0
    search_mod.EXEC_STATS.clear()


def all_kernels():
    """Every kernel object of the port (two share csrc/myers.cu)."""
    from nxsearch_tpu_torch.ops import kernels
    return (kernels.MYERS, kernels.MYERS_ONE, kernels.MYERS_REV,
            kernels.SEGSUM)


def launch_counts() -> dict:
    """Every kernel's launch count, by its entry symbol."""
    return {kern.symbol: kern.launches for kern in all_kernels()}


def myers_counts() -> dict:
    from nxsearch_tpu_torch.ops import kernels
    return {"fwd": kernels.MYERS.launches, "one": kernels.MYERS_ONE.launches,
            "rev": kernels.MYERS_REV.launches}


def forget_typos(idx) -> None:
    """Drop the fuzzy matcher's memo of resolved typos, so the next
    search resolves them again (on whatever route is set)."""
    idx._fuzzy._memo_cache = None


def typos_of(idx, queries) -> set:
    """The filtered words of ``queries`` that the dictionary lacks."""
    out = set()
    for q in queries:
        for v in q.split():
            f = idx.pipeline.run(v)
            if f is not None and idx.host.term_lookup(f) is None:
                out.add(f)
    return out


def rev_phase(idx, sp, oracle: HostOracle) -> dict:
    """Fuzzy search_many with the transposed sweep on, interleaved with
    forward passes; answers held to the forward route's and the
    oracle."""
    import numpy as np
    import torch

    import bench
    from nxsearch_tpu_torch import fuzzy as fuzzy_mod

    words, probs = vocab()
    rng = np.random.default_rng(45)
    # Fresh typos for every pass: g warms up, a-c rev, d-f fwd.
    sets = {s: bench.make_fuzzy_queries(N_FUZZY, words, probs, rng, s)
            for s in "gabcdef"}
    saved = fuzzy_mod._USE_REV_KERNEL
    rev_qps, fwd_qps, rev_out = [], [], []
    launches = {"fwd": 0, "one": 0, "rev": 0}
    try:
        fuzzy_mod._USE_REV_KERNEL = True
        idx.search_many(sets["g"][:64], sp)             # warm-up
        torch.cuda.synchronize()
        for p in range(PASSES):
            fuzzy_mod._USE_REV_KERNEL = True
            reset_counts()
            t0 = time.perf_counter()
            rev_out.append(idx.search_many(sets["abc"[p]], sp))
            rev_qps.append(N_FUZZY / (time.perf_counter() - t0))
            for k, v in myers_counts().items():
                launches[k] += v
            fuzzy_mod._USE_REV_KERNEL = False
            t0 = time.perf_counter()
            idx.search_many(sets["def"[p]], sp)
            fwd_qps.append(N_FUZZY / (time.perf_counter() - t0))
        fuzzy_mod._USE_REV_KERNEL = False
        log(f"rev phase: fuzzy search_many ({N_FUZZY} queries) with the "
            f"transposed sweep: median {median(rev_qps):.1f} QPS of "
            f"{[round(x, 1) for x in rev_qps]}; forward passes between "
            f"them: median {median(fwd_qps):.1f} QPS of "
            f"{[round(x, 1) for x in fwd_qps]}; launches during the rev "
            f"passes {launches}")
        if launches["rev"] <= 0 or launches["fwd"] or launches["one"]:
            raise AssertionError(f"rev passes: transposed launches only "
                                 f"expected, got {launches}")
        # The same queries on the forward route, typos re-resolved.
        reset_counts()
        for p in range(PASSES):
            forget_typos(idx)
            want = idx.search_many(sets["abc"[p]], sp)
            for q, w, g in zip(sets["abc"[p]], want, rev_out[p]):
                same_answer(w, g, q)
            check_finite(rev_out[p])
        if myers_counts()["fwd"] <= 0:
            raise AssertionError("the forward route launched no kernel")
    finally:
        fuzzy_mod._USE_REV_KERNEL = saved
    sample = np.random.default_rng(9).choice(N_FUZZY, N_FUZZY_ORACLE,
                                             replace=False)
    oracle.n_typos = 0
    for i in sample:
        oracle.check_plain(sets["a"][int(i)], rev_out[0][int(i)])
    if oracle.n_typos < N_FUZZY_ORACLE:
        raise AssertionError(f"only {oracle.n_typos} typo tokens resolved")
    log(f"rev phase: {PASSES} x {N_FUZZY} answers equal the forward "
        f"route's; {N_FUZZY_ORACLE} sampled rev answers agree with the "
        "oracle")
    return {"qps": median(rev_qps), "qps_samples": rev_qps,
            "fwd_qps": median(fwd_qps), "fwd_qps_samples": fwd_qps,
            "launches": launches}


def single_phase(idx, sp) -> dict:
    """One typo query per Index.search: each distinct uncached typo is
    resolved by one single-query kernel launch."""
    import numpy as np

    import bench

    words, probs = vocab()
    queries = bench.make_fuzzy_queries(N_SINGLE, words, probs,
                                       np.random.default_rng(46), "h")
    typos = typos_of(idx, queries)
    reset_counts()
    times = []
    got = []
    for q in queries:
        t0 = time.perf_counter()
        got.append(idx.search(q, sp))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = myers_counts()
    log(f"single-query phase: {N_SINGLE} Index.search calls, "
        f"{len(typos)} distinct typos: median {median(times):.4f} ms per "
        f"search; launches {launches}")
    if launches != {"fwd": 0, "one": len(typos), "rev": 0} or not typos:
        raise AssertionError(f"one single-query launch per distinct typo "
                             f"({len(typos)}) expected: {launches}")
    forget_typos(idx)
    want = idx.search_many(queries, sp)
    for q, w, g in zip(queries, want, got):
        same_answer(w, g, q)
    check_finite(got)
    log(f"single-query phase: {N_SINGLE} answers equal search_many's")
    return {"ms_per_search": median(times), "launches": launches["one"],
            "typos": len(typos)}


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


def bd_queries(idx, n_vocab: int = 0) -> list[str]:
    """N_BD masked queries, each holding a dense-row term d: ``d AND a``
    and ``a b AND NOT d`` with a, b from the mixed trace's word mix
    (bench.py's vocabulary of ``n_vocab`` words, VOCAB by default)."""
    import numpy as np

    words, probs = vocab(n_vocab)
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


def segsum_phase(idx, queries: list[str], n_rows: int = 0) -> dict:
    """The segsum kernel against its plain twin at the blockdense
    route's shape: the first ``n_rows`` (N_SEGSUM) blockdense queries'
    kernel terms (bounds rows from the snapshot's cache), every slot,
    BM25 (segsum_case)."""
    import numpy as np
    import torch

    from nxsearch_tpu_torch import Params
    from nxsearch_tpu_torch import search as search_mod
    from nxsearch_tpu_torch.ops import executor

    dev = idx.dev
    sp = search_mod.get_search_params(idx.algo,
                                      Params().set_uint("limit", 10))
    prepared = search_mod._prepare_many(dev, idx.pipeline,
                                        queries[: n_rows or N_SEGSUM], sp)
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
    return segsum_case(args, "segsum phase")


def occupied_blocks(bounds) -> int:
    """Blocks in which some row of the launch has a posting: some
    (n, q) with bounds[n, q, g] < bounds[n, q, g + 1]."""
    if bounds.shape[1] == 0:
        return 0
    return int((bounds[:, :, 1:] > bounds[:, :, :-1]).any(1).any(0).sum())


def distinct_postings(bounds) -> int:
    """Postings one launch must read: the union of its (row, term)
    ranges [bounds[n, q, 0], bounds[n, q, G]), so that a term several
    rows share counts once."""
    import numpy as np

    lo = bounds[:, :, 0].reshape(-1).cpu().numpy().astype(np.int64)
    hi = bounds[:, :, -1].reshape(-1).cpu().numpy().astype(np.int64)
    keep = lo < hi
    order = np.argsort(lo[keep], kind="stable")
    lo, hi = lo[keep][order], hi[keep][order]
    if lo.size == 0:
        return 0
    # With starts sorted, the ranges before range i cover [lo[i], reach)
    # where reach is the furthest end among them.
    reach = np.concatenate(([lo[0]], np.maximum.accumulate(hi)[:-1]))
    return int(np.maximum(hi - np.maximum(lo, reach), 0).sum())


def segsum_bytes(bounds, n_slots: int, n_read: int, n_occupied: int) -> int:
    """Bytes one segsum launch must move: scores and bits written once
    (8 B a slot a row); the slot and ltf of each of the ``n_read``
    distinct postings, the bounds and coef read once; the per-slot doc
    lengths and alive factors (8 B a slot) read only in blocks where
    some row has a posting."""
    n_rows, n_terms = bounds.shape[0], bounds.shape[1]
    return (8 * n_rows * n_slots + 8 * n_read + 8 * 1024 * n_occupied
            + 4 * bounds.numel() + 16 * n_rows * n_terms)


def segsum_bound(bounds, n_slots: int) -> dict:
    """One segsum launch's postings (summed over the rows: the adds it
    does), distinct postings (what it reads), occupied blocks and bound
    (segsum_bytes over the distinct postings; its operations are
    SEGSUM_POSTING_OPS a row's posting at the FP32 rate)."""
    n_post = int((bounds[:, :, -1] - bounds[:, :, 0]).clamp(min=0).sum())
    n_read = distinct_postings(bounds)
    n_occ = occupied_blocks(bounds)
    return {"postings": n_post, "distinct_postings": n_read,
            "occupied_blocks": n_occ,
            **bound(segsum_bytes(bounds, n_slots, n_read, n_occ),
                    SEGSUM_POSTING_OPS * n_post, FP32_OPS_PER_S)}


def segsum_case(args, label: str) -> dict:
    """One segsum launch's inputs ``args`` (blockdense_scores' order),
    BM25 with presence bits: the kernel held bit for bit to its twin,
    both timed, and the kernel in turns with ``torch.zeros`` of the
    same 8 x N x S bytes (the card's store rate on this output:
    ``store_floor_ms``, a yardstick, not the same function); the bound
    over this launch's postings and occupied blocks (segsum_bound)."""
    import torch

    from nxsearch_tpu_torch.ops import kernels

    bounds, n_slots = args[4], args[2].shape[0]

    def kernel():
        return kernels.blockdense_scores(*args, algo=0, use_mask=True)

    def plain():
        return kernels.blockdense_scores_ref(*args, algo=0, use_mask=True)

    def floor():
        return torch.zeros(2 * bounds.shape[0] * n_slots,
                           dtype=torch.float32, device=bounds.device)

    got_s, got_b = kernel()
    want_s, want_b = plain()
    torch.cuda.synchronize()
    max_err = float((got_s - want_s).abs().max())
    if not (torch.equal(got_s, want_s) and torch.equal(got_b, want_b)):
        raise AssertionError(
            f"{label}: segsum kernel disagrees with its twin: max |diff| "
            f"{max_err}, {int((got_b != want_b).sum())} bit words differ")
    if not bool((want_s > 0).any()):
        raise AssertionError(f"{label}: segsum scored nothing")
    del got_s, got_b, want_s, want_b
    ms = in_turns({"kernel": kernel, "floor": floor},
                  ("kernel", "floor", "floor", "kernel"), (),
                  reps=KERNEL_REPS)
    plain_ms = cuda_time_ms(plain, 5)
    b = segsum_bound(bounds, n_slots)
    out = {"max_abs_err": max_err, "ms": ms["kernel"], "plain_ms": plain_ms,
           **b, "ratio": b["bound_ms"] / ms["kernel"],
           "store_floor_ms": ms["floor"],
           "shape": {"N": bounds.shape[0], "Q": bounds.shape[1],
                     "S": n_slots}}
    log(f"{label}: segsum N={bounds.shape[0]} Q={bounds.shape[1]} "
        f"S={n_slots} ({b['postings']} postings over the rows, "
        f"{b['distinct_postings']} distinct, {b['occupied_blocks']} "
        f"of {n_slots // 1024} blocks occupied): scores and bits exact; "
        f"kernel {ms['kernel']:.4f} ms, store floor {ms['floor']:.4f} ms, "
        f"plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}), ratio {out['ratio']:.4f}")
    return out


def zipf_probs(n: int):
    """bench.py's damped Zipf term probabilities over ``n`` words."""
    import numpy as np

    probs = 1.0 / (np.arange(n, dtype=np.float64) + 10.0)
    return probs / probs.sum()


def segsum_synthetic(case: str, seed: int = 45, device: str = "cuda"):
    """(args, facts) of one segsum launch at SEGSUM_CASES[case]'s shape,
    made on ``device`` from ``seed``.  Each term's df is its share of
    the corpus's postings under the damped Zipf law (at most one a
    document), its postings a uniform sample of the documents (slot i
    is document i), ltf log(1 + tf) with tf in 1-7.  A corpus case
    draws rows as bd_queries does ("d AND a", "a b AND NOT d": words
    drawn in proportion to p ** 0.35; a word with a dense row, like d,
    takes the all-zero bounds row); a heavy case gives every row its
    ``heavy`` terms of ``heavy_df`` postings, rotated.  Rows are padded
    to MAX_KERNEL_TERMS terms with the all-zero row.  Doc lengths lie in
    [mean / 2, 3 mean / 2]; slots past the documents and 1 % of the
    others are dead."""
    import numpy as np
    import torch

    from nxsearch_tpu_torch.ops import executor, kernels

    c = SEGSUM_CASES[case]
    n_rows, n_slots, n_docs = c["rows"], c["slots"], c["docs"]
    n_terms = kernels.MAX_KERNEL_TERMS
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 62)))
    cols = np.full((n_rows, n_terms), -1, np.int64)
    if "heavy" in c:
        df = np.full(c["heavy"], c["heavy_df"], np.int64)
        for r in range(n_rows):
            k = min(n_terms, c["heavy"])
            cols[r, :k] = (np.arange(k) + r) % c["heavy"]
    else:
        probs = zipf_probs(c["vocab"])
        qp = probs ** 0.35
        qp /= qp.sum()
        picks = rng.choice(len(probs), size=(n_rows, 2), p=qp)
        words = np.unique(picks[picks >= c["dense"]])
        df = np.minimum(n_docs, np.rint(c["postings"] * probs[words]))
        df = np.maximum(df, 1).astype(np.int64)
        at = {int(w): i for i, w in enumerate(words)}

        def col(w):
            return at.get(int(w), -1)
        for r in range(n_rows):
            a, b = picks[r]
            cols[r, :3] = ((-1, col(a), -1) if r % 2 == 0
                           else (col(a), col(b), -1))
    slots, ltfs = [], []
    for d in df:
        perm = torch.randperm(n_docs, generator=gen, device=device)
        slots.append(perm[: int(d)].sort().values.to(torch.int32))
        tf = torch.randint(1, 8, (int(d),), generator=gen, device=device)
        ltfs.append(torch.log1p(tf.to(torch.float32)))
    lens = torch.tensor(df, dtype=torch.int32, device=device)
    starts = (torch.cumsum(lens, 0) - lens).to(torch.int32)
    total = int(df.sum())
    p_pad = -(-(total + 1) // 1024) * 1024
    ps = torch.zeros(p_pad, dtype=torch.int32, device=device)
    pf = torch.zeros(p_pad, dtype=torch.float32, device=device)
    ps[:total] = torch.cat(slots)
    pf[:total] = torch.cat(ltfs)
    n_blocks = n_slots // 1024
    rows = executor.csr_block_bounds(ps, starts, lens, n_blocks=n_blocks)
    pick = torch.from_numpy(cols).to(device)
    bounds = torch.where((pick >= 0)[..., None], rows[pick.clamp(min=0)],
                         0).to(torch.int32).contiguous()
    mean = c["mean_len"]
    dl = torch.randint(mean // 2, mean + mean // 2 + 1, (n_slots,),
                       generator=gen, device=device).to(torch.float32)
    live = torch.rand(n_slots, generator=gen, device=device) > 0.01
    live[n_docs:] = False
    idf = np.log1p((n_docs - df + 0.5) / (df + 0.5)).astype(np.float32)
    coef = np.zeros((n_rows, n_terms, 4), np.float32)
    coef[..., 0] = np.where(cols >= 0, idf[np.maximum(cols, 0)], 1.0)
    coef[..., 1] = np.float32(1.2 * 0.25)
    coef[..., 2] = np.float32(1.2 * 0.75) / np.float32(mean)
    args = (ps, pf, dl, live.to(torch.float32), bounds,
            torch.from_numpy(coef).to(device))
    return args, {"terms": len(df), "term_postings": total}


def dense_queries(idx, n: int = 0, n_vocab: int = 0) -> list[str]:
    """``n`` (N_DENSE) masked queries of 33-48 unique words drawn from the
    damped Zipf vocab's words (``n_vocab``, VOCAB by default) in the
    dictionary (seed 47), alternately ``(a OR b OR ...) AND NOT z`` and
    ``(a OR ...) AND (m OR ...)``.  More than 32 terms: the dense
    executor's packed bitmaps."""
    import numpy as np

    words, probs = vocab(n_vocab)
    known = np.array([idx.host.term_lookup(idx.pipeline.run(str(w)))
                      is not None for w in words])
    words = words[known]
    qp = probs[known] ** 0.35
    qp /= qp.sum()
    rng = np.random.default_rng(47)
    out = []
    for i in range(n or N_DENSE):
        ws = [str(w) for w in words[rng.choice(
            len(words), int(rng.integers(33, 49)), replace=False, p=qp)]]
        half = len(ws) // 2
        out.append(f"({' OR '.join(ws[:-1])}) AND NOT {ws[-1]}" if i % 2 == 0
                   else f"({' OR '.join(ws[:half])}) AND "
                        f"({' OR '.join(ws[half:])})")
    return out


def fallback_phase(idx, sp, oracle: HostOracle, card: str) -> dict:
    """The routes off the default path, on the 1M tier: (a) > 32-term
    masked queries on the dense executor, (b) the mixed trace forced
    onto the candidate executor, (c) impact-prefix plans with wide
    terms (R > 0, search._PREFIX_MAX_WIDE = 4); each held to an oracle
    or to the default routes' answers."""
    import numpy as np
    import torch

    import bench
    from nxsearch_tpu_torch import search as search_mod

    words, probs = vocab()
    out = {}

    # (a) dense: two passes, identical bit for bit; an oracle sample.
    queries = dense_queries(idx)
    idx.search_many(queries[:16], sp)                    # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = idx.search_many(queries, sp)
    qps = N_DENSE / (time.perf_counter() - t0)
    stats = dict(search_mod.EXEC_STATS)
    launches = launch_counts()
    again = idx.search_many(queries, sp)
    if stats.get("dense", 0) != N_DENSE:
        raise AssertionError(f"dense route: {N_DENSE} rows expected, got "
                             f"{stats}")
    if [r.results for r in got] != [r.results for r in again]:
        raise AssertionError("dense route: two passes differ")
    check_finite(got)
    for i in np.random.default_rng(10).choice(N_DENSE, N_DENSE_ORACLE,
                                              replace=False):
        oracle.check_boolean(queries[int(i)], got[int(i)])
    log(f"fallback phase (a) dense: {N_DENSE} masked queries of 33-48 "
        f"terms through search_many: {qps:.1f} QPS ({card}); dense "
        f"{stats['dense']} rows; second pass identical; "
        f"{N_DENSE_ORACLE} sampled answers agree with the boolean oracle; "
        f"kernel launches {launches}")
    out["dense"] = {"qps": qps, "rows": stats["dense"], "launches": launches}

    # (b) candidate: the mixed trace through search_many with the
    # prefix, sliced and blockdense routers off, so every plan takes
    # the candidate executor (the dense one where its budget reaches
    # the slot count), through the code that serves them.
    queries = bench.make_mixed_queries(
        N_MIXED, words, probs, np.random.default_rng(43))[:N_CAND]
    want = idx.search_many(queries, sp)                  # default routes
    routers = {name: getattr(search_mod, name) for name in (
        "_prefix_mode", "_use_sliced", "_use_blockdense")}
    try:
        for name in routers:
            setattr(search_mod, name, lambda *a, **kw: False)
        idx.search_many(queries[:64], sp)                # warm-up
        ms = []
        for _ in range(PASSES):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            got = idx.search_many(queries, sp)
            ms.append((time.perf_counter() - t0) * 1e3)
        stats = dict(search_mod.EXEC_STATS)
        launches = launch_counts()
    finally:
        for name, fn in routers.items():
            setattr(search_mod, name, fn)
    if stats.get("candidate", 0) <= 0 or any(
            stats.get(key, 0) for key in ("prefix", "sliced", "blockdense")):
        raise AssertionError(f"candidate route: only candidate / dense rows "
                             f"expected, got {stats}")
    for q, w, g in zip(queries, want, got):
        same_answer(w, g, q)
    check_finite(got)
    log(f"fallback phase (b) candidate: {N_CAND} mixed-trace queries "
        f"through search_many with the other routers off: median "
        f"{median(ms):.3f} ms per call of {[round(x, 3) for x in ms]} "
        f"({card}); candidate {stats['candidate']} rows, dense "
        f"{stats.get('dense', 0)}; answers equal the default routes'; "
        f"kernel launches {launches}")
    out["candidate"] = {"ms_per_call": median(ms), "ms": ms,
                        "rows": stats["candidate"],
                        "dense_rows": stats.get("dense", 0),
                        "launches": launches}
    out["prefix_wide"] = prefix_wide_phase(idx, sp, card)
    return out


def prefix_wide_phase(idx, sp, card: str) -> dict:
    """Fallback phase (c): impact-prefix plans with wide terms (R > 0,
    search._PREFIX_MAX_WIDE = 4) for N_WIDE make_queries (seed 42) and
    every wide term alone (its top impacts beat its tail, so rows
    certify), through search_many, search_pipelined and Index.search,
    each answer held to the MAX_WIDE = 0 answer.  At least one R > 0
    row must certify; search_many's R > 0 groups are replayed on the
    CPU and must agree with the card's (scores within TOL, exact flags
    equal)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    import bench
    from nxsearch_tpu_torch import search as search_mod
    from nxsearch_tpu_torch.ops import executor

    dev = idx.dev
    words, probs = vocab()
    wide_ids = np.nonzero(np.asarray(dev.prefix_start_lookup) >= 0)[0]
    wide_qs = [str(idx.host.term_values[t - 1]) for t in wide_ids]
    queries = bench.make_queries(N_WIDE, words, probs,
                                 np.random.default_rng(42)) + wide_qs
    batches = [queries[i: i + WIDE_BATCH]
               for i in range(0, len(queries), WIDE_BATCH)]
    singles = queries[:N_WIDE_SINGLE] + wide_qs[:8]
    base = idx.search_many(queries, sp)
    base_single = base[:N_WIDE_SINGLE] + base[N_WIDE:N_WIDE + 8]
    real = executor.prefix_topk_packed
    calls = []

    def capture(*a, **kw):
        packed = real(*a, **kw)
        if kw["R"] > 0 and len(calls) < 16:
            calls.append((a, kw, packed))
        return packed

    saved = search_mod._PREFIX_MAX_WIDE
    try:
        search_mod._PREFIX_MAX_WIDE = 4
        spp = search_mod.get_search_params(idx.algo, sp)
        plans = search_mod._build_plans(dev, search_mod._prepare_many(
            dev, idx.pipeline, queries, spp, idx._fuzzy_lookup,
            idx._fuzzy_prefetch), spp)
        n_wide = sum(p is not None and p.pf and len(p.pf_tail) > 0
                     for p in plans)
        n_pf = sum(p is not None and p.pf for p in plans)
        idx.search_many(queries[:64], sp)                # warm-up
        torch.cuda.synchronize()
        reset_counts()
        executor.prefix_topk_packed = capture
        try:
            t0 = time.perf_counter()
            many = idx.search_many(queries, sp)
            t_many = time.perf_counter() - t0
        finally:
            executor.prefix_topk_packed = real
        many_stats = dict(search_mod.EXEC_STATS)
        t0 = time.perf_counter()
        piped = [r for b in idx.search_pipelined(batches, sp) for r in b]
        t_piped = time.perf_counter() - t0
        t0 = time.perf_counter()
        single = [idx.search(q, sp) for q in singles]
        t_single = time.perf_counter() - t0
        stats = {key: search_mod.EXEC_STATS.get(key, 0) for key in (
            "prefix", "prefix_exact", "prefix_fallback",
            "prefix_spec_used")}
        launches = launch_counts()
    finally:
        search_mod._PREFIX_MAX_WIDE = saved
    for labels, want, answers in ((queries, base, many),
                                  (queries, base, piped),
                                  (singles, base_single, single)):
        for q, w, g in zip(labels, want, answers):
            same_answer(w, g, q)
    # R = 0 rows are exact by construction, so search_many's exact rows
    # beyond them are the certified R > 0 rows.
    certified = many_stats.get("prefix_exact", 0) - (n_pf - n_wide)
    if many_stats.get("prefix", 0) != n_pf or certified <= 0 \
            or stats["prefix_fallback"] <= 0:
        raise AssertionError(
            f"R > 0: {n_pf} prefix plans, {n_wide} of them R > 0, "
            f"expected prefix rows, certified R > 0 rows and fallbacks: "
            f"search_many {many_stats}, all entry points {stats}")

    # The card's R > 0 groups against the same calls on the CPU.
    if not calls:
        raise AssertionError("R > 0: no prefix_topk_packed call captured")
    cpu_pack = dev.postings_pack.cpu()
    err = 0.0
    for a, kw, packed in calls:
        want = real(*[cpu_pack if x is dev.postings_pack else
                      (x.cpu() if torch.is_tensor(x) else x) for x in a],
                    **kw)
        got = packed.cpu()
        if not torch.equal(got[:, 2], want[:, 2]):
            raise AssertionError("R > 0: exact flags differ card vs CPU")
        err = max(err, float((got[:, 0] - want[:, 0]).abs().max()))
        for r in range(got.shape[0]):
            same_answer(
                SimpleNamespace(results=list(zip(want[r, 1].tolist(),
                                                 want[r, 0].tolist()))),
                SimpleNamespace(results=list(zip(got[r, 1].tolist(),
                                                 got[r, 0].tolist()))),
                f"R > 0 group row {r}")
    region = dict(dev.prefix_stats)
    n_q = len(queries)
    log(f"fallback phase (c) prefix R > 0 ({card}): {n_q} queries "
        f"({N_WIDE} make_queries, {len(wide_qs)} wide terms alone): "
        f"{n_pf} prefix plans, {n_wide} R > 0, {certified} of them "
        f"certified in search_many; search_many {n_q / t_many:.1f} QPS, "
        f"search_pipelined (batches of {WIDE_BATCH}) "
        f"{n_q / t_piped:.1f} QPS, Index.search "
        f"{t_single / len(singles) * 1e3:.3f} ms per query; counters over "
        f"the three {stats}; region: {region['wide_terms']} wide terms, "
        f"{region['bytes']} bytes, built in {region['seconds']:.3f} s; "
        f"every answer equals the MAX_WIDE = 0 answer; {len(calls)} R > 0 "
        f"groups agree with the CPU (max |diff| {err}); kernel launches "
        f"{launches}")
    return {"qps_many": n_q / t_many, "qps_pipelined": n_q / t_piped,
            "ms_per_search": t_single / len(singles) * 1e3,
            "plans_wide": n_wide, "certified_wide": certified,
            "stats": stats, "region": region, "replayed": len(calls),
            "replay_max_abs_err": err, "launches": launches}


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


def percentile_ms(seconds, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def up_to_ties(deep, got, q) -> None:
    """``got`` (top 10) against ``deep`` (a deeper ranking of the same
    query on another build of the corpus): scores in rank order within
    TOL, and each id one that ``deep`` ranks with its score within TOL
    -- or, past the end of ``deep``, one whose score ties its last."""
    ref = dict(deep.results)
    sc_r = [s for _, s in deep.results]
    ids_g = [d for d, _ in got.results]
    if len(ids_g) != min(10, len(sc_r)) or len(set(ids_g)) != len(ids_g):
        raise AssertionError(f"{q!r}: {got.results} vs {deep.results[:10]}")
    for (d, s), want in zip(got.results, sc_r):
        tied_past_end = (len(sc_r) == PAR_DEEP
                         and abs(s - sc_r[-1]) <= TOL)
        if abs(s - want) > TOL or not (
                (d in ref and abs(ref[d] - s) <= TOL) or tied_past_end):
            raise AssertionError(f"{q!r}: doc {d} score {s} vs "
                                 f"{deep.results[:10]}")


def parallel_ingest_phase(idx, sp, ingest_s: float, card: str,
                          device: str = "cuda") -> dict:
    """Phase 11: parallel_ingest of the same tier into a second basedir,
    its counts and answers held to phase 3's index."""
    import functools
    import shutil

    import numpy as np
    import torch

    import bench
    from nxsearch_tpu_torch import Nxs, Params, parallel_ingest

    workers = min(INGEST_WORKERS, os.cpu_count() or 1)
    pdir = tempfile.mkdtemp(prefix="nxs_parallel_")
    try:
        boot = Nxs(pdir, device="cpu")
        boot.index_create("bench")
        boot.close()
        t0 = time.perf_counter()
        parallel_ingest(pdir, "bench", functools.partial(
            bench.zipf_range, vocab=VOCAB, mean_len=MEAN_LEN), N_DOCS,
            workers=workers)
        par_s = time.perf_counter() - t0
        log(f"parallel ingest ({card}): {N_DOCS} docs, {workers} workers, "
            f"{par_s} s, {N_DOCS / par_s} docs/s; serial add_many (phase "
            f"3) {ingest_s} s, {N_DOCS / ingest_s} docs/s")
        mem0 = torch.cuda.memory_allocated()
        nxs = Nxs(pdir, device=device)
        try:
            t0 = time.perf_counter()
            pidx = nxs.index_open("bench")
            got_stats = pidx.stats()
            open_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            pidx.search("w00001", sp)            # builds the snapshot
            torch.cuda.synchronize()
            snap_s = time.perf_counter() - t0
            mem = torch.cuda.memory_allocated() - mem0
            want_stats = idx.stats()
            for key in ("doc_count", "term_count", "token_count"):
                if got_stats[key] != want_stats[key]:
                    raise AssertionError(f"parallel ingest {key}: "
                                         f"{got_stats} vs {want_stats}")
            queries, _batches, _fuzzy = workload()
            sample = [queries[int(i)] for i in np.random.default_rng(11)
                      .choice(len(queries), N_PAR_CHECK, replace=False)]
            got = pidx.search_many(sample, sp)
            deep = idx.search_many(sample, Params().set_uint("limit",
                                                             PAR_DEEP))
            for q, d, g in zip(sample, deep, got):
                up_to_ties(d, g, q)
            check_finite(got)
            del pidx
        finally:
            nxs.close()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(pdir)
    log(f"parallel ingest ({card}): counts equal phase 3's "
        f"({got_stats['doc_count']} docs, {got_stats['term_count']} terms, "
        f"{got_stats['token_count']} tokens); "
        f"open {open_s} s, snapshot {snap_s} s, {mem / 2**30} GiB "
        f"allocated on the card; {N_PAR_CHECK} sampled answers equal "
        "phase 3's up to ties")
    return {"seconds": par_s, "docs_per_s": N_DOCS / par_s,
            "workers": workers, "serial_seconds": ingest_s,
            "open_s": open_s, "snapshot_s": snap_s, "device_gib": mem / 2**30}


def http_json(conn, method: str, path: str, body=None):
    """(status, decoded JSON body or None) of one request on a
    keep-alive connection."""
    conn.request(method, path, body=body)
    r = conn.getresponse()
    data = r.read()
    return r.status, (json.loads(data) if data else None)


def as_response(obj):
    """A response body's results as a (doc_id, score) list holder, for
    same_answer."""
    from types import SimpleNamespace
    return SimpleNamespace(results=[(r["doc_id"], r["score"])
                                    for r in obj["results"]])


def post_batches(port: int, queries: list[str], clients: int):
    """POST /bench/search_batch?limit=10 from ``clients`` keep-alive
    client threads, SVC_REQ queries per request: (seconds, request
    latencies in s, the responses in query order, statuses)."""
    import http.client
    import threading
    from concurrent.futures import ThreadPoolExecutor

    reqs = [queries[i: i + SVC_REQ] for i in range(0, len(queries), SVC_REQ)]
    lock = threading.Lock()
    todo = iter(range(len(reqs)))
    out = [None] * len(reqs)
    lats, statuses = [], []

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            while True:
                with lock:
                    i = next(todo, None)
                if i is None:
                    return
                body = json.dumps({"queries": reqs[i]}).encode()
                t0 = time.perf_counter()
                status, payload = http_json(
                    conn, "POST", "/bench/search_batch?limit=10", body)
                dt = time.perf_counter() - t0
                with lock:
                    lats.append(dt)
                    statuses.append(status)
                if status != 200 or len(payload["responses"]) != len(reqs[i]):
                    raise AssertionError(f"search_batch: {status} {payload}")
                out[i] = payload["responses"]
        finally:
            conn.close()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        for f in [pool.submit(client) for _ in range(clients)]:
            f.result()
    return (time.perf_counter() - t0, lats,
            [r for chunk in out for r in chunk], statuses)


def route_counts() -> dict:
    from nxsearch_tpu_torch import search as search_mod
    return {key: search_mod.EXEC_STATS.get(key, 0) for key in (
        "prefix", "sliced", "blockdense", "candidate", "dense")}


def service_phase(workdir: str, idx, sp, card: str,
                  device: str = "cuda") -> dict:
    """Phase 12: SearchService over phase 3's basedir behind a
    ThreadingHTTPServer in this process; batched, typo, sequential and
    boolean traffic over HTTP, each answer held to the library
    handle's."""
    import http.client
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    import bench
    from nxsearch_tpu_torch.service.app import SearchService, make_handler

    words, probs = vocab()
    queries, _batches, _fuzzy = workload()
    rng = np.random.default_rng(48)
    typo_batch = bench.make_fuzzy_queries(N_FUZZY, words, probs, rng, "k")
    seq_typo = bench.make_fuzzy_queries(N_SEQ, words, probs, rng, "m")
    seq_plain = bench.make_queries(N_SEQ, words, probs, rng)
    mixed = bench.make_mixed_queries(N_SEQ, words, probs, rng)
    typo_warm = bench.make_fuzzy_queries(SVC_REQ, words, probs, rng, "n")
    statuses = []

    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    svc = SearchService(workdir, device=device)

    class Handler(make_handler(svc)):
        def log_message(self, fmt, *args):    # no access log on stdout
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    port = httpd.server_address[1]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        status, stats = http_json(conn, "GET", "/bench/stats")
        statuses.append(status)
        open_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        status, _ = http_json(conn, "POST", "/bench/search", b"w00001")
        statuses.append(status)
        torch.cuda.synchronize()
        snap_s = time.perf_counter() - t0
        mem = torch.cuda.memory_allocated() - mem0
        want_stats = idx.stats()
        if status != 200 or any(stats[k] != want_stats[k] for k in (
                "doc_count", "term_count", "token_count")):
            raise AssertionError(f"/bench/stats: {stats} vs {want_stats}")

        # Batched traffic: one warm-up pass, one measured pass.
        statuses += post_batches(port, queries, SVC_CLIENTS)[3]
        torch.cuda.synchronize()
        reset_counts()
        wall, lats, got, st = post_batches(port, queries, SVC_CLIENTS)
        statuses += st
        svc_routes = route_counts()
        reset_counts()
        want = idx.search_many(queries, sp)
        lib_routes = route_counts()
        for q, w, g in zip(queries, want, got):
            same_answer(w, as_response(g), q)
        if svc_routes != lib_routes or sum(svc_routes.values()) <= 0:
            raise AssertionError(f"route counters: service {svc_routes}, "
                                 f"library {lib_routes}")
        qps = len(queries) / wall
        p50, p99 = percentile_ms(lats, 50), percentile_ms(lats, 99)
        log(f"service ({card}): {len(queries)} queries in requests of "
            f"{SVC_REQ} from {SVC_CLIENTS} keep-alive clients: {qps} QPS, "
            f"request p50 {p50} ms, p99 {p99} ms; routes {svc_routes} "
            f"(the library's on the same queries: equal); open {open_s} s, "
            f"snapshot {snap_s} s, {mem / 2**30} GiB allocated on the card")
        # What the request threads cost: the same requests from one
        # client, and the library on the same chunks on one thread.
        wall, _lats, _got, st = post_batches(port, queries, 1)
        statuses += st
        qps_one = len(queries) / wall
        t0 = time.perf_counter()
        for i in range(0, len(queries), SVC_REQ):
            idx.search_many(queries[i: i + SVC_REQ], sp)
        lib_qps = len(queries) / (time.perf_counter() - t0)
        log(f"service ({card}): the same requests from one client: "
            f"{qps_one} QPS; library search_many over the same "
            f"{SVC_REQ}-query chunks on one thread: {lib_qps} QPS")

        # Batched typos, after one request of other typos builds the
        # service handle's fuzzy matcher.
        statuses += post_batches(port, typo_warm, SVC_CLIENTS)[3]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        _, _, got, st = post_batches(port, typo_batch, SVC_CLIENTS)
        typo_s = time.perf_counter() - t0
        statuses += st
        typo_launches = myers_counts()
        if typo_launches["fwd"] <= 0:
            raise AssertionError(f"batched typos: no forward Myers launch "
                                 f"({typo_launches})")
        for q, w, g in zip(typo_batch, idx.search_many(typo_batch, sp), got):
            same_answer(w, as_response(g), q)
        log(f"service ({card}): {N_FUZZY} typo queries through "
            f"search_batch: {N_FUZZY / typo_s} QPS; launches "
            f"{typo_launches}")

        # Sequential: one query per request, typos then plain queries.
        seen = typos_of(idx, queries + typo_warm + typo_batch)
        expect = typos_of(idx, seq_typo + seq_plain) - seen
        reset_counts()
        seq_s, got = [], []
        for q in seq_typo + seq_plain:
            t0 = time.perf_counter()
            status, payload = http_json(conn, "POST", "/bench/search?limit=10",
                                        q.encode())
            seq_s.append(time.perf_counter() - t0)
            statuses.append(status)
            got.append(payload)
        seq_launches = myers_counts()
        if seq_launches != {"fwd": 0, "one": len(expect), "rev": 0} \
                or not expect:
            raise AssertionError(f"sequential: one single-query launch per "
                                 f"distinct uncached typo ({len(expect)}) "
                                 f"expected: {seq_launches}")
        for q, w, g in zip(seq_typo + seq_plain,
                           idx.search_many(seq_typo + seq_plain, sp), got):
            same_answer(w, as_response(g), q)
        seq_p50, seq_p99 = percentile_ms(seq_s, 50), percentile_ms(seq_s, 99)
        log(f"service ({card}): sequential /bench/search, {N_SEQ} typo and "
            f"{N_SEQ} plain queries: p50 {seq_p50} ms, p99 {seq_p99} ms "
            f"(typo p50 {percentile_ms(seq_s[:N_SEQ], 50)}, plain p50 "
            f"{percentile_ms(seq_s[N_SEQ:], 50)}); {len(expect)} distinct "
            f"uncached typos, launches {seq_launches}")

        # Boolean rows, one per request.
        got = []
        for q in mixed:
            status, payload = http_json(conn, "POST", "/bench/search?limit=10",
                                        q.encode())
            statuses.append(status)
            got.append(payload)
        for q, w, g in zip(mixed, idx.search_many(mixed, sp), got):
            same_answer(w, as_response(g), q)
        status, stats = http_json(conn, "GET", "/bench/stats")
        statuses.append(status)
        if any(stats[k] != want_stats[k] for k in (
                "doc_count", "term_count", "token_count")):
            raise AssertionError(f"/bench/stats: {stats} vs {want_stats}")
        bad, _ = http_json(conn, "POST", "/~")
        if bad != 400:
            raise AssertionError(f"POST /~ answered {bad}")
    finally:
        conn.close()
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    if any(s != 200 for s in statuses):
        raise AssertionError(f"statuses: {sorted(set(statuses))}")
    log(f"service ({card}): {len(statuses)} requests, every one 200; every "
        "answer equals the library's; /bench/stats equals phase 3's "
        "counts; POST /~ answered 400")
    return {"qps": qps, "request_p50_ms": p50, "request_p99_ms": p99,
            "qps_one_client": qps_one, "library_qps_same_chunks": lib_qps,
            "routes": svc_routes, "typo_qps": N_FUZZY / typo_s,
            "typo_launches": typo_launches, "seq_p50_ms": seq_p50,
            "seq_p99_ms": seq_p99, "seq_launches": seq_launches,
            "seq_typos": len(expect), "open_s": open_s,
            "snapshot_s": snap_s, "device_gib": mem / 2**30,
            "requests": len(statuses)}


def run_phase(name: str, card: str, fn, *args):
    """Run one phase and log its seconds beside the card."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"{name}: {time.perf_counter() - t0} s ({card})")
    return out


def tie_same(ref, got, q) -> bool:
    """same_answer's rule, or, where that fails, ids equal up to a group
    of near-equal scores: each id stands at a rank whose ``ref`` score
    is within TOL of its own, or ties ``ref``'s last score (the limit's
    cut).  Returns False when only the second rule held; raises when
    neither did."""
    try:
        same_answer(ref, got, q)
        return True
    except AssertionError:
        pass
    ids_r = [d for d, _ in ref.results]
    sc_r = [s for _, s in ref.results]
    ids_g = [d for d, _ in got.results]
    if len(ids_g) != len(ids_r) or any(
            abs(a - b) > TOL for (_, a), b in zip(got.results, sc_r)):
        raise AssertionError(f"{q!r}: {got.results} vs {ref.results}")
    rank = {d: i for i, d in enumerate(ids_r)}
    for i, d in enumerate(ids_g):
        j = rank.get(d)
        if abs(sc_r[i] - (sc_r[-1] if j is None else sc_r[j])) > TOL:
            raise AssertionError(f"{q!r} rank {i}: {ids_g} vs {ids_r}")
    return False


def mesh_phase(workdir: str, idx, sp, card: str, single: dict,
               device: str = "cuda") -> dict:
    """Phase 14: the doc-sharded mesh over phase 3's basedir, MESH_SHARDS
    shards of one card, every answer held to the single-device port's
    (``idx``) on the same index; ``single`` holds phases 3 and 6's
    QPS."""
    import numpy as np
    import torch

    import bench
    from nxsearch_tpu_torch import Nxs
    from nxsearch_tpu_torch import search as search_mod
    from nxsearch_tpu_torch.ops import executor, kernels
    from nxsearch_tpu_torch.parallel import dryrun_multichip, make_mesh

    card0 = torch.device("cuda", 0) if device == "cuda" \
        else torch.device(device)
    words, probs = vocab()
    out = {"tie_groups": 0}
    launches = {k.symbol: 0 for k in all_kernels()}

    def drive(name, fn):
        """One mesh drive: the counts from zero just before it and read
        just after; (result, seconds, route counters)."""
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for key, n in launch_counts().items():
            launches[key] += n
        stats = dict(sorted(search_mod.EXEC_STATS.items()))
        log(f"mesh {name} ({card}): {seconds} s; routes {stats}; kernel "
            f"launches {launch_counts()}")
        return result, seconds, stats

    def check(queries, want, got):
        for q, w, g in zip(queries, want, got):
            out["tie_groups"] += not tie_same(w, g, q)
        check_finite(got)

    nxs = Nxs(workdir, mesh=make_mesh([card0] * MESH_SHARDS))
    try:
        midx = nxs.index_open("bench")
        t0 = time.perf_counter()
        midx.search("w00001", sp)          # builds the shards
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        dev = midx.dev
        shard_bytes = [sum(int(t[d].numel()) * t[d].element_size()
                           for t in (dev.postings_pack, dev.postings_slot,
                                     dev.postings_ltf, dev.doc_len,
                                     dev.alive_mask, dev.dense_rows)
                           if t is not None) for d in range(dev.n_dev)]
        dense_rows = [int(t.shape[0]) for t in dev.dense_rows or ()]
        if not all(t.device.type == card0.type
                   for t in dev.postings_pack + dev.alive_mask):
            raise AssertionError("mesh shards are not on the card")
        log(f"mesh snapshot ({card}): {dev.n_dev} shards of "
            f"{dev.slots_per_shard} slots, build {build_s} s, bytes per "
            f"shard {shard_bytes}, dense rows per shard {dense_rows}")
        out.update(build_s=build_s, shard_bytes=shard_bytes,
                   dense_rows=dense_rows, slots_per_shard=dev.slots_per_shard)

        # Pure-OR: the R = 0 prefix body (rows with a dense-row term take
        # the sliced dense-row hybrid body).
        queries, batches, _fuzzy = workload()
        midx.search_pipelined(batches[:1], sp)          # warm-up
        got, sec, stats = drive("pure-OR search_pipelined", lambda:
                                midx.search_pipelined(batches, sp))
        if (stats.get("sharded_prefix", 0) + stats.get("sharded_sliced", 0)
                != N_QUERIES or stats.get("sharded_prefix", 0) <= 0
                or stats.get("prefix", 0) != stats["sharded_prefix"]):
            raise AssertionError(f"mesh pure-OR: every row on the mesh "
                                 f"prefix or sliced body expected: {stats}")
        want = idx.search_many(queries, sp)
        check(queries, want, [r for b in got for r in b])
        out["qps"] = N_QUERIES / sec
        out["stats"] = stats

        # Mixed trace: sliced rows and fallback rows.
        mixed = bench.make_mixed_queries(N_MIXED, words, probs,
                                         np.random.default_rng(43))
        mbatches = [mixed[i: i + BATCH] for i in range(0, N_MIXED, BATCH)]
        midx.search_pipelined(mbatches[:1], sp)         # warm-up
        got, sec, stats = drive("mixed search_pipelined", lambda:
                                midx.search_pipelined(mbatches, sp))
        if (stats.get("sharded_sliced", 0) <= 0
                or stats.get("sharded_fallback", 0) <= 0):
            raise AssertionError(f"mesh mixed: sliced and fallback rows "
                                 f"expected: {stats}")
        want = idx.search_many(mixed, sp)
        check(mixed, want, [r for b in got for r in b])
        out["mixed_qps"] = N_MIXED / sec
        out["mixed_stats"] = stats

        # Blockdense: masked rows with a dense-row term run the kernel
        # body, the segsum kernel once per shard and 8-term group; the
        # first launch's inputs replayed through its plain twin.
        bdq = bd_queries(idx)
        midx.search_many(bdq[:64], sp)                  # warm-up
        captured = []
        real = executor.blockdense_scores

        def capture(*a, **kw):
            res = real(*a, **kw)
            if not captured:
                captured.append((a, kw, tuple(t.clone() for t in res)))
            return res

        executor.blockdense_scores = capture
        try:
            got, sec, stats = drive("blockdense search_many", lambda:
                                    midx.search_many(bdq, sp))
        finally:
            executor.blockdense_scores = real
        seg = kernels.SEGSUM.launches
        if stats.get("sharded_fallback", 0) != N_BD or seg < MESH_SHARDS:
            raise AssertionError(f"mesh blockdense: {N_BD} kernel-body rows "
                                 f"and a segsum launch per shard expected: "
                                 f"{stats}, {seg}")
        a, kw, (k_scores, k_bits) = captured[0]
        r_scores, r_bits = kernels.blockdense_scores_ref(*a, **kw)
        torch.cuda.synchronize()
        bd_err = float((k_scores - r_scores).abs().max())
        if not (torch.equal(k_scores, r_scores)
                and torch.equal(k_bits, r_bits)):
            raise AssertionError(f"mesh segsum launch disagrees with its "
                                 f"twin: max |diff| {bd_err}")
        want = idx.search_many(bdq, sp)
        check(bdq, want, got)
        out.update(bd_qps=N_BD / sec, bd_segsum_launches=seg,
                   bd_replay_shape=list(a[4].shape), bd_max_abs_err=bd_err)
        log(f"mesh blockdense: {seg} segsum launches; a launch of bounds "
            f"{list(a[4].shape)} replayed through blockdense_scores_ref: "
            "equal")

        # > 32-term masked queries: the dense body.
        dq = dense_queries(idx)[:N_MESH_DENSE]
        got, sec, stats = drive("dense search_many", lambda:
                                midx.search_many(dq, sp))
        if stats.get("sharded_fallback", 0) != len(dq):
            raise AssertionError(f"mesh dense: {len(dq)} rows expected: "
                                 f"{stats}")
        check(dq, idx.search_many(dq, sp), got)
        out["dense_qps"] = len(dq) / sec

        # One query at a time, typos included (the single-query Myers
        # kernel on mesh[0]).
        sq = bench.make_fuzzy_queries(N_MESH_SINGLE // 2, words, probs,
                                      np.random.default_rng(51), "t")
        sq += queries[: N_MESH_SINGLE - len(sq)]
        got, sec, stats = drive("Index.search", lambda:
                                [midx.search(q, sp) for q in sq])
        if kernels.MYERS_ONE.launches <= 0:
            raise AssertionError("mesh Index.search: no single-query "
                                 "Myers launch")
        check(sq, [idx.search(q, sp) for q in sq], got)
        out["ms_per_search"] = sec * 1e3 / len(sq)

        # A removal: the alive bitmaps flip, the shards stay.
        victim = got[-1].results[0][0]
        pack, gen = dev.postings_pack, dev.generation
        midx.remove(victim)
        q = sq[-1]
        after = midx.search(q, sp)
        if (victim in dict(after.results) or dev.postings_pack is not pack
                or dev.generation == gen or dev.alive_all):
            raise AssertionError("mesh removal: expected a bitmap flip, "
                                 "no rebuild, the document gone")
        tie_same(idx.search(q, sp), after, q)
        log(f"mesh removal ({card}): doc {victim} gone, the shards kept, "
            "the answer equal to the single device's")
    finally:
        nxs.close()
    dryrun_multichip(2, devices=[card0] * 2)
    torch.cuda.empty_cache()
    out["launches"] = launches
    log(f"mesh phase ({card}): pure-OR {out['qps']} QPS (single device, "
        f"phase 3: {single['qps']}), mixed {out['mixed_qps']} QPS (phase "
        f"6: {single['mixed_qps']}), blockdense {out['bd_qps']} QPS, dense "
        f"{out['dense_qps']} QPS, Index.search {out['ms_per_search']} ms; "
        f"every answer equal to the single device's ({out['tie_groups']} "
        "up to a group of near-equal scores); dryrun_multichip(2) passed; "
        f"launches {launches}")
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def entry_point_phase(workdir: str, idx, sp, card: str,
                      device: str = "cuda") -> dict:
    """Phase 13: ``python -m nxsearch_tpu_torch.service`` and
    ``python -m nxsearch_tpu_torch.benchmark`` as subprocesses over
    phase 3's basedir, each answer held to the library's."""
    import http.client
    import urllib.request

    import numpy as np
    import torch

    import bench

    words, probs = vocab()
    q_svc = bench.make_fuzzy_queries(1, words, probs,
                                     np.random.default_rng(50), "p")[0]
    q_cli = workload()[0][1]
    free0, _total = torch.cuda.mem_get_info()
    port = free_port()
    with tempfile.TemporaryFile("w+") as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "nxsearch_tpu_torch.service",
             "--basedir", workdir, "--device", device, "--host",
             "127.0.0.1", "--port", str(port)], cwd=ROOT, stdout=out,
            stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"service exited {proc.returncode}")
                if time.perf_counter() - t0 > SVC_OPEN_LIMIT_S:
                    raise AssertionError("service not ready in "
                                         f"{SVC_OPEN_LIMIT_S} s")
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/bench/stats",
                            timeout=60) as r:
                        if r.status == 200:
                            break
                except OSError:
                    time.sleep(0.5)
            ready_s = time.perf_counter() - t0
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            t0 = time.perf_counter()
            status, payload = http_json(conn, "POST", "/bench/search?limit=10",
                                        q_svc.encode())
            first_s = time.perf_counter() - t0
            conn.close()
            svc_gib = (free0 - torch.cuda.mem_get_info()[0]) / 2**30
            if status != 200:
                raise AssertionError(f"service search: {status} {payload}")
            same_answer(idx.search(q_svc, sp), as_response(payload), q_svc)
        except BaseException:
            out.seek(0)
            log(f"service output:\n{out.read()[-4000:]}")
            raise
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    log(f"entry points ({card}): python -m nxsearch_tpu_torch.service "
        f"ready in {ready_s} s (start, torch import, index open), first "
        f"/bench/search (snapshot build, a typo) {first_s} s, "
        f"{svc_gib} GiB of the card taken; its answer equals the library's")

    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "nxsearch_tpu_torch.benchmark", "--basedir",
         workdir, "-i", "bench", "-s", q_cli, "--limit", "10", "--device",
         device], cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if cli.returncode != 0:
        raise AssertionError(f"benchmark CLI exited {cli.returncode}:\n"
                             f"{cli.stdout[-2000:]}\n{cli.stderr[-4000:]}")
    lines = cli.stdout.splitlines()
    answer = [line for line in lines if line.startswith("{")]
    timings = [line for line in lines if line.endswith(" ms")]
    if len(answer) != 1:
        raise AssertionError(f"benchmark CLI output:\n{cli.stdout}")
    same_answer(idx.search(q_cli, sp), as_response(json.loads(answer[0])),
                q_cli)
    log(f"entry points ({card}): python -m nxsearch_tpu_torch.benchmark "
        f"-s {q_cli!r}: exit 0 in {cli_s} s ({'; '.join(timings)}); its "
        "JSON equals the library's answer")
    return {"service_ready_s": ready_s, "service_first_search_s": first_s,
            "service_gib": svc_gib, "cli_s": cli_s, "cli_timings": timings}


def f32_rounded(oracle: HostOracle, responses) -> int:
    """How many answers name a document whose device slot f32 does not
    hold exactly: had the slots ridden in f32 by value, those answers
    would have named another document."""
    import numpy as np

    n = 0
    for r in responses:
        slots = np.asarray([oracle.dev_rank[oracle.slot_of_id[d]]
                            for d, _ in r.results], dtype=np.int64)
        n += bool((slots.astype(np.float32).astype(np.int64) != slots).any())
    return n


def targeted_docs(idx, rng, perm=None):
    """N_ODD documents in odd and N_EVEN in even device slots from
    LARGE_SLOT_FROM up, each with a term of df <= LARGE_DF_MAX (one term
    per document, none twice): [(doc id, device slot, term id)].
    ``perm`` maps a device slot to its host slot (the snapshot's
    ``slot_perm`` by default; a mesh's global slot is its host slot)."""
    host = idx.host
    perm = idx.dev.slot_perm if perm is None else perm
    df = host.term_df.view()
    n_host = len(perm)
    want = {1: N_ODD, 0: N_EVEN}
    out, used = [], set()
    for s in rng.permutation(n_host - LARGE_SLOT_FROM) + LARGE_SLOT_FROM:
        s = int(s)
        if not want[s % 2]:
            continue
        h = int(perm[s])
        start, n = int(host.doc_start.a[h]), int(host.doc_n.a[h])
        for t in host.p_term.a[start: start + n].tolist():
            if df[t - 1] <= LARGE_DF_MAX and t not in used:
                used.add(t)
                out.append((int(host.doc_ids.a[h]), s, t))
                want[s % 2] -= 1
                break
        if not any(want.values()):
            return out
    raise AssertionError(f"documents past {LARGE_SLOT_FROM} with a term "
                         f"of df <= {LARGE_DF_MAX}: {len(out)} found")


def large_phase(sp, card: str, device: str = "cuda") -> dict:
    """Phase 15: a snapshot of 2**24 device slots and more.

    N_LARGE documents of bench.zipf_range (the 1M tier's vocabulary and
    generator) at mean length LARGE_MEAN_LEN, through Index.add_many
    into a basedir of its own, then a snapshot on ``device``:
    17,825,792 device slots.  What is cut is document length (40 tokens
    in the 1M tier, about 100 in a DPR passage, about 6 here), so that
    the ingest fits the script's time; the slot count, which this
    phase is about, is not cut.  The planner gates the impact-prefix,
    sliced and blockdense routes below 2**24 slots, as the reference's
    does, so every row takes the candidate or dense executor, which
    read the snapshot's exact int32 slot column.

    Traffic, each drive with the counts from zero: N_LARGE_QUERIES
    make_queries (seed 42) through search_pipelined in batches of
    BATCH, N_LARGE_FUZZY typo queries and N_LARGE_MIXED mixed-trace
    queries (seed 43) through search_many (forward Myers launches),
    N_LARGE_SINGLE Index.search calls, half of them typos (single-query
    Myers launches), N_LARGE_DENSE > 32-term masked queries (the dense
    executor's [rows, S_pad] plane).  Checked: the routes, the numpy
    oracles on sampled answers, documents in odd and even device slots
    from 2**24 up found by a term of df <= LARGE_DF_MAX with the
    oracle's scores, the index on a mesh of one device (large_mesh),
    and a removal of one of the documents."""
    import shutil

    import numpy as np
    import torch

    import bench
    import bench_torch
    from nxsearch_tpu_torch import Nxs, Params
    from nxsearch_tpu_torch import search as search_mod

    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated() if on_card else 0
    words, probs = vocab()
    out = {"docs": N_LARGE}
    served = [0]
    submit = search_mod._submit_plans

    def counted(dev_, plans, *a, **kw):
        served[0] += sum(p is not None for p in plans)
        return submit(dev_, plans, *a, **kw)

    totals = {}

    def drive(name, fn, rows=None):
        """Run ``fn`` with the counts from zero; every row must take
        the candidate or dense executor."""
        if on_card:
            torch.cuda.synchronize()
        reset_counts()
        served[0] = 0
        t0 = time.perf_counter()
        got = fn()
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stats = dict(search_mod.EXEC_STATS)
        launches = launch_counts()
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        rows = served[0] if rows is None else rows
        plain = stats.get("candidate", 0) + stats.get("dense", 0)
        if any(stats.get(k, 0) for k in ("prefix", "sliced", "blockdense")) \
                or plain != rows or not rows:
            raise AssertionError(f"phase 15 {name}: {rows} rows on the "
                                 f"candidate / dense executors expected, "
                                 f"got {stats}")
        out[name] = {"seconds": dt, "stats": stats, "launches": launches}
        return got, dt

    ldir = tempfile.mkdtemp(prefix="nxs_large_")
    nxs = Nxs(ldir, device=device)
    search_mod._submit_plans = counted
    try:
        idx = nxs.index_create("large")
        ingest_s = bench_torch.add_zipf(idx, N_LARGE, VOCAB, LARGE_MEAN_LEN,
                                        workers=LARGE_GEN_WORKERS,
                                        chunk=LARGE_CHUNK)
        log(f"phase 15 ingest ({card}): {N_LARGE} docs (mean length "
            f"{LARGE_MEAN_LEN}) through add_many in {ingest_s} s, "
            f"{N_LARGE / ingest_s} docs/s; {idx.host.p_term.n} postings")
        t0 = time.perf_counter()
        idx.search("w00001", sp)                 # builds the snapshot
        if on_card:
            torch.cuda.synchronize()
        snap_s = time.perf_counter() - t0
        dev = idx.dev
        tensors = {"postings_pack": dev.postings_pack,
                   "slot_column": dev.postings_slot,
                   "dense_rows": dev.dense_rows, "doc_len": dev.doc_len,
                   "alive_mask": dev.alive_mask}
        exact = dev.postings_slot is dev._slot_exact
        if dev.n_slots < LARGE_SLOT_FROM or exact != (
                dev.n_slots >= 1 << 24) or any(
                t.device.type != device for t in tensors.values()):
            raise AssertionError(f"phase 15: a snapshot of {dev.n_slots} "
                                 f"slots (exact slot column: {exact}) on "
                                 f"{device} expected")
        sizes = {k: t.numel() * t.element_size() for k, t in tensors.items()}
        snap_mem = (torch.cuda.memory_allocated() - mem0) if on_card else 0
        log(f"phase 15 snapshot ({card}): {snap_s} s; {dev.n_slots} device "
            f"slots, {dev.n_postings} padded postings, "
            f"{dev.dense_rows.shape[0]} dense rows; bytes {sizes} "
            f"(the exact slot column 4 B a posting); {snap_mem} B "
            "allocated")
        t0 = time.perf_counter()
        oracle = HostOracle(idx)
        log(f"phase 15 oracle build: {time.perf_counter() - t0} s")

        rng = np.random.default_rng(42)
        queries = bench.make_queries(N_LARGE_QUERIES, words, probs, rng)
        batches = [queries[i: i + BATCH]
                   for i in range(0, N_LARGE_QUERIES, BATCH)]
        fuzzy = bench.make_fuzzy_queries(N_LARGE_FUZZY, words, probs,
                                         np.random.default_rng(45), "x")
        mixed = bench.make_mixed_queries(N_LARGE_MIXED, words, probs,
                                         np.random.default_rng(43))
        single = (bench.make_fuzzy_queries(
            N_LARGE_SINGLE // 2, words, probs, np.random.default_rng(46),
            "h") + queries[: N_LARGE_SINGLE // 2])
        dense = dense_queries(idx, N_LARGE_DENSE)

        res, dt = drive("plain", lambda: idx.search_pipelined(batches, sp))
        plain = [r for b in res for r in b]
        out["plain"]["qps"] = N_LARGE_QUERIES / dt
        fz, dt = drive("fuzzy", lambda: idx.search_many(fuzzy, sp))
        out["fuzzy"]["qps"] = N_LARGE_FUZZY / dt
        if out["fuzzy"]["launches"]["nxs_myers_distances"] <= 0:
            raise AssertionError("phase 15: no forward Myers launch")
        mx, dt = drive("mixed", lambda: idx.search_many(mixed, sp))
        out["mixed"]["qps"] = N_LARGE_MIXED / dt
        # The plain half's words were resolved by the plain drive.
        typos = typos_of(idx, single[: N_LARGE_SINGLE // 2])
        times = []

        def singles():
            got = []
            for q in single:
                t1 = time.perf_counter()
                got.append(idx.search(q, sp))
                times.append((time.perf_counter() - t1) * 1e3)
            return got

        one, _dt = drive("single", singles, rows=N_LARGE_SINGLE)
        out["single"]["ms_per_search"] = median(times)
        n_one = out["single"]["launches"]["nxs_myers_distances_one"]
        if n_one != len(typos) or not typos:
            raise AssertionError(f"phase 15: one single-query launch per "
                                 f"distinct typo ({len(typos)}) expected, "
                                 f"got {n_one}")
        dn, dt = drive("dense", lambda: idx.search_many(dense, sp))
        out["dense"]["qps"] = N_LARGE_DENSE / dt
        if out["dense"]["stats"].get("dense", 0) != N_LARGE_DENSE:
            raise AssertionError(f"phase 15: {N_LARGE_DENSE} dense rows "
                                 f"expected: {out['dense']['stats']}")
        for name in ("plain", "fuzzy", "mixed", "single", "dense"):
            got = {"plain": plain, "fuzzy": fz, "mixed": mx, "single": one,
                   "dense": dn}[name]
            check_finite(got)
            o = out[name]
            log(f"phase 15 {name} ({card}): {o['seconds']} s"
                + (f", {o['qps']} QPS" if "qps" in o else "")
                + (f", {o['ms_per_search']} ms per search"
                   if "ms_per_search" in o else "")
                + f"; routes {o['stats']}; launches {o['launches']}")

        # Oracles on sampled answers.
        t0 = time.perf_counter()
        pick = np.random.default_rng(7)
        oracle.n_typos = 0
        for i in pick.choice(N_LARGE_QUERIES, N_LARGE_ORACLE, replace=False):
            oracle.check_plain(queries[int(i)], plain[int(i)])
        for i in pick.choice(N_LARGE_FUZZY, N_LARGE_FUZZY_ORACLE,
                             replace=False):
            oracle.check_plain(fuzzy[int(i)], fz[int(i)])
        if oracle.n_typos < N_LARGE_FUZZY_ORACLE:
            raise AssertionError(f"phase 15: only {oracle.n_typos} typo "
                                 "tokens resolved")
        masked = [i for i, q in enumerate(mixed) if " AND " in q]
        for i in pick.choice(masked, N_LARGE_BOOL_ORACLE, replace=False):
            oracle.check_boolean(mixed[int(i)], mx[int(i)])
        for q, r in zip(dense, dn):
            oracle.check_boolean(q, r)
        log(f"phase 15 oracle: {N_LARGE_ORACLE} plain, "
            f"{N_LARGE_FUZZY_ORACLE} fuzzy, {N_LARGE_BOOL_ORACLE} boolean "
            f"and {N_LARGE_DENSE} dense answers agree "
            f"({time.perf_counter() - t0} s)")

        # Documents past 2**24 in odd and even device slots, each found
        # by a rare term of its own with the oracle's scores.
        docs = targeted_docs(idx, np.random.default_rng(12))
        deep = Params().set_uint("limit", LARGE_DF_MAX)
        terms = [idx.host.term_values[t - 1] for _d, _s, t in docs]
        found = idx.search_many(terms, deep)
        for (doc, slot, t), q, resp in zip(docs, terms, found):
            if doc not in [d for d, _ in resp.results]:
                raise AssertionError(f"phase 15: doc {doc} (device slot "
                                     f"{slot}) missing from {q!r}")
            ids_o, sc_o, acc = oracle_top(oracle.csr, oracle.host, [t],
                                          oracle.dev_rank, LARGE_DF_MAX)
            check_against_oracle(resp, ids_o, sc_o, acc, oracle.slot_of_id,
                                 q)
        odd = sum(s % 2 for _d, s, _t in docs)
        answers = plain + fz + mx + one + dn + found
        rounded = f32_rounded(oracle, answers)
        log(f"phase 15 targeted: {odd} documents in odd and "
            f"{len(docs) - odd} in even device slots from "
            f"{LARGE_SLOT_FROM} (slots {sorted(s for _d, s, _t in docs)}) "
            f"found by their terms with the oracle's scores; "
            f"{rounded} of {len(answers)} answers name a document whose "
            "device slot f32 rounds onto another")

        out["mesh"] = large_mesh(ldir, idx, oracle, sp, dense, device)

        # A removal past 2**24: the document leaves its term's answer.
        gone, slot, t = next(x for x in docs if x[1] % 2)
        before = [d for d, _ in found[docs.index((gone, slot, t))].results]
        idx.remove(gone)
        after = idx.search_many([terms[docs.index((gone, slot, t))]], deep)
        if [d for d, _ in after[0].results] != [d for d in before
                                                  if d != gone]:
            raise AssertionError(f"phase 15: removing doc {gone} (device "
                                 f"slot {slot}): {after[0].results}")
        peak = (torch.cuda.max_memory_allocated() - mem0) if on_card else 0
        log(f"phase 15 removal: doc {gone} (device slot {slot}) left its "
            f"term's answer; peak device memory of the phase {peak} B "
            f"({card})")
        out.update(ingest_s=ingest_s, snapshot_s=snap_s,
                   n_slots=dev.n_slots, n_postings=dev.n_postings,
                   bytes=sizes, snapshot_mem=snap_mem, peak_mem=peak,
                   targeted_odd=odd, targeted=len(docs), f32_rounded=rounded,
                   answers=len(answers), launches=totals)
        return out
    finally:
        search_mod._submit_plans = submit
        nxs.close()
        shutil.rmtree(ldir)
        if on_card:
            torch.cuda.empty_cache()


def large_mesh(basedir: str, idx, oracle: HostOracle, sp, dense,
               device: str) -> dict:
    """Phase 15's index on a mesh of one device (parallel/): a shard of
    2**24 slots or more, served by the mesh's candidate and dense
    bodies over its exact int32 shard column.  N_ODD documents in odd
    and N_EVEN in even global slots from LARGE_SLOT_FROM up (a mesh's
    global slot is its host slot), each by a term of df <=
    LARGE_DF_MAX, and the > 32-term queries ``dense``, with the
    oracle's ids and scores under the mesh's tie rule (lowest host
    slot)."""
    import copy

    import numpy as np
    import torch

    from nxsearch_tpu_torch import Nxs, Params
    from nxsearch_tpu_torch import search as search_mod
    from nxsearch_tpu_torch.parallel import make_mesh

    idx.checkpoint()            # the mesh's handle opens this snapshot
    n_host = idx.host.doc_ids.n
    by_host = copy.copy(oracle)
    by_host.dev_rank = np.arange(n_host)
    docs = targeted_docs(idx, np.random.default_rng(13),
                         perm=np.arange(n_host))
    terms = [idx.host.term_values[t - 1] for _d, _s, t in docs]
    deep = Params().set_uint("limit", LARGE_DF_MAX)
    mnxs = Nxs(basedir, mesh=make_mesh([torch.device(device)]))
    try:
        midx = mnxs.index_open("large")
        t0 = time.perf_counter()
        midx.search("w00001", sp)               # builds the shard
        build_s = time.perf_counter() - t0
        mdev = midx.dev
        if mdev.slots_per_shard < LARGE_SLOT_FROM:
            raise AssertionError(f"phase 15 mesh: a shard of "
                                 f"{mdev.slots_per_shard} slots")
        reset_counts()
        found = midx.search_many(terms, deep)
        dn = midx.search_many(dense, sp)
        stats = dict(search_mod.EXEC_STATS)
        launches = launch_counts()
    finally:
        mnxs.close()
    rows = len(terms) + len(dense)
    if stats.get("sharded_fallback", 0) != rows or any(
            stats.get(k, 0) for k in ("sharded_prefix", "sharded_sliced")):
        raise AssertionError(f"phase 15 mesh: {rows} rows on the "
                             f"candidate / dense bodies expected: {stats}")
    for (doc, slot, t), q, resp in zip(docs, terms, found):
        if doc not in [d for d, _ in resp.results]:
            raise AssertionError(f"phase 15 mesh: doc {doc} (global slot "
                                 f"{slot}) missing from {q!r}")
        ids_o, sc_o, acc = oracle_top(by_host.csr, by_host.host, [t],
                                      by_host.dev_rank, LARGE_DF_MAX)
        check_against_oracle(resp, ids_o, sc_o, acc, by_host.slot_of_id, q)
    for q, r in zip(dense, dn):
        by_host.check_boolean(q, r)
    odd = sum(s % 2 for _d, s, _t in docs)
    log(f"phase 15 mesh of one device: a shard of {mdev.slots_per_shard} "
        f"slots built in {build_s} s; {odd} documents in odd and "
        f"{len(docs) - odd} in even global slots from {LARGE_SLOT_FROM} "
        f"found by their terms and {len(dense)} > 32-term answers, all "
        f"with the oracle's ids and scores; routes {stats}")
    return {"build_s": build_s, "slots_per_shard": mdev.slots_per_shard,
            "targeted": len(docs), "targeted_odd": odd, "stats": stats,
            "launches": launches}


def north_index(nxs):
    """Phase 16's corpus: N_NORTH documents of the north-star tier's
    generator (bench.zipf_range, NORTH_VOCAB words, mean length
    NORTH_MEAN_LEN, seed 42) through Index.add_many
    (bench_torch.add_zipf, texts from spawned processes) into a new
    index "bench" of ``nxs``; returns (index, ingest seconds)."""
    import bench_torch

    idx = nxs.index_create("bench")
    return idx, bench_torch.add_zipf(idx, N_NORTH, NORTH_VOCAB,
                                     NORTH_MEAN_LEN,
                                     workers=LARGE_GEN_WORKERS,
                                     chunk=LARGE_CHUNK)


def record_groups(widest: dict):
    """A stand-in for search._group_rows_cap that records, per route,
    the widest dispatch group (qs and T of impact-prefix and sliced
    groups, terms and postings budget of the others) and the smallest
    row cap."""
    from nxsearch_tpu_torch import search as search_mod

    rows_cap = search_mod._group_rows_cap

    def recorded(dev, key):
        cap = rows_cap(dev, key)
        if isinstance(key[0], str):
            route = key[0]
            dims = ({"qs": key[1], "T": key[2]} if route in ("pf", "sl")
                    else {"q": key[1]})
        else:
            route = "dense" if key[3] else "candidate"
            dims = {"q": key[0], "budget": key[4]}
        w = widest.setdefault(route, {"rows_cap": cap})
        for k, v in dims.items():
            w[k] = max(w.get(k, 0), int(v))
        w["rows_cap"] = min(w["rows_cap"], cap)
        return cap

    return recorded


def north_kernels(idx, step_ops: float, fuzzy: list, bdq: list) -> dict:
    """The four kernels at the shapes phase 16's path gives them, each
    held to its plain version (exact) and timed with CUDA events:
    forward and transposed Myers on KERNEL_M typos of ``fuzzy`` over the
    matcher's length region (every term of the tier), the single-query
    kernel on one of them, and segsum on the first blockdense queries
    of ``bdq``, as many rows as one blockdense launch takes."""
    from nxsearch_tpu_torch import search as search_mod
    from nxsearch_tpu_torch.ops import kernels

    fz = idx._fuzzy_matcher()
    typos = sorted(typos_of(idx, fuzzy))[:KERNEL_M]
    qb, ql = fz._pack_queries([t.encode() for t in typos])
    lo, w = fz._region(int(ql.median()))
    args = (fz._dev_bytes[lo: lo + w], fz._dev_len[lo: lo + w], qb, ql)
    vb, vl = args[:2]
    one_args = (vb, vl, qb[:1], ql[:1])
    checks = {
        "fwd": (kernels.myers_distances(*args),
                kernels.myers_distances_ref(*args)),
        "rev": (kernels.myers_rev_distances(*args),
                kernels.myers_rev_distances_ref(*args)),
        "one": (kernels.myers_distances(*one_args)[0],
                kernels.myers_distances_one_ref(vb, vl, qb[0], ql[0]))}
    out = {}
    for name, (got, want) in checks.items():
        err = int((got.long() - want.long()).abs().max())
        if not (err == 0 and got.shape == want.shape):
            raise AssertionError(f"phase 16 {name} kernel at W={w}: max "
                                 f"|diff| {err}")
        out[name] = {"max_abs_err": err}
    if not bool((checks["rev"][0] == checks["fwd"][0]).all()):
        raise AssertionError("phase 16: transposed and forward kernels "
                             "disagree")
    ms = in_turns({"fwd": kernels.myers_distances,
                   "rev": kernels.myers_rev_distances},
                  ("fwd", "rev", "rev", "fwd"), args, reps=KERNEL_REPS)
    ms["one"] = cuda_time_ms(lambda: kernels.myers_distances(*one_args),
                             21, KERNEL_REPS)
    plain = {
        "fwd": cuda_time_ms(lambda: kernels.myers_distances_ref(*args), 3),
        "rev": cuda_time_ms(lambda: kernels.myers_rev_distances_ref(*args),
                            3),
        "one": cuda_time_ms(lambda: kernels.myers_distances_one_ref(
            vb, vl, qb[0], ql[0]), 5)}
    int_rate = int32_ops_per_s()
    bounds = {
        "fwd": bound(myers_bytes(*args), myers_ops(vl, ql, False, step_ops),
                     int_rate),
        "rev": bound(myers_bytes(*args), myers_ops(vl, ql, True, step_ops),
                     int_rate),
        "one": bound(myers_bytes(*one_args),
                     myers_ops(vl, ql[:1], False, step_ops), int_rate)}
    for name in out:
        out[name].update(ms=ms[name], plain_ms=plain[name], **bounds[name],
                         shape={"M": 1 if name == "one" else len(typos),
                                "W": w})
    # One blockdense launch's rows (search._group_rows_cap for "bd").
    n_bd = min(N_SEGSUM, max(1, search_mod._BD_ELEMS_CAP
                             // idx.dev.n_slots))
    out["segsum"] = segsum_phase(idx, bdq, n_rows=n_bd)
    log(f"phase 16 kernels at the tier's shapes: {out}")
    return out


def bench_entry(device: str, card: str) -> dict:
    """bench_torch.py as a subprocess at a small tier (NORTH_BENCH, a
    fresh build under .bench_cache/): exit 0 and its JSON line."""
    cmd = [sys.executable, os.path.join(ROOT, "bench_torch.py"),
           *NORTH_BENCH, "--no-cache", "--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=ROOT)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench_torch.py exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    detail = line["detail"]
    if (line["metric"] != "bm25_top10_search_qps" or line["value"] <= 0
            or detail["device"]["type"] != device
            or (device == "cuda" and detail["device"]["card"] != card)
            or not detail["exec_stats"]):
        raise AssertionError(f"bench_torch.py's line: {line}")
    log(f"phase 16 bench_torch.py {' '.join(NORTH_BENCH)} --no-cache "
        f"({card}): exit 0 in {seconds} s; {json.dumps(line)}")
    return {"seconds": seconds, "line": line}


def north_phase(sp, card: str, step_ops: float,
                device: str = "cuda") -> dict:
    """Phase 16: the north-star tier (bench.py's --docs 8800000 --vocab
    1000000 --mean-len 60) at N_NORTH documents: the count is cut, to
    fit the script's time, and nothing else.  At the cut a dense row is
    smaller, so the dense-row byte budget
    (DeviceIndex.DENSE_ROWS_MAX_BYTES, NXS_DENSE_ROWS_MB) is lowered to
    hold as many rows as it holds at the full tier, where it binds.

    Traffic on the one index, each drive with the counts from zero:
    bench_torch.py's -- N_NORTH_QUERIES make_queries through
    search_pipelined (after one warm-up pass), as many
    make_mixed_queries, N_NORTH_FUZZY typo queries through search_many
    (forward Myers) -- then N_NORTH_SINGLE Index.search calls, half of
    them typos (single-query Myers), the typo queries again on the
    transposed kernel (NXS_FUZZY_REV's flag), N_BD queries with
    dense-row terms on the blockdense route (NXS_MASKED_HYBRID=0's
    flag; segsum) and N_NORTH_DENSE > 32-term queries (the dense
    executor).  Checked: the numpy oracles on 64 plain, 16 fuzzy, 32
    boolean and the dense answers; the transposed and blockdense answers
    equal the forward and default routes'; the kernels at the tier's
    shapes against their plain versions (north_kernels); bench_torch.py
    as a subprocess (bench_entry).  Logged: the snapshot's seconds,
    bytes and dense rows, peak device memory, host RSS, the widest
    dispatch groups per route."""
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    import bench
    import bench_torch
    from nxsearch_tpu_torch import Nxs
    from nxsearch_tpu_torch import fuzzy as fuzzy_mod
    from nxsearch_tpu_torch import search as search_mod
    from nxsearch_tpu_torch.index.device import DeviceIndex, _pad_size

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated() if on_card else 0
    words, probs = vocab(NORTH_VOCAB)
    s_pad = _pad_size(N_NORTH, DeviceIndex._MIN_SLOTS)
    budget0 = DeviceIndex.DENSE_ROWS_MAX_BYTES
    full_rows = min(DeviceIndex.MAX_DENSE_ROWS, budget0 // (4 * _pad_size(
        NORTH_FULL, DeviceIndex._MIN_SLOTS)))
    budget = full_rows * 4 * s_pad
    out = {"docs": N_NORTH, "full_docs": NORTH_FULL, "vocab": NORTH_VOCAB,
           "mean_len": NORTH_MEAN_LEN,
           "dense_budget": {"default": budget0, "set": budget,
                            "rows": full_rows}}
    log(f"phase 16 ({card}): {N_NORTH} of the north-star tier's "
        f"{NORTH_FULL} documents (vocab {NORTH_VOCAB}, mean length "
        f"{NORTH_MEAN_LEN}; cut: the document count, to fit the script's "
        f"time); dense-row budget set from {budget0} to {budget} B: "
        f"{full_rows} rows of {s_pad} slots, the rows the full tier's "
        "budget holds")
    totals, widest = {}, {}

    def drive(name, fn):
        """Run ``fn`` with the counts from zero."""
        sync()
        reset_counts()
        t0 = time.perf_counter()
        got = fn()
        sync()
        dt = time.perf_counter() - t0
        launches = launch_counts()
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        out[name] = {"seconds": dt,
                     "stats": dict(sorted(search_mod.EXEC_STATS.items())),
                     "launches": launches}
        return got, dt

    ldir = tempfile.mkdtemp(prefix="nxs_north_")
    nxs = Nxs(ldir, device=device)
    rows_cap = search_mod._group_rows_cap
    DeviceIndex.DENSE_ROWS_MAX_BYTES = budget
    search_mod._group_rows_cap = record_groups(widest)
    try:
        # bench.py's generators cost O(vocabulary) a query: the two
        # traces are made by spawned processes beside the ingest.
        with ProcessPoolExecutor(
                2, mp_context=multiprocessing.get_context("spawn")) as pool:
            traces = [pool.submit(gen, N_NORTH_QUERIES, words, probs,
                                  np.random.default_rng(seed))
                      for gen, seed in ((bench.make_queries, 42),
                                        (bench.make_mixed_queries, 43))]
            idx, ingest_s = north_index(nxs)
            queries, mixed = (f.result() for f in traces)
        log(f"phase 16 ingest ({card}): {idx.host.doc_count} docs in "
            f"{ingest_s} s; {idx.host.p_term.n} postings, "
            f"{len(idx.host.term_values)} terms")
        t0 = time.perf_counter()
        idx.search("w00001", sp)                 # builds the snapshot
        sync()
        snap_s = time.perf_counter() - t0
        dev = idx.dev
        counts = np.diff(dev.term_starts)
        heavy = int(np.count_nonzero(counts > dev.n_slots
                                     // DeviceIndex.DENSE_DF_DIV))
        n_rows = len(dev.dense_row_of)
        if n_rows != min(heavy, full_rows) or dev.postings_pack.device.type \
                != device:
            raise AssertionError(f"phase 16: {n_rows} dense rows for "
                                 f"{heavy} heavy terms, budget of "
                                 f"{full_rows}")
        sizes = bench_torch.snapshot_bytes(dev)
        snap_mem = (torch.cuda.memory_allocated() - mem0) if on_card else 0
        log(f"phase 16 snapshot ({card}): {snap_s} s; {dev.n_slots} device "
            f"slots, {dev.n_postings} padded postings; {heavy} terms above "
            f"the dense-row df threshold, {n_rows} with dense rows, "
            f"{heavy - n_rows} served without one; impact prefixes "
            f"{dev.prefix_stats}; bytes {sizes}; {snap_mem} B allocated")
        t0 = time.perf_counter()
        oracle = HostOracle(idx)
        oracle_s = time.perf_counter() - t0

        batches = [queries[i: i + BATCH]
                   for i in range(0, N_NORTH_QUERIES, BATCH)]
        mbatches = [mixed[i: i + BATCH]
                    for i in range(0, N_NORTH_QUERIES, BATCH)]
        fuzzy = bench.make_fuzzy_queries(N_NORTH_FUZZY, words, probs,
                                         np.random.default_rng(45), "x")
        single = (bench.make_fuzzy_queries(
            N_NORTH_SINGLE // 2, words, probs, np.random.default_rng(46),
            "h") + queries[: N_NORTH_SINGLE // 2])
        bdq = bd_queries(idx, NORTH_VOCAB)
        dense = dense_queries(idx, N_NORTH_DENSE, NORTH_VOCAB)

        idx.search_pipelined(batches, sp)        # warm-up
        res, dt = drive("plain", lambda: idx.search_pipelined(batches, sp))
        plain = [r for b in res for r in b]
        out["plain"]["qps"] = N_NORTH_QUERIES / dt
        if dev.n_slots < 1 << 24 and not (
                out["plain"]["stats"].get("prefix", 0) > 0):
            raise AssertionError(f"phase 16: impact-prefix rows expected: "
                                 f"{out['plain']['stats']}")
        res, dt = drive("mixed", lambda: idx.search_pipelined(mbatches, sp))
        mx = [r for b in res for r in b]
        out["mixed"]["qps"] = N_NORTH_QUERIES / dt
        fz, dt = drive("fuzzy", lambda: idx.search_many(fuzzy, sp))
        out["fuzzy"]["qps"] = N_NORTH_FUZZY / dt
        if out["fuzzy"]["launches"]["nxs_myers_distances"] <= 0:
            raise AssertionError("phase 16: no forward Myers launch")
        typos = typos_of(idx, single[: N_NORTH_SINGLE // 2])
        times = []

        def singles():
            got = []
            for q in single:
                t1 = time.perf_counter()
                got.append(idx.search(q, sp))
                times.append((time.perf_counter() - t1) * 1e3)
            return got

        one, _dt = drive("single", singles)
        out["single"]["ms_per_search"] = median(times)
        n_one = out["single"]["launches"]["nxs_myers_distances_one"]
        if n_one != len(typos) or not typos:
            raise AssertionError(f"phase 16: one single-query launch per "
                                 f"distinct typo ({len(typos)}) expected, "
                                 f"got {n_one}")
        forget_typos(idx)
        fuzzy_mod._USE_REV_KERNEL = True
        try:
            rev, dt = drive("rev", lambda: idx.search_many(fuzzy, sp))
        finally:
            fuzzy_mod._USE_REV_KERNEL = False
        out["rev"]["qps"] = N_NORTH_FUZZY / dt
        rl = out["rev"]["launches"]
        if rl["nxs_myers_rev_distances"] <= 0 or rl["nxs_myers_distances"]:
            raise AssertionError(f"phase 16: rev launches only expected: "
                                 f"{rl}")
        for q, w, g in zip(fuzzy, fz, rev):
            same_answer(w, g, q)
        search_mod._MASKED_HYBRID = False
        try:
            bd, dt = drive("blockdense", lambda: idx.search_many(bdq, sp))
        finally:
            search_mod._MASKED_HYBRID = True
        out["blockdense"]["qps"] = len(bdq) / dt
        if out["blockdense"]["stats"].get("blockdense", 0) <= 0 or \
                out["blockdense"]["launches"]["nxs_segsum_blockdense"] <= 0:
            raise AssertionError(f"phase 16: blockdense rows and segsum "
                                 f"launches expected: {out['blockdense']}")
        for q, w, g in zip(bdq, idx.search_many(bdq, sp), bd):
            same_answer(w, g, q)
        dn, dt = drive("dense", lambda: idx.search_many(dense, sp))
        out["dense"]["qps"] = N_NORTH_DENSE / dt
        if out["dense"]["stats"].get("dense", 0) != N_NORTH_DENSE:
            raise AssertionError(f"phase 16: {N_NORTH_DENSE} dense rows "
                                 f"expected: {out['dense']['stats']}")
        for name, got in (("plain", plain), ("mixed", mx), ("fuzzy", fz),
                          ("single", one), ("rev", rev), ("blockdense", bd),
                          ("dense", dn)):
            check_finite(got)
            o = out[name]
            log(f"phase 16 {name} ({card}): {o['seconds']} s"
                + (f", {o['qps']} QPS" if "qps" in o else "")
                + (f", {o['ms_per_search']} ms per search"
                   if "ms_per_search" in o else "")
                + f"; routes {o['stats']}; launches {o['launches']}")
        log(f"phase 16: rev answers equal the forward route's, blockdense "
            f"answers the default route's; widest dispatch groups "
            f"{widest}")

        t0 = time.perf_counter()
        pick = np.random.default_rng(7)
        oracle.n_typos = 0
        for i in pick.choice(N_NORTH_QUERIES, N_NORTH_ORACLE, replace=False):
            oracle.check_plain(queries[int(i)], plain[int(i)])
        for i in pick.choice(N_NORTH_FUZZY, N_NORTH_FUZZY_ORACLE,
                             replace=False):
            oracle.check_plain(fuzzy[int(i)], fz[int(i)])
        if oracle.n_typos < N_NORTH_FUZZY_ORACLE:
            raise AssertionError(f"phase 16: only {oracle.n_typos} typo "
                                 "tokens resolved")
        masked = [i for i, q in enumerate(mixed) if " AND " in q]
        for i in pick.choice(masked, N_NORTH_BOOL_ORACLE, replace=False):
            oracle.check_boolean(mixed[int(i)], mx[int(i)])
        for q, r in zip(dense, dn):
            oracle.check_boolean(q, r)
        log(f"phase 16 oracle: {N_NORTH_ORACLE} plain, "
            f"{N_NORTH_FUZZY_ORACLE} fuzzy, {N_NORTH_BOOL_ORACLE} boolean "
            f"and {N_NORTH_DENSE} dense answers agree (oracle build "
            f"{oracle_s} s, checks {time.perf_counter() - t0} s)")
        kern = north_kernels(idx, step_ops, fuzzy, bdq)
        peak = (torch.cuda.max_memory_allocated() - mem0) if on_card else 0
        rss = bench_torch.peak_rss()
        log(f"phase 16 ({card}): peak device memory of the phase {peak} B; "
            f"the process's peak host RSS so far {rss} B")
        out.update(ingest_s=ingest_s, snapshot_s=snap_s, oracle_s=oracle_s,
                   n_slots=dev.n_slots, n_postings=dev.n_postings,
                   heavy_terms=heavy, dense_rows=n_rows, bytes=sizes,
                   snapshot_mem=snap_mem, peak_mem=peak, host_peak_rss=rss,
                   prefix=dev.prefix_stats, widest=widest, kernels=kern,
                   launches=totals)
    finally:
        search_mod._group_rows_cap = rows_cap
        DeviceIndex.DENSE_ROWS_MAX_BYTES = budget0
        nxs.close()
        shutil.rmtree(ldir)
        if on_card:
            torch.cuda.empty_cache()
    out["bench"] = bench_entry(device, card)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is "
            "false)")
        return 1
    sys.path.insert(0, ROOT)
    from concurrent.futures import ThreadPoolExecutor

    from nxsearch_tpu_torch import Params

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    sources = {k.source: k for k in all_kernels()}   # one nvcc per source
    with ThreadPoolExecutor(2 * len(sources) + 1) as pool:
        probe = pool.submit(myers_step_instructions)
        usage = [pool.submit(ptxas_usage, src) for src in sources]
        list(pool.map(lambda k: k.build(), sources.values()))
        step_ops = probe.result()
        ptxas = {name: u for f in usage for name, u in f.result().items()}
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(sources)}); Myers step: {step_ops} integer "
        "instructions (SASS of csrc/myers_step.cuh)")
    for name, u in sorted(ptxas.items()):
        log(f"ptxas -v {name}: {u}")

    kern = kernel_phase(step_ops)
    # Segsum at the north-star tier's launch shape and on heavy terms,
    # from synthetic postings (phase 16 runs a cut of the tier).
    seg_cases = {}
    for name in ("tier", "heavy"):
        args, facts = segsum_synthetic(name)
        seg_cases[name] = {**segsum_case(args, f"segsum {name} case"),
                           **facts}
        del args
    torch.cuda.empty_cache()
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
                f"allocated; impact prefixes {dev.prefix_stats}")
            oracle = HostOracle(idx)
            sl = slice_phase(idx, sp, ingest_s, oracle)
            rev = rev_phase(idx, sp, oracle)
            one = single_phase(idx, sp)
            mixed = mixed_phase(idx, sp)
            bd = bd_phase(idx, sp)
            seg = {**segsum_phase(idx, bd["queries"]), "cases": seg_cases}
            boolean_oracle(oracle, mixed, bd)
            fb = fallback_phase(idx, sp, oracle, card)
            # The served index as a deployment leaves it after ingest:
            # with its fast-open snapshot cache on disk.
            t0 = time.perf_counter()
            idx.checkpoint()
            log(f"checkpoint: {time.perf_counter() - t0} s")
            par = run_phase("phase 11 (parallel ingest)", card,
                            parallel_ingest_phase, idx, sp, ingest_s, card)
            svc = run_phase("phase 12 (service)", card, service_phase,
                            workdir, idx, sp, card)
            ep = run_phase("phase 13 (entry points)", card,
                           entry_point_phase, workdir, idx, sp, card)
            mesh = run_phase("phase 14 (mesh)", card, mesh_phase, workdir,
                             idx, sp, card, {"qps": sl["qps"],
                                             "mixed_qps": mixed["qps"]})
        finally:
            nxs.close()
    # Phase 3's index is closed: phase 15 has the card and the host,
    # then phase 16.
    large = run_phase("phase 15 (large snapshot)", card, large_phase, sp,
                      card)
    north = run_phase("phase 16 (north-star tier)", card, north_phase, sp,
                      card, step_ops)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    log(json.dumps({
        "slice": {k: sl[k] for k in ("qps", "qps_samples", "fuzzy_qps",
                                     "fuzzy_qps_samples", "stats")},
        "mixed": {k: mixed[k] for k in ("qps", "qps_samples", "stats",
                                        "launches")},
        "rev": rev, "single": one, "myers_times": kern["times"],
        "myers_step_instructions": step_ops, "ptxas": ptxas,
        "blockdense": {k: bd[k] for k in ("qps", "stats", "launches")},
        "fallback": fb, "parallel_ingest": par, "service": svc,
        "entry_points": ep, "mesh": mesh, "large": large,
        "north": {k: v for k, v in north.items() if k != "kernels"},
        "card": card,
        "snapshot_s": snapshot_s, "ingest_s": ingest_s, "docs": N_DOCS}))

    # No single PyTorch call computes Levenshtein distances or the
    # blockdense scores with their presence bits: library_ms is null.
    rows = [
        ("myers_distances", "myers.cu", "nxs_myers_distances",
         "fuzzy.py:52", sl["launches"]["myers_distances"], kern["fwd"],
         "fwd"),
        ("myers_rev_distances", "myers_rev.cu", "nxs_myers_rev_distances",
         "fuzzy.py:162", rev["launches"]["rev"], kern["rev"], "rev"),
        ("blockdense_scores", "segsum.cu", "nxs_segsum_blockdense",
         "segsum.py:162", bd["launches"], seg, "segsum"),
        ("myers_distances_one", "myers.cu", "nxs_myers_distances_one",
         "fuzzy.py:40", one["launches"], kern["one"], "one")]
    # Beside the keys every kernel has: its launches in phase 14's mesh
    # drives, in phase 15's (the large snapshot) and in phase 16's (the
    # north-star tier) and its time and bound at phase 16's shapes
    # ("north"), the single-query kernel's launch floor and cold-L2
    # time, the transposed kernel's time at M = 1, segsum's store floor,
    # postings, distinct postings, occupied blocks and synthetic cases
    # ("cases": the north-star tier's launch shape and heavy terms).
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"nxsearch_tpu_torch/csrc/{src}",
        "replaces": f"nxsearch_tpu/ops/pallas/{tpu}", "launches": n,
        **{k: m[k] for k in keys}, "library_ms": None,
        "mesh_launches": mesh["launches"][sym],
        "large_launches": large["launches"][sym],
        "north_launches": north["launches"][sym],
        "north": north["kernels"][at_tier],
        **{k: v for k, v in m.items() if k not in keys}}
        for name, src, sym, tpu, n, m, at_tier in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
