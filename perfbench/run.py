#!/usr/bin/env python3
"""Run one cell of the benchmark of nxsearch_tpu_torch once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

The cell (a configuration and a traffic mix, ``BENCHMARK.json``'s
``workloads``) is found by name; its configuration in
``perfbench/configs/<config>.json``, its traffic in
``perfbench/traffic/<traffic>.json`` and each per-layer metric's reader
in ``perfbench/metrics/<metric>.py``.  A run makes the corpus from the
seed on the card, indexes it through the engine's bulk add, builds the
device snapshot, makes the traffic and warms its shapes (all of that is
``setup_s``), then sends the traffic for ``--seconds``, checks a
sample of the window's answers against the plain reference
(reference.py) and prints one JSON line last on stdout.  With
``--trace 0`` the line's metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from the engine's phase spans,
its route counters and a torch.profiler trace of the window.

It exits non-zero, and prints no result, without a CUDA card, if a
module of JAX or of the JAX package was loaded, or where the cell's
traffic file asks for a ``send`` that the harness does not know.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Kernel caches at fixed paths inside the checkout: the engine builds
# its CUDA sources into nxsearch_tpu_torch/_build/ itself.
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, ".perfbench_cache", "triton"))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from perfbench import corpus as corpus_mod  # noqa: E402
from perfbench import traffic as traffic_mod  # noqa: E402
from perfbench.reference import Reference, compare  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nxsearch_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``nxsearch_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_reader(name: str, root: str):
    path = os.path.join(root, "perfbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


class Reservoir:
    """``k`` items drawn uniformly from a stream, from a seeded rng."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def offer(self, items: list) -> None:
        take = min(max(self.k - self.n, 0), len(items))
        self.items.extend(items[:take])
        rest = len(items) - take
        if rest > 0:
            seen = self.n + take + 1 + np.arange(rest)
            slot = (self.rng.random(rest) * seen).astype(np.int64)
            for i in np.nonzero(slot < self.k)[0]:
                self.items[slot[i]] = items[take + i]
        self.n += len(items)


class Run:
    """What a per-layer reader reads (perfbench/metrics/*.py)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def per_unit_ms(self, names, send: str):
        """Milliseconds of the named spans per batch (``pipelined``) or
        per request (``requests``), over the window; None in a cell
        that sends otherwise or where no span was read."""
        if self.send != send or self.spans is None or not self.units:
            return None
        s = self.spans.total(names, self.t0, self.t1)
        return s * 1e3 / self.units if s > 0 else None

    def idle_share(self, send: str):
        if self.send != send or self.dtrace is None or not self.dtrace.ops:
            return None
        busy, _ = self.dtrace.busy(self.t0, self.t1)
        return 1.0 - busy / (self.t1 - self.t0)


def run_cell(name: str, seed: int, seconds: int, trace: bool, device,
             root: str = ROOT, t_start: float = T_START,
             log=print) -> dict:
    """One run of cell ``name`` on ``device``; returns the result."""
    import torch

    from nxsearch_tpu_torch import Nxs, Params
    from nxsearch_tpu_torch import search as search_mod
    from nxsearch_tpu_torch.utils.malloc import tune_host_allocator

    bench = load_bench(root)
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    with open(os.path.join(root, "perfbench", "configs",
                           f"{cell['config']}.json")) as f:
        cfg = json.load(f)
    tp = traffic_mod.load(cell["traffic"], os.path.join(root, "perfbench"))
    on_card = device.type == "cuda"
    tune_host_allocator()
    sp = Params().set_uint("limit", int(tp["limit"]))

    # -- set-up: corpus, ingest, snapshot, traffic, warm-up ------------
    basedir = tempfile.mkdtemp(prefix="perfbench_")
    nxs = Nxs(basedir, device=device)
    idx = nxs.index_create("bench")
    ingest_s = [0.0]

    def ingest(lo, dl, n_pairs, rank, count, strings):
        # One bulk add a chunk of the corpus, in the arrays that
        # Index.add_many's native tokenizer hands to the host index: a
        # string table (the vocabulary, in rank order, so term id =
        # rank + 1), (table index, count) pairs per document in term
        # order, and each document's token count.
        t = time.perf_counter()
        ptr = np.zeros(len(dl) + 1, dtype=np.int64)
        np.cumsum(n_pairs, out=ptr[1:])
        pairs = np.empty((len(rank), 2), dtype=np.uint32)
        pairs[:, 0] = rank
        pairs[:, 1] = count
        idx.host.add_bulk_arrays(
            np.arange(lo + 1, lo + len(dl) + 1, dtype=np.int64), strings,
            pairs, ptr, dl.astype(np.uint32))
        ingest_s[0] += time.perf_counter() - t

    t = time.perf_counter()
    corpus = corpus_mod.make_corpus(cfg, seed, device, on_chunk=ingest)
    corpus_s = time.perf_counter() - t - ingest_s[0]
    # The journals stay open; the directory goes, so the snapshot
    # build's CSR cache and close()'s snapshot files (best-effort
    # caches of the engine, for a restart this run never makes) find no
    # directory and write nothing.
    shutil.rmtree(basedir, ignore_errors=True)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    idx.search(corpus.strings[0], sp)          # builds the snapshot
    if on_card:
        torch.cuda.synchronize(device)
    snapshot_s = time.perf_counter() - t

    bsz = int(tp["batch"])
    pipelined = tp["send"] == "pipelined"
    per_call = int(tp.get("batches_per_call", 1)) if pipelined else 1
    warm = int(tp["warmup_calls"]) * per_call
    # Set-up draws the batches that a window at ``prefetch_qps`` sends,
    # and one call more; a faster window draws on (and logs it).
    n_batches = (warm + math.ceil(tp["prefetch_qps"] * seconds / bsz)
                 + per_call)
    t = time.perf_counter()
    tr = traffic_mod.make_traffic(cell["traffic"], tp, cfg, corpus.strings,
                                  seed, n_batches)
    traffic_s = time.perf_counter() - t

    def call(batches):
        if pipelined:
            return [r for b in idx.search_pipelined(batches, sp) for r in b]
        return idx.search_many(batches[0], sp)

    t = time.perf_counter()
    for i in range(0, warm, per_call):
        call(tr.batches[i: i + per_call])
    if on_card:
        torch.cuda.synchronize(device)
    warmup_s = time.perf_counter() - t
    log(f"set-up: corpus {corpus_s:.2f} s, ingest {ingest_s[0]:.2f} s "
        f"({corpus.n_docs} documents, {len(corpus.pair_rank)} postings), "
        f"snapshot {snapshot_s:.2f} s, traffic {traffic_s:.2f} s "
        f"({n_batches} batches of {bsz}), warm-up {warmup_s:.2f} s")

    # -- the window --------------------------------------------------------
    from perfbench.tracing import DeviceTrace, SpanLog

    search_mod.EXEC_STATS.clear()
    spans = SpanLog().__enter__() if trace else None
    dtrace = DeviceTrace(device).__enter__() if trace and on_card else None
    # The answers checked afterwards: a uniform sample of the window's
    # and one of its typo queries', kept as they come (a reservoir), so
    # the harness holds a few hundred answers, not the window's.
    rng = np.random.default_rng(corpus_mod.derive(seed, "check"))
    keep_all = Reservoir(int(tp["check_sample"]), rng)
    keep_typo = Reservoir(int(tp["check_typos"]), rng)
    failed = n_sent = 0
    calls: list = []                      # (start, end, queries)
    at = warm
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        batches = [tr.batch(b) for b in range(at, at + per_call)]
        ts = time.perf_counter()
        got = call(batches)
        te = time.perf_counter()
        calls.append((ts, te, per_call * bsz))
        pool = range(at * bsz, (at + per_call) * bsz)
        typo = np.concatenate([tr.typos_of(b)
                               for b in range(at, at + per_call)])
        failed += len(pool) - len(got) + sum(a is None for a in got)
        got = [(n_sent + k, i, a) for k, (i, a) in enumerate(zip(pool, got))]
        n_sent += len(pool)
        keep_all.offer(got)
        keep_typo.offer([got[k] for k in np.nonzero(typo >= 0)[0]])
        if spans is not None:
            spans.add("bench.call", ts, te)
        at += per_call
        if te - t0 >= seconds:
            break
    t1 = time.perf_counter()
    if dtrace is not None:
        dtrace.__exit__(None, None, None)
    if spans is not None:
        spans.__exit__(None, None, None)
    exec_stats = dict(search_mod.EXEC_STATS)
    window_s = t1 - t0
    attempted = sum(c[2] for c in calls)
    lat_ms = np.array([(e - s) * 1e3 for s, e, _ in calls])
    if at > n_batches:
        log(f"the window sent {at - warm} batches; set-up drew "
            f"{n_batches - warm} of them and the window the rest")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    typos = [tr.typo_text[i] for i in range(warm * bsz, at * bsz)
             if i in tr.typo_text]
    kept = {pos: (i, a) for pos, i, a in keep_all.items + keep_typo.items}
    sample = [(tr.query(i), a.results if a is not None else [])
              for _, (i, a) in sorted(kept.items())]
    del kept, keep_all, keep_typo

    # -- the check ---------------------------------------------------------
    units = len(calls) * (per_call if pipelined else 1)
    result_device = {"platform": "gpu" if on_card else "cpu",
                     "kind": (torch.cuda.get_device_name(device)
                              if on_card else "cpu"),
                     "count": 1, "memory_peak_bytes": int(peak)}
    run = Run(cell=cell, cfg=cfg, traffic=tp, send=tp["send"], spans=spans,
              dtrace=dtrace, t0=t0, t1=t1, units=units,
              requests=len(calls), latency_ms=lat_ms, exec_stats=exec_stats,
              setup={"ingest_s": ingest_s[0], "snapshot_s": snapshot_s,
                     "corpus_s": corpus_s, "warmup_s": warmup_s},
              typos=typos, word_lengths=corpus_mod.word_lengths(
                  corpus.words),
              sm_count=(torch.cuda.get_device_properties(
                  device).multi_processor_count if on_card else 0))
    metrics: dict = {}
    if trace:
        for m in bench["per_layer"]:
            if applies(m, name):
                v = load_reader(m["name"], root)(run)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
        if dtrace is not None and dtrace.ops:
            busy, merged = dtrace.busy(t0, t1)
            result_device.update(busy_s=busy, window_s=window_s)
            breakdown = {
                "device_ops": dtrace.top_ops(t0, t1),
                "idle_gaps": dtrace.idle_gaps(merged, spans.spans, t0, t1)}
        else:
            breakdown = None
    else:
        e2e = {"search_qps": attempted / window_s, "setup_s": setup_s}
        if len(lat_ms):
            e2e["request_p50_ms"] = float(np.percentile(lat_ms, 50))
            e2e["request_p95_ms"] = float(np.percentile(lat_ms, 95))
        for m in bench["end_to_end"]:
            if applies(m, name) and m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        breakdown = None
    log(f"window: {window_s:.3f} s, {attempted} queries in {len(calls)} "
        f"calls; request latency samples {len(lat_ms)} "
        f"(p95 {np.percentile(lat_ms, 95) if len(lat_ms) else 0:.3f} ms, "
        f"{int((lat_ms > np.percentile(lat_ms, 95)).sum()) if len(lat_ms) else 0}"
        f" beyond it); route counters {exec_stats}")

    nxs.close()
    del idx, nxs
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = Reference(corpus, device)
    misses, gap = 0, 0.0
    limit = int(tp["limit"])
    for q, got in sample:
        want, acc = ref.answer(q, limit)
        m, g = compare(got, want, acc, cfg["score_tol"])
        misses += m
        gap = max(gap, g)
    log(f"check: {len(sample)} answers ({sum(q.typo >= 0 for q, _ in sample)}"
        f" with a typo, {sum(q.form != 'or' for q, _ in sample)} boolean) "
        f"against the reference in {time.perf_counter() - t:.2f} s")
    checks = {"rank_misses": {"value": misses, "limit": 0},
              "score_gap": {"value": gap, "limit": cfg["score_tol"]},
              "answers_checked": {"value": len(sample), "limit": 1},
              "failed": {"value": failed, "limit": 0}}
    correct = (misses <= 0 and gap <= cfg["score_tol"]
               and len(sample) >= 1 and failed == 0)
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    import torch

    bench = load_bench()
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    try:
        traffic_mod.load(cell["traffic"], HERE)
    except (OSError, ValueError) as e:
        log(f"traffic of {args.workload!r}: {e}")
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        log("no CUDA card, or fewer than the cell asks for")
        return 3
    log(f"card: {card_line()}")
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), log=log)
    bad = forbidden_modules()
    if bad:
        log(f"loaded modules of JAX or the JAX package: {bad}")
        return 4
    for k, v in out["checks"].items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
