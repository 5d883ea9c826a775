"""The port's tracing module (nxsearch_tpu_torch/utils/trace.py): spans
with start, end, parent and thread in a bounded ring, their host-stall
attributes, the collector's counters and ``host.gc`` spans, the switched-
off path, and the spans of a batched search from prep to the last
response."""

import collections
import gc
import logging
import re
import threading
import time

import numpy as np
import pytest

import nxsearch_tpu_torch
from nxsearch_tpu_torch import search as psearch
from nxsearch_tpu_torch.index.device import DeviceIndex
from nxsearch_tpu_torch.utils import trace
from perfbench.tracing import SpanLog

LOGGER = "nxsearch_tpu.trace"
STALLS = {"offcpu_ms", "sys_ms", "minflt", "majflt", "nivcsw", "nvcsw"}


@pytest.fixture
def tracing():
    """Tracing on (the trace logger at DEBUG, no output), an empty
    ring; both restored after."""
    log = logging.getLogger(LOGGER)
    saved = (log.level, log.propagate)
    null = logging.NullHandler()
    log.addHandler(null)
    log.setLevel(logging.DEBUG)
    log.propagate = False
    trace.reset()
    yield log
    log.removeHandler(null)
    log.setLevel(saved[0])
    log.propagate = saved[1]
    trace.reset()


@pytest.fixture
def untraced():
    log = logging.getLogger(LOGGER)
    saved = log.level
    log.setLevel(logging.WARNING)
    trace.reset()
    yield log
    log.setLevel(saved)


class Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_counters_are_the_search_counters():
    assert psearch.EXEC_STATS is trace.COUNTERS
    assert psearch._count is trace.count
    trace.count("_trace_test", 3)
    assert trace.counters()["_trace_test"] == 3
    assert psearch.EXEC_STATS.pop("_trace_test") == 3


def test_nesting_parents_and_attributes(tracing):
    with trace.phase("a", k=1) as a:
        with trace.phase("b"):
            with trace.phase("c") as c:
                c.set(rows=5)
        a.set(groups=2)
    with trace.phase("d"):
        pass
    got = by_name(trace.spans())
    (sa,), (sb,), (sc,), (sd,) = got["a"], got["b"], got["c"], got["d"]
    assert sa.parent is None and sd.parent is None
    assert sb.parent == sa.id and sc.parent == sb.id
    assert sa.attrs["k"] == 1 and sa.attrs["groups"] == 2
    assert sc.attrs["rows"] == 5
    assert {s.thread for s in (sa, sb, sc, sd)} == {threading.get_ident()}
    assert sa.start_ns <= sb.start_ns <= sc.start_ns <= sc.end_ns \
        <= sb.end_ns <= sa.end_ns <= sd.start_ns
    # Closed innermost first.
    assert [s.name for s in trace.spans()] == ["c", "b", "a", "d"]
    # The leaves carry the stall attributes; a span that held another
    # carries none.
    for s in (sc, sd):
        assert STALLS <= set(s.attrs)
        assert s.attrs["majflt"] >= 0 and s.attrs["minflt"] >= 0
    for s in (sa, sb):
        assert not STALLS & set(s.attrs)


def test_two_threads_keep_their_own_parents(tracing):
    barrier = threading.Barrier(2)

    def work(tag):
        with trace.phase(f"outer.{tag}"):
            barrier.wait()
            with trace.phase(f"inner.{tag}"):
                barrier.wait()
            barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = {s.name: s for s in trace.spans()}
    assert len(got) == 4
    for tag in "xy":
        outer, inner = got[f"outer.{tag}"], got[f"inner.{tag}"]
        assert outer.parent is None and inner.parent == outer.id
        assert outer.thread == inner.thread
    assert got["outer.x"].thread != got["outer.y"].thread
    # The two threads' spans overlapped in time.
    assert got["inner.x"].start_ns < got["inner.y"].end_ns
    assert got["inner.y"].start_ns < got["inner.x"].end_ns


def _nested_spans(n_threads, per, collect):
    """``n_threads`` threads open ``per`` spans each, three deep, with a
    short switch interval; ``collect``: a collection now and then."""
    import sys

    def work():
        for i in range(per // 3):
            with trace.phase("w.outer"):
                with trace.phase("w.mid"):
                    junk = [[j] for j in range(50)]
                    with trace.phase("w.inner"):
                        if collect and i % 20 == 0:
                            gc.collect(0)
                    del junk

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)


def test_many_threads_lose_no_span(tracing, monkeypatch):
    """Every span of 16 threads is kept, in one order of closing, each
    under its parent on its own thread; with a smaller ring, every span
    is kept or counted as dropped."""
    _nested_spans(16, 300, collect=True)
    got = trace.spans()
    mine = [s for s in got if s.name.startswith("w.")]
    assert len(mine) == 16 * 300 and trace.dropped() == 0
    assert [s.seq for s in got] == list(range(got[0].seq,
                                              got[0].seq + len(got)))
    ids = {s.id: s for s in got}
    assert len(ids) == len(got)
    want = {"w.inner": "w.mid", "w.mid": "w.outer", "w.outer": None}
    for s in mine:
        parent = ids.get(s.parent)
        assert (parent.name if parent else None) == want[s.name]
        if parent is not None:
            assert parent.thread == s.thread
            assert parent.start_ns <= s.start_ns <= s.end_ns \
                <= parent.end_ns
    gcs = [g for g in got if g.name == "host.gc" and g.parent in ids]
    assert gcs and all(ids[g.parent].thread == g.thread for g in gcs)

    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=1000))
    trace.reset()
    gc.disable()                  # no host.gc span among them
    try:
        _nested_spans(16, 300, collect=False)
        kept, dropped = trace.spans(), trace.dropped()
    finally:
        gc.enable()
    assert len(kept) == 1000 and dropped == 16 * 300 - 1000


def test_span_lies_between_two_reads_of_the_clock(tracing):
    before = time.perf_counter_ns()
    with trace.phase("clock"):
        time.sleep(0.03)
    after = time.perf_counter_ns()
    (s,) = trace.spans()
    assert before <= s.start_ns < s.end_ns <= after
    assert s.end_ns - s.start_ns >= 30_000_000
    # A sleep is time off the CPU (good to a scheduler tick).
    assert s.attrs["offcpu_ms"] > 15.0


def test_off_records_nothing_reads_no_clock(untraced, monkeypatch):
    calls = {"rusage": 0, "clock": 0}
    real_rusage = trace.resource.getrusage
    real_clock = time.perf_counter_ns
    real_cpu = time.thread_time_ns

    def rusage(*a):
        calls["rusage"] += 1
        return real_rusage(*a)

    def clock():
        calls["clock"] += 1
        return real_clock()

    def cpu():
        calls["clock"] += 1
        return real_cpu()

    records = Records()
    untraced.addHandler(records)
    monkeypatch.setattr(trace.resource, "getrusage", rusage)
    monkeypatch.setattr(time, "perf_counter_ns", clock)
    monkeypatch.setattr(time, "thread_time_ns", cpu)
    gc.disable()                      # the collector hook reads the clock
    try:
        with trace.phase("off", rows=1) as sp:
            sp.set(groups=2)
            with trace.phase("off.inner"):
                pass
    finally:
        gc.enable()
        monkeypatch.undo()
        untraced.removeHandler(records)
    assert calls == {"rusage": 0, "clock": 0}
    assert trace.spans() == [] and records.records == []


def test_log_line_is_the_one_spanlog_reads():
    records = Records()
    with SpanLog() as log:
        logging.getLogger(LOGGER).addHandler(records)
        try:
            trace.reset()
            with trace.phase("batch.submit", rows=3):
                time.sleep(0.001)
        finally:
            logging.getLogger(LOGGER).removeHandler(records)
    (rec,) = [r for r in records.records if r.levelno == logging.DEBUG]
    assert rec.msg == "%s: %.2f ms"
    assert rec.args[0] == "batch.submit" and isinstance(rec.args[1], float)
    assert re.fullmatch(r"batch\.submit: \d+\.\d\d ms", rec.getMessage())
    (s,) = trace.spans()
    assert rec.args[1] == pytest.approx(s.ms)
    (name, start, end), = log.spans
    assert name == "batch.submit"
    assert end - start == pytest.approx(s.ms / 1e3)
    trace.reset()


def test_ring_keeps_the_newest_and_counts_drops(tracing, monkeypatch):
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=8))
    trace.reset()
    for i in range(20):
        with trace.phase(f"s{i}"):
            pass
    assert [s.name for s in trace.spans()] == \
        [f"s{i}" for i in range(12, 20)]
    assert trace.dropped() == 12
    trace.reset()
    assert trace.spans() == [] and trace.dropped() == 0
    with trace.phase("after"):
        pass
    assert trace.dropped() == 0


def test_ring_adds_nothing_for_the_collector_to_walk(tracing):
    """A recorded span leaves the collector's lists at its first
    collection, so a full ring does not lengthen a generation-2 sweep."""
    for i in range(200):
        with trace.phase("outer", rows=i) as sp:
            with trace.phase("inner"):
                pass
            sp.set(groups=2, share=0.5, route="pf")
    gc.collect()
    records = [r for r in trace._ring if r[0] != "host.gc"]
    assert len(records) == 400
    assert not any(gc.is_tracked(r) for r in records)


def test_stalls_are_read_on_leaves_only(tracing, monkeypatch):
    """A leaf reads the thread's usage at its open and close; a span
    that holds others reads it once, at its open, and keeps nothing."""
    calls = []
    real = trace.resource.getrusage

    def rusage(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(trace.resource, "getrusage", rusage)
    gc.disable()                        # no host.gc span among them
    try:
        with trace.phase("outer"):
            with trace.phase("a"):
                pass
            with trace.phase("b"):
                pass
    finally:
        gc.enable()
    assert len(calls) == 3 + 2
    got = {s.name: s for s in trace.spans()}
    assert not STALLS & set(got["outer"].attrs)
    assert STALLS <= set(got["a"].attrs) and STALLS <= set(got["b"].attrs)


def test_collector_counts_with_tracing_off(untraced):
    before = dict(trace.COUNTERS)
    records = Records()
    untraced.addHandler(records)
    try:
        gc.collect()
    finally:
        untraced.removeHandler(records)
    assert trace.COUNTERS.get("gc.gen2", 0) == before.get("gc.gen2", 0) + 1
    assert trace.COUNTERS.get("gc.us", 0) > before.get("gc.us", 0)
    assert trace.spans() == [] and records.records == []


def test_collector_span_with_tracing_on(tracing, monkeypatch):
    class Watched:
        acquired = 0

        def __enter__(self):
            Watched.acquired += 1

        def __exit__(self, *exc):
            return False

    # The hook takes no lock (not the counters' lock) and logs nothing.
    monkeypatch.setattr(trace, "_COUNT_LOCK", Watched())
    records = Records()
    tracing.addHandler(records)
    try:
        with trace.phase("outer") as outer:
            n = trace.COUNTERS.get("gc.gen2", 0)
            gc.collect()
            assert trace.COUNTERS.get("gc.gen2", 0) == n + 1
    finally:
        tracing.removeHandler(records)
    assert Watched.acquired == 0
    assert [r.args[0] for r in records.records] == ["outer"]
    got = by_name(trace.spans())
    (o,) = got["outer"]
    gcs = [s for s in got["host.gc"] if s.attrs["generation"] == 2]
    assert len(gcs) == 1
    (g,) = gcs
    assert g.parent == o.id == outer.id
    assert g.thread == o.thread
    assert o.start_ns <= g.start_ns <= g.end_ns <= o.end_ns
    assert g.attrs["collected"] >= 0 and STALLS <= set(g.attrs)


def test_one_collector_hook():
    hooks = [cb for cb in gc.callbacks
             if getattr(cb, "__qualname__", "") == "_gc_hook"
             and getattr(cb, "__module__", "") == trace.__name__]
    assert hooks == [trace._gc_hook]
    trace._install_gc_hook()
    assert gc.callbacks.count(trace._gc_hook) == 1


# -- a search's spans --------------------------------------------------------

def _docs():
    """A Zipf corpus and tests/test_prefix.py's certifying documents, so
    small impact-prefix thresholds leave uncertified rows (the fallback
    sub-batch)."""
    rng = np.random.default_rng(11)
    words = [f"t{i:03d}" for i in range(80)]
    probs = 1.0 / (np.arange(80) + 3.0)
    probs /= probs.sum()
    docs = [(i + 1, " ".join(rng.choice(words, size=max(3, int(
        rng.poisson(14))), p=probs))) for i in range(300)]
    did = 10_001
    for i in range(8):
        docs.append((did, " ".join(["pad"] * 4 + ["x"] * (2 + i))))
        did += 1
    for i in range(52):
        docs.append((did, "pad " + " ".join(
            f"f{j:02d}" for j in range(30 + i % 9))))
        did += 1
    for i in range(300):
        docs.append((did, " ".join(f"g{j:02d}" for j in range(20 + i % 7))))
        did += 1
    return docs, words


@pytest.fixture(scope="module")
def small_cap_index(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(DeviceIndex, "PREFIX_CAP", 8)
    mp.setattr(DeviceIndex, "WIDE_MIN_DF", 8)
    mp.setattr(psearch, "_PREFIX_MAX_WIDE", 4)
    nxs = nxsearch_tpu_torch.Nxs(str(tmp_path_factory.mktemp("trace")),
                                 device="cpu")
    idx = nxs.index_create("t")
    docs, words = _docs()
    idx.add_many(docs)
    rng = np.random.default_rng(7)
    queries = [" ".join(rng.choice(words, size=int(rng.integers(1, 5))))
               for _ in range(60)]
    idx.search_many(queries[:4])              # builds the snapshot
    yield idx, queries
    nxs.close()
    mp.undo()


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


def test_search_many_spans_cover_the_request(tracing, small_cap_index):
    idx, queries = small_cap_index
    psearch.EXEC_STATS.pop("prefix_fallback", None)
    got = idx.search_many(queries, nxsearch_tpu_torch.Params().set_uint(
        "limit", 10))
    assert len(got) == len(queries)
    assert psearch.EXEC_STATS.get("prefix_fallback", 0) > 0
    spans = [s for s in trace.spans() if s.name != "host.gc"]
    ids = {s.id: s for s in spans}
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in top] == [
        "prep.parse", "prep.prime", "prep.resolve", "prep.prepare",
        "batch.plan", "batch.submit", "batch.collect"]
    submit, collect = top[5], top[6]
    assert submit.attrs["rows"] == len(queries)
    assert submit.attrs["groups"] >= 1
    assert _children(spans, submit) == []
    assert _children(spans, collect) == [
        "batch.fetch", "batch.respond", "batch.fallback"]
    fallback = next(s for s in spans if s.name == "batch.fallback")
    assert fallback.attrs["rows"] == psearch.EXEC_STATS["prefix_fallback"]
    # The fallback sub-batch: its own plan, submit and collect inside.
    assert _children(spans, fallback) == [
        "batch.plan", "batch.submit", "batch.collect"]
    inner = next(s for s in spans if s.name == "batch.collect"
                 and s.parent == fallback.id)
    assert _children(spans, inner) == ["batch.fetch", "batch.respond"]
    for s in spans:
        if s.parent is not None:
            p = ids[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    # Siblings in order, back to back: the request has no gap longer
    # than the code between two spans.
    for a, b in zip(top, top[1:]):
        assert a.end_ns <= b.start_ns


def test_search_pipelined_spans_nest(tracing, small_cap_index):
    idx, queries = small_cap_index
    batches = [queries[i: i + 20] for i in range(0, 60, 20)]
    got = idx.search_pipelined(batches, nxsearch_tpu_torch.Params()
                               .set_uint("limit", 10))
    assert [len(b) for b in got] == [20, 20, 20]
    spans = [s for s in trace.spans() if s.name != "host.gc"]
    ids = {s.id: s for s in spans}
    top = [s.name for s in spans if s.parent is None]
    assert top.count("pipeline.prepare") == 3
    assert top.count("pipeline.submit") == 3
    assert top.count("pipeline.collect") == 3
    assert top.count("pipeline.fallback") == 2
    assert set(top) == {"pipeline.prepare", "pipeline.submit",
                        "pipeline.collect", "pipeline.fallback"}
    for s in spans:
        parent = ids.get(s.parent)
        if s.name in ("batch.plan", "batch.submit"):
            assert parent.name in ("pipeline.submit", "pipeline.collect",
                                   "batch.fallback")
        if s.name == "batch.collect":
            assert parent.name in ("pipeline.collect", "pipeline.fallback",
                                   "batch.fallback")
        if s.name in ("batch.fetch", "batch.respond"):
            assert parent.name == "batch.collect"
        if s.name.startswith("prep."):
            assert parent.name == "pipeline.prepare"
    for sub in (s for s in spans if s.name == "pipeline.submit"):
        assert _children(spans, sub) == ["batch.plan", "batch.submit"]
    # Batch i-1's fallback rows were planned and submitted inside its
    # pipeline.collect and collected inside pipeline.fallback.
    fb = [s for s in spans if s.name == "pipeline.fallback"]
    assert any(_children(spans, s) == ["batch.collect"] for s in fb)
