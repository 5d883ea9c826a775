"""The readers of the engine's dispatch, fetch and collector metrics
(metrics/submit_ms.requests, fetch_ms.*, gc_ms.*): over a synthetic run,
with a fallback sub-batch collected inside a collect, over a run of an
engine that has no such span or counter, and in tiny traced cells on the
CPU."""

import sys
import time

import pytest
import torch

import nxsearch_tpu_torch.utils.trace  # noqa: F401  (the engine's hook)
from perfbench import run as run_mod
from perfbench.tracing import SpanLog

NEW = {"submit_ms.requests": "requests", "fetch_ms.requests": "requests",
       "fetch_ms.stream": "pipelined", "gc_ms.requests": "requests",
       "gc_ms.stream": "pipelined"}


def reader(name):
    return run_mod.load_reader(name, run_mod.ROOT)


def synthetic(send, spans, exec_stats, units=2):
    log = SpanLog()
    for name, s, e in spans:
        log.add(name, s, e)
    return run_mod.Run(send=send, spans=log, t0=10.0, t1=20.0, units=units,
                       exec_stats=exec_stats)


SPANS = [
    ("batch.submit", 10.0, 10.5),
    ("batch.collect", 10.5, 11.5),     # a request's collect ...
    ("batch.fetch", 10.5, 10.6),
    ("batch.respond", 10.6, 10.9),
    ("batch.fallback", 11.0, 11.45),   # ... its fallback sub-batch
    ("batch.plan", 11.0, 11.05),
    ("batch.submit", 11.05, 11.1),
    ("batch.collect", 11.1, 11.4),     # ... collected inside it
    ("batch.fetch", 11.1, 11.2),
    ("batch.respond", 11.2, 11.35),
    ("batch.submit", 12.0, 12.25),
    ("batch.collect", 12.25, 12.75),
    ("batch.fetch", 12.25, 12.3),
    ("batch.respond", 12.3, 12.7),
    ("batch.collect", 25.0, 26.0),     # after the window
    ("batch.respond", 25.5, 26.0),
]


@pytest.mark.parametrize("send", ["requests", "pipelined"])
def test_nested_collect_counts_once(send):
    """The fallback's fetch and response building count once, in fetch;
    its planning and dispatch stay with plan and submit."""
    run = synthetic(send, SPANS, {"gc.us": 3000, "gc.gen0": 4})
    unit = "requests" if send == "requests" else "stream"
    fetch = reader(f"fetch_ms.{unit}")
    assert fetch(run) == pytest.approx(
        (0.1 + 0.3 + 0.1 + 0.15 + 0.05 + 0.4) * 1e3 / 2)
    gc_ms = reader(f"gc_ms.{unit}")
    assert gc_ms(run) == pytest.approx(1.5)


def test_submit_sums_every_dispatch():
    run = synthetic("requests", SPANS, {})
    assert reader("submit_ms.requests")(run) == \
        pytest.approx((0.5 + 0.05 + 0.25) * 1e3 / 2)


def test_each_reader_keeps_to_its_cell():
    for name, send in NEW.items():
        other = "pipelined" if send == "requests" else "requests"
        assert reader(name)(synthetic(other, SPANS, {"gc.us": 5})) is None


def test_an_engine_without_the_spans_reads_nothing(monkeypatch):
    """The parent of these metrics: no batch.submit / batch.collect
    spans, no gc counters and no collector hook; every reader returns
    None and none raises."""
    old = [("prep.parse", 10.0, 10.2), ("batch.plan", 10.2, 10.3),
           ("pipeline.collect", 10.3, 10.6)]
    monkeypatch.setitem(sys.modules, "nxsearch_tpu_torch.utils.trace", None)
    for name, send in NEW.items():
        assert reader(name)(synthetic(send, old, {"prefix": 9})) is None
    # With the hook, a window without a collection reads 0.
    monkeypatch.undo()
    assert reader("gc_ms.requests")(
        synthetic("requests", old, {"prefix": 9})) == 0.0


@pytest.mark.parametrize("cell", ["trec_covid.or_requests",
                                  "msmarco.or_top10"])
def test_tiny_traced_cell_reads_the_new_metrics(tiny_root, cell):
    out = run_mod.run_cell(cell, 2**31 + 77, 1, True, torch.device("cpu"),
                           root=tiny_root, t_start=time.perf_counter(),
                           log=lambda m: None)
    assert out["correct"], out["checks"]
    want = {n for n, send in NEW.items()
            if (send == "requests") == cell.startswith("trec")}
    assert want <= set(out["metrics"])
    for n in want:
        assert out["metrics"][n]["value"] >= 0
        assert out["metrics"][n]["unit"] == "ms"
    if cell.startswith("trec"):
        m = out["metrics"]
        assert m["fetch_ms.requests"]["value"] > 0
        assert m["submit_ms.requests"]["value"] > 0
