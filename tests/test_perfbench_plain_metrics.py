"""The readers of the candidate and dense executors' metrics
(perfbench/metrics/plain_rows.share.stream, plain_fill.stream,
plain_ms.stream): over a made-up run, over a run of an engine that has
no ``plain.*`` counter or ``submit.plain`` span, in a cell that sends
otherwise, and in a tiny traced ``tweets2011.or_top10`` cell on the
CPU whose rows all take the candidate and dense executors, as they do
from 2**24 device slots."""

import json
import os
import shutil
import time

import pytest
import torch

from nxsearch_tpu_torch import search as psearch
from perfbench import run as run_mod
from perfbench.tracing import SpanLog

NEW = ("plain_rows.share.stream", "plain_fill.stream", "plain_ms.stream")
CELL = "tweets2011.or_top10"


def reader(name):
    return run_mod.load_reader(name, run_mod.ROOT)


def synthetic(send, spans, exec_stats, units=2):
    log = SpanLog()
    for name, s, e in spans:
        log.add(name, s, e)
    return run_mod.Run(send=send, spans=log, t0=10.0, t1=20.0, units=units,
                       exec_stats=exec_stats)


SPANS = [
    ("pipeline.submit", 10.0, 10.6),
    ("batch.submit", 10.1, 10.6),
    ("submit.plain", 10.1, 10.3),
    ("submit.plain", 10.3, 10.45),
    ("submit.plain", 12.0, 12.05),
    ("submit.plain", 25.0, 25.5),      # after the window
]
COUNTERS = {"candidate": 30, "dense": 2, "plain.lanes": 3000,
            "plain.plane_lanes": 12000, "plain.groups": 3, "gc.us": 10}


def test_readings_of_a_made_up_run():
    run = synthetic("pipelined", SPANS, COUNTERS)
    assert reader("plain_rows.share.stream")(run) == 1.0
    assert reader("plain_fill.stream")(run) == pytest.approx(0.25)
    assert reader("plain_ms.stream")(run) == pytest.approx(
        (0.2 + 0.15 + 0.05) * 1e3 / 2)
    mixed = dict(COUNTERS, prefix=90, sliced=8)
    assert reader("plain_rows.share.stream")(
        synthetic("pipelined", SPANS, mixed)) == pytest.approx(32 / 130)


def test_the_parent_reads_nothing_new():
    """An engine without the ``plain.*`` counters and ``submit.plain``
    spans: the fill and the span read None and none raises; the row
    share reads the route counters that engine has."""
    old = [("pipeline.submit", 10.0, 10.6), ("batch.submit", 10.1, 10.6)]
    run = synthetic("pipelined", old, {"candidate": 32})
    assert reader("plain_fill.stream")(run) is None
    assert reader("plain_ms.stream")(run) is None
    assert reader("plain_rows.share.stream")(run) == 1.0
    empty = synthetic("pipelined", [], {})
    for name in NEW:
        assert reader(name)(empty) is None


def test_each_reader_keeps_to_a_stream():
    for name in NEW:
        assert reader(name)(synthetic("requests", SPANS, COUNTERS)) is None


def tiny_root(dst: str) -> str:
    """BENCHMARK.json and a copy of perfbench/ whose tweets2011
    configuration and or_top10 mix are cut to CPU size."""
    shutil.copy(os.path.join(run_mod.ROOT, "BENCHMARK.json"), dst)
    pb = os.path.join(dst, "perfbench")
    shutil.copytree(run_mod.HERE, pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, cut in (("configs/tweets2011.json",
                      dict(documents=6000, vocabulary=8000)),
                     ("traffic/or_top10.json",
                      dict(batch=64, batches_per_call=2, prefetch_qps=400,
                           warmup_calls=1, check_sample=40))):
        path = os.path.join(pb, rel)
        with open(path) as f:
            data = json.load(f)
        data.update(cut)
        with open(path, "w") as f:
            json.dump(data, f)
    return dst


def test_tiny_traced_cell_reads_the_new_metrics(tmp_path, monkeypatch):
    """The routes that the planner gates off from 2**24 slots are
    switched off here, so every row takes the candidate or dense
    executor, as in the cell at its size."""
    for gate in ("_prefix_mode", "_use_sliced", "_use_blockdense"):
        monkeypatch.setattr(psearch, gate, lambda *a, **kw: False)
    root = tiny_root(str(tmp_path))
    out = run_mod.run_cell(CELL, 2**31 + 1919, 1, True, torch.device("cpu"),
                           root=root, t_start=time.perf_counter(),
                           log=lambda m: None)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert set(NEW) <= set(m)
    assert m["plain_rows.share.stream"] == {"value": 1.0, "unit": "1"}
    assert 0 < m["plain_fill.stream"]["value"] <= 1
    assert m["plain_ms.stream"]["value"] > 0
    assert m["plain_ms.stream"]["unit"] == "ms"
