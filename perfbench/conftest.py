"""Shared fixtures of the benchmark's CPU tests: a tiny copy of the
benchmark (the same files, configurations and mixes cut to a size the
CPU runs in seconds) in a temporary root."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_DOCS = {"msmarco_passage": 20000, "trec_covid": 3000}
TINY_VOCAB = 8000
# The mixed mix's cell and its kernel's metric, kept as files for a
# later cell: the tiny copy adds them as entries, as that change will.
LATER_CELLS = [{"name": "msmarco.mixed_top10", "config": "msmarco_passage",
                "traffic": "mixed_top10", "chips": 1,
                "why": "masked planner, interpreter, fuzzy, Myers"}]
LATER_METRICS = [{"name": "myers_roofline", "unit": "%", "better": "higher",
                  "source": "device_trace",
                  "layer": "kernels, ops/kernels.py and csrc/",
                  "moves": "search_qps",
                  "workloads": ["msmarco.mixed_top10"]}]
STREAM_METRICS = ("prep_ms.stream", "plan_ms.stream", "submit_ms.stream",
                  "prefix_rows.share.stream", "device.idle.stream",
                  "ingest_s", "snapshot_s")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def make_tiny_root(dst: str) -> str:
    """A root holding BENCHMARK.json and a copy of perfbench/ whose
    configurations and mixes are cut to CPU size."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    names = {w["name"] for w in bench["workloads"]}
    for cell in LATER_CELLS:
        if cell["name"] not in names:
            bench["workloads"].append(cell)
            for m in bench["per_layer"]:
                if m["name"] in STREAM_METRICS:
                    m["workloads"].append(cell["name"])
    have = {m["name"] for m in bench["per_layer"]}
    bench["per_layer"] += [m for m in LATER_METRICS if m["name"] not in have]
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    shutil.copytree(HERE, os.path.join(dst, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = os.path.join(dst, "perfbench")
    for name, docs in TINY_DOCS.items():
        path = os.path.join(pb, "configs", f"{name}.json")
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(documents=docs, vocabulary=TINY_VOCAB)
        with open(path, "w") as f:
            json.dump(cfg, f)
    tdir = os.path.join(pb, "traffic")
    for fn in os.listdir(tdir):
        path = os.path.join(tdir, fn)
        with open(path) as f:
            tp = json.load(f)
        tp.update(batch=64 if tp["send"] == "pipelined" else 32,
                  batches_per_call=min(tp.get("batches_per_call", 1), 2),
                  prefetch_qps=400, warmup_calls=1, check_sample=40,
                  check_typos=min(tp["check_typos"], 10))
        with open(path, "w") as f:
            json.dump(tp, f)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny")))
