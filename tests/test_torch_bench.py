"""bench_torch.py, the port's benchmark, on the CPU at a tiny tier.

The corpus (20,000 documents, vocabulary 6,000 so that typos take the
device sweep, mean length 20) is built once by ``--build-only`` into a
cache root under the test's temporary directory.  The benchmark then
fast-opens it and prints bench.py's JSON line with bench.py's ``detail``
fields and the port's own.  On the same corpus and the same pure-OR
trace, the port's route counters equal the reference's ``EXEC_STATS``
(the port's router patched to the reference's CPU router, as in
``test_torch_fallback_exec.py``).  bench_torch.py and chip_smoke.py import
neither jax nor nxsearch_tpu, and ``--device`` defaults to the card.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import bench_torch
import nxsearch_tpu
import nxsearch_tpu.search as jsearch
import nxsearch_tpu_torch
from nxsearch_tpu_torch import search as psearch
from nxsearch_tpu_torch.utils.trace import ROUTE_COUNTERS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIER = ["--docs", "20000", "--vocab", "6000", "--mean-len", "20"]
RUN = TIER + ["--queries", "256", "--batch", "64", "--device", "cpu"]
N_TRACE = 256

# bench.py's ``detail`` fields (bench.py:373-410); the ingest fields
# appear only on a fresh build, the fuzzy ones whenever its tier ran.
BENCH_FIELDS = ("docs", "vocab", "mean_len", "batch", "batched_qps",
                "qps_samples", "qps_median", "steal_variance", "seq_p50_ms",
                "seq_p99_ms", "seq_cold_events", "seq_cold_max_ms",
                "fuzzy_qps", "fuzzy_p50_ms", "exec_stats", "real_corpora")
PORT_FIELDS = ("device", "open_s", "snapshot_s", "snapshot_bytes",
               "peak_device_bytes", "host_peak_rss_bytes")


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tiny tier's tensors are small: one intra-op thread runs them
    faster, and keeps doing so when the suite's workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The tiny tier built once by --build-only: (cache root, its
    basedir, the build's JSON line)."""
    root = str(tmp_path_factory.mktemp("bench_cache"))
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_torch, "CACHE_ROOT", root)
        mp.setenv("NXS_MALLOC_TUNE", "0")
        with contextlib.redirect_stdout(out):
            assert bench_torch.main(["--build-only", *TIER]) == 0
    line = last_json(out.getvalue())
    return root, line["cache"], line


@pytest.fixture
def at_cache(cache, monkeypatch):
    monkeypatch.setattr(bench_torch, "CACHE_ROOT", cache[0])
    monkeypatch.setenv("NXS_MALLOC_TUNE", "0")
    return cache


def test_build_only_publishes_the_cache(at_cache, capsys):
    root, basedir, line = at_cache
    assert line["built"] and line["ingest_s"] > 0
    assert basedir == os.path.join(root, "d20000-v6000-l20-s42")
    assert os.path.isdir(os.path.join(basedir, "data", "bench"))
    assert not os.path.exists(basedir + ".partial")
    # A second build finds the cache and builds nothing.
    assert bench_torch.main(["--build-only", *TIER]) == 0
    again = last_json(capsys.readouterr().out)
    assert again["cache"] == basedir and not again["built"]


def test_json_line_has_bench_fields(at_cache, capsys):
    assert bench_torch.main(RUN) == 0
    line = last_json(capsys.readouterr().out)
    assert line["metric"] == "bm25_top10_search_qps"
    assert line["unit"] == "queries/s" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 10_000.0, 4)
    detail = line["detail"]
    missing = [f for f in BENCH_FIELDS + PORT_FIELDS if f not in detail]
    assert not missing
    assert "ingest_docs_per_s" not in detail          # a cached corpus
    assert (detail["docs"], detail["vocab"], detail["mean_len"]) == \
        (20000, 6000, 20)
    assert 3 <= len(detail["qps_samples"]) <= 6
    assert detail["batched_qps"] == max(detail["qps_samples"])
    assert detail["fuzzy_qps"] > 0 and detail["seq_p50_ms"] > 0
    assert detail["device"] == {"type": "cpu", "name": None, "card": None}
    assert detail["peak_device_bytes"] is None
    snap = detail["snapshot_bytes"]
    assert snap["postings_pack"] > 0 and snap["total"] == sum(
        v for k, v in snap.items() if k != "total")
    stats = detail["exec_stats"]
    assert stats.get("prefix", 0) > 0, stats


def test_route_counters_equal_reference(at_cache, monkeypatch):
    """bench_torch's pure-OR trace (make_queries, seed 42) over the
    cached corpus: the port's route counters equal nxsearch_tpu's."""
    _root, basedir, _line = at_cache
    args = bench_torch.parse_args(RUN)
    words = np.array([f"w{i:05d}" for i in range(args.vocab)])
    probs = 1.0 / (np.arange(args.vocab, dtype=np.float64) + 10.0)
    probs /= probs.sum()
    queries = bench.make_queries(N_TRACE, words, probs,
                                 np.random.default_rng(42))
    monkeypatch.setattr(psearch, "_use_blockdense", lambda *a, **kw: False)
    counters = []
    for nxs in (nxsearch_tpu.Nxs(basedir),
                nxsearch_tpu_torch.Nxs(basedir, device="cpu")):
        stats = (jsearch if isinstance(nxs, nxsearch_tpu.Nxs)
                 else psearch).EXEC_STATS
        try:
            idx = nxs.index_open("bench")
            idx.search("w00001")                   # builds the snapshot
            stats.clear()
            got = idx.search_many(queries, nxsearch_tpu_torch.Params()
                                  .set_uint("limit", 10))
            assert len(got) == N_TRACE
            counters.append(dict(sorted(
                (k, v) for k, v in stats.items()
                if k in ROUTE_COUNTERS)))
        finally:
            nxs.close()
    ref, port = counters
    assert ref.get("prefix", 0) > 0 and sum(ref.values()) >= N_TRACE
    assert port == ref


def test_auto_tier(tmp_path, monkeypatch):
    """No --docs: the north-star tier when its cached corpus exists,
    else the 1M tier (bench.py's rule)."""
    monkeypatch.setattr(bench_torch, "CACHE_ROOT", str(tmp_path))
    args = bench_torch.parse_args([])
    assert (args.docs, args.vocab, args.mean_len) == (1_000_000, 200_000, 40)
    os.makedirs(tmp_path / "d8800000-v1000000-l60-s42" / "data" / "bench")
    args = bench_torch.parse_args([])
    assert (args.docs, args.vocab, args.mean_len) == \
        (8_800_000, 1_000_000, 60)
    assert args.device == "cuda"
    args = bench_torch.parse_args(["--docs", "5000"])
    assert (args.vocab, args.mean_len) == (1000, 40)


def test_cuda_without_a_card_raises(at_cache, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main(TIER + ["--queries", "64", "--batch", "64"])


def test_entry_points_import_without_jax():
    """bench_torch.py and chip_smoke.py import in a process in which jax
    cannot be imported, and import neither jax nor nxsearch_tpu."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.path.insert(0, {ROOT!r})
import bench_torch
import chip_smoke
from nxsearch_tpu_torch import Nxs
assert not any(m == "jax" or m.startswith(("jax.", "nxsearch_tpu."))
               or m == "nxsearch_tpu"
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout == "ok\n"
    for name in ("bench_torch.py", "chip_smoke.py"):
        with open(os.path.join(ROOT, name), encoding="utf-8") as f:
            src = f.read()
        assert "import jax" not in src and "from jax" not in src, name
        assert "import nxsearch_tpu\n" not in src, name
        assert "from nxsearch_tpu " not in src, name
        assert "from nxsearch_tpu." not in src, name
