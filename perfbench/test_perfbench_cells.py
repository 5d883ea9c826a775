"""Tiny cells of every mix, end to end on the CPU: the run's answers
equal the plain reference's, its rate and tail take the whole window,
the control and planted faults come out not correct, and a new cell,
mix and metric come as files alone."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import corpus as corpus_mod
from perfbench import run as run_mod
from perfbench.control import control

SEED = 2**31 + 4321
CELLS = ["msmarco.or_top10", "trec_covid.or_requests",
         "msmarco.mixed_top10"]
CPU = torch.device("cpu")


def run(root, cell, trace=False, seconds=1, seed=SEED):
    return run_mod.run_cell(cell, seed, seconds, trace, CPU, root=root,
                            t_start=time.perf_counter(), log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_answers_equal_the_reference(tiny_root, cell):
    out = run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["rank_misses"]["value"] == 0
    assert out["checks"]["answers_checked"]["value"] >= 40
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(out)[-1] == "checks"
    bench = run_mod.load_bench(tiny_root)
    want = {m["name"] for m in bench["end_to_end"]
            if run_mod.applies(m, cell)}
    assert set(out["metrics"]) == want


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cell_reads_its_layers(tiny_root, cell):
    out = run(tiny_root, cell, trace=True)
    assert out["correct"], out["checks"]
    names = set(out["metrics"])
    assert {"ingest_s", "snapshot_s"} <= names
    if cell.startswith("msmarco"):
        assert {"prep_ms.stream", "plan_ms.stream", "submit_ms.stream",
                "prefix_rows.share.stream"} <= names
    else:
        assert {"prep_ms.requests", "plan_ms.requests",
                "request_p50_ms.host", "request_p95_ms.host"} <= names
    # No device on the CPU: the device readers find nothing to read.
    assert not any(n.startswith("device.") or "roofline" in n
                   for n in names)


def test_mixed_check_covers_every_route(tiny_root, monkeypatch):
    seen = {}
    real = run_mod.Reference.answer

    def answer(self, q, limit):
        seen.setdefault(q.form, 0)
        seen[q.form] += 1
        seen["typo"] = seen.get("typo", 0) + (q.typo >= 0)
        return real(self, q, limit)

    monkeypatch.setattr(run_mod.Reference, "answer", answer)
    out = run(tiny_root, "msmarco.mixed_top10")
    assert out["correct"]
    assert seen["or"] and seen["and"] and seen["andnot"] and seen["typo"]


def test_stall_moves_rate_and_tail(tiny_root, monkeypatch):
    """A stall inside the window lowers the rate and raises the tail:
    both are taken over all the window's work and requests."""
    from nxsearch_tpu_torch.nxs import Index

    cell = "trec_covid.or_requests"
    base = run(tiny_root, cell, seconds=2)["metrics"]
    base_tail = run(tiny_root, cell, seconds=2, trace=True)["metrics"]
    real = Index.search_many
    n = [0]

    def stalled(self, queries, params=None):
        n[0] += 1
        if n[0] % 3 == 0:
            time.sleep(0.3)
        return real(self, queries, params)

    monkeypatch.setattr(Index, "search_many", stalled)
    slow = run(tiny_root, cell, seconds=2)["metrics"]
    slow_tail = run(tiny_root, cell, seconds=2, trace=True)["metrics"]
    assert slow["search_qps"]["value"] < 0.8 * base["search_qps"]["value"]
    assert (slow_tail["request_p95_ms.host"]["value"]
            > base_tail["request_p95_ms.host"]["value"] + 200)
    assert (slow_tail["request_p50_ms.host"]["value"]
            < base_tail["request_p95_ms.host"]["value"] + 200)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    out = control(cell, SEED, CPU, root=tiny_root, seconds=1)
    assert not out["correct"]
    assert (out["rank_misses"]["value"] > 0
            and out["score_gap"]["value"] > out["score_gap"]["limit"])


def _alter_scores(monkeypatch):
    from nxsearch_tpu_torch import search as search_mod

    real = search_mod.collect_query_batch

    def altered(*a, **kw):
        out = real(*a, **kw)
        resps = out[0] if isinstance(out, tuple) else out
        for r in resps:
            r._results = [(d, s + 1e-3) for d, s in r.results]
        return out

    monkeypatch.setattr(search_mod, "collect_query_batch", altered)


def _drop_half(monkeypatch):
    from nxsearch_tpu_torch.nxs import Index
    from nxsearch_tpu_torch.resp import Response

    real_many, real_pipe = Index.search_many, Index.search_pipelined

    def half(resps):
        return resps[: len(resps) // 2] + [
            Response([]) for _ in resps[len(resps) // 2:]]

    monkeypatch.setattr(Index, "search_many",
                        lambda self, q, p=None: half(real_many(self, q, p)))
    monkeypatch.setattr(
        Index, "search_pipelined",
        lambda self, b, p=None: [half(x) for x in real_pipe(self, b, p)])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_dropped"])
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    (_alter_scores if fault == "answer_altered" else _drop_half)(
        monkeypatch)
    out = run(tiny_root, cell)
    assert not out["correct"], out["checks"]


def test_new_cell_mix_and_metric_come_as_files(tiny_root, tmp_path):
    """A later change adds a configuration, a traffic mix and a
    per-layer metric as new files and BENCHMARK.json entries; the
    harness runs the new cell unedited."""
    import shutil

    root = str(tmp_path)
    shutil.copy(os.path.join(tiny_root, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(tiny_root, "perfbench"),
                    os.path.join(root, "perfbench"))
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "configs", "trec_covid.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_extra", documents=1500, mean_doc_words=30.0,
               vocabulary=6000)
    with open(os.path.join(pb, "configs", "tiny_extra.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "mixed_top10.json")) as f:
        tp = json.load(f)
    tp.update(send="requests", batch=16, typo_share=0.2, and_share=0.3,
              and_not_share=0.2)
    with open(os.path.join(pb, "traffic", "extra_mix.json"), "w") as f:
        json.dump(tp, f)
    with open(os.path.join(pb, "metrics", "extra_calls.py"), "w") as f:
        f.write("def read(run):\n    return run.requests\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_extra", "source": "a test",
                             "file": "perfbench/configs/tiny_extra.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_extra.extra_mix",
                               "config": "tiny_extra",
                               "traffic": "extra_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "extra_calls", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "search_qps",
                               "workloads": ["tiny_extra.extra_mix"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out = run(root, "tiny_extra.extra_mix", trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["extra_calls"]["value"] > 0
    out = run(root, "tiny_extra.extra_mix")
    assert set(out["metrics"]) == {"search_qps", "setup_s"}


def _copy_with_mix(tiny_root, tmp_path, **change):
    """A copy of the tiny root whose mixed mix has ``change``."""
    import shutil

    root = str(tmp_path)
    shutil.copy(os.path.join(tiny_root, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(tiny_root, "perfbench"),
                    os.path.join(root, "perfbench"))
    path = os.path.join(root, "perfbench", "traffic", "mixed_top10.json")
    with open(path) as f:
        tp = json.load(f)
    tp.update(change)
    with open(path, "w") as f:
        json.dump(tp, f)
    return root


def test_window_past_the_drawn_batches_sends_fresh_ones(tiny_root, tmp_path,
                                                        monkeypatch):
    """A window that outruns the batches set-up drew draws new ones: no
    batch and no typo is sent twice, and the answers stay correct."""
    from nxsearch_tpu_torch.nxs import Index

    root = _copy_with_mix(tiny_root, tmp_path, prefetch_qps=1)
    sent = []
    real = Index.search_pipelined

    def record(self, batches, params=None):
        sent.extend(tuple(b) for b in batches)
        return real(self, batches, params)

    monkeypatch.setattr(Index, "search_pipelined", record)
    out = run(root, "msmarco.mixed_top10", seconds=2)
    assert out["correct"], out["checks"]
    with open(os.path.join(root, "perfbench", "traffic",
                           "mixed_top10.json")) as f:
        tp = json.load(f)
    per_call = tp["batches_per_call"]
    drawn = (tp["warmup_calls"] + 1) * per_call + -(-2 // tp["batch"])
    assert len(sent) > drawn
    assert len(set(sent)) == len(sent)
    with open(os.path.join(root, "perfbench", "configs",
                           "msmarco_passage.json")) as f:
        cfg = json.load(f)
    words = set(corpus_mod.word_strings(corpus_mod.make_words(
        cfg["vocabulary"], SEED, cfg["word_len_min"], cfg["word_len_max"],
        cfg["word_len_mean"])))
    typos = [w for b in sent for q in b for w in q.split()
             if w not in words and w not in ("AND", "NOT")]
    assert typos and len(set(typos)) == len(typos)


def test_unknown_send_is_refused(tiny_root, tmp_path):
    """A mix that asks for a way of sending the harness does not know
    exits non-zero with no result, card or none."""
    root = _copy_with_mix(tiny_root, tmp_path, send="one_by_one")
    with pytest.raises(ValueError):
        run(root, "msmarco.mixed_top10")
    res = subprocess.run(
        [sys.executable, os.path.join(root, "perfbench", "run.py"),
         "--workload", "msmarco.mixed_top10", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "one_by_one" in res.stderr


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert "nxsearch_tpu_torch" in sys.modules
    assert run_mod.forbidden_modules() == []
    for name in ("jaxlib.xla", "nxsearch_tpu", "nxsearch_tpu.ops", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run_mod.forbidden_modules() == ["flax", "jaxlib", "nxsearch_tpu"]


def test_run_imports_no_jax():
    """A whole CPU run in a fresh process loads no module of JAX or of
    the JAX package."""
    code = (
        "import sys, time, torch; sys.path.insert(0, %r)\n"
        "from perfbench import run\n"
        "import conftest\n"
        "import tempfile\n"
        "root = conftest.make_tiny_root(tempfile.mkdtemp())\n"
        "out = run.run_cell('trec_covid.or_requests', 7, 1, True,"
        " torch.device('cpu'), root=root, log=lambda m: None)\n"
        "assert out['correct']\n"
        "print(run.forbidden_modules())\n") % run_mod.ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=run_mod.HERE,
                         env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, os.path.join(run_mod.HERE, "run.py"), "--workload",
         "trec_covid.or_requests", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


@pytest.mark.cuda
def test_control_on_the_card(cuda_card, tiny_root):
    for seed in (11, 12, 13):
        out = control("msmarco.mixed_top10", seed, cuda_card, root=tiny_root,
                      seconds=1)
        assert not out["correct"]


@pytest.mark.cuda
def test_tiny_cells_on_the_card(cuda_card, tiny_root):
    for cell in CELLS:
        out = run_mod.run_cell(cell, SEED, 1, True, cuda_card,
                               root=tiny_root, log=lambda m: None)
        assert out["correct"], out["checks"]
        assert out["device"]["busy_s"] > 0
