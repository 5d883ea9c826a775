"""The tweets2011 configuration's regime on the CPU: past 2**24 device
slots, ``search_pipelined`` answers as the benchmark's plain reference
does.

The benchmark's cell ``tweets2011.or_top10`` holds 16,000,000 tweets,
which pad the snapshot to 2**24 device slots (``_pad_size``: past
15,728,640 documents the next multiple of 2**20), where the planner
routes every row to the candidate or dense executor over the exact
int32 slot column.  Here a corpus of the configuration's query shape
is made by ``perfbench/corpus.py`` at the fewest documents that cross
that gate, 15,728,641, of one or two words (a smaller vocabulary, so
the CPU builds it in about half a minute), and indexed through the
harness's bulk add.  Its ranked-OR top-10 answers, and those of one
boolean row of 39 terms (the dense executor), are held to
``perfbench/reference.py`` (float64): ids exact up to ties within
1e-4, scores within 1e-4.  The same index carries the candidate and
dense groups' ``submit.plain`` spans and ``plain.*`` counters, and the
snapshot's ``snapshot.slot_exact`` span.
"""

import json
import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import nxsearch_tpu_torch
from nxsearch_tpu_torch import search as psearch
from nxsearch_tpu_torch.index.device import DeviceIndex, _pad_size
from nxsearch_tpu_torch.utils import trace
from perfbench import corpus as corpus_mod
from perfbench import traffic as traffic_mod
from perfbench.reference import Reference, compare

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "perfbench", "configs", "tweets2011.json")
GATE = 15 * (1 << 20)            # the most documents padded below 2**24
N_DOCS = GATE + 1
SEED = 2**31 + 1911
LIMIT = 10
TOL = 1e-4
BATCH = 8
N_BATCHES = 2
WIDE_TERMS = 39                  # past the 32 terms a candidate row holds
LOGGER = "nxsearch_tpu.trace"


def load_config() -> dict:
    with open(CONFIG) as f:
        return json.load(f)


def test_configuration_pads_past_2_24_slots():
    """The configuration's document count keeps the cell in its regime:
    its snapshot has 2**24 device slots or more, and the count the
    configuration names as its floor is the first that does."""
    cfg = load_config()
    assert cfg["reduced"] == []
    assert cfg["documents"] >= N_DOCS
    assert _pad_size(cfg["documents"], DeviceIndex._MIN_SLOTS) >= 1 << 24
    assert _pad_size(N_DOCS, DeviceIndex._MIN_SLOTS) == 1 << 24
    assert _pad_size(GATE, DeviceIndex._MIN_SLOTS) < 1 << 24


@pytest.fixture(scope="module")
def tweets(tmp_path_factory):
    """The index, its corpus, traffic and reference, and the spans of
    its snapshot build (tracing on for the build)."""
    cfg = load_config()
    cfg.update(documents=N_DOCS, mean_doc_words=0.5, vocabulary=100_000)
    with open(os.path.join(ROOT, "perfbench", "traffic",
                           "or_top10.json")) as f:
        tp = json.load(f)
    tp.update(batch=BATCH)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    nxs = nxsearch_tpu_torch.Nxs(str(tmp_path_factory.mktemp("tweets")),
                                 device="cpu")
    log = logging.getLogger(LOGGER)
    saved = (log.level, log.propagate)
    null = logging.NullHandler()
    try:
        idx = nxs.index_create("tweets")

        def ingest(lo, dl, n_pairs, rank, count, strings):
            # As perfbench/run.py adds a chunk: term id = rank + 1.
            ptr = np.zeros(len(dl) + 1, dtype=np.int64)
            np.cumsum(n_pairs, out=ptr[1:])
            pairs = np.empty((len(rank), 2), dtype=np.uint32)
            pairs[:, 0] = rank
            pairs[:, 1] = count
            idx.host.add_bulk_arrays(
                np.arange(lo + 1, lo + len(dl) + 1, dtype=np.int64),
                strings, pairs, ptr, dl.astype(np.uint32))

        corpus = corpus_mod.make_corpus(cfg, SEED, torch.device("cpu"),
                                        on_chunk=ingest)
        log.addHandler(null)
        log.setLevel(logging.DEBUG)
        log.propagate = False
        trace.reset()
        idx.search(corpus.strings[0])              # builds the snapshot
        build = [s for s in trace.spans() if s.name.startswith("snapshot.")]
        log.removeHandler(null)
        log.setLevel(saved[0])
        log.propagate = saved[1]
        trace.reset()
        tr = traffic_mod.make_traffic("or_top10", tp, cfg, corpus.strings,
                                      SEED, N_BATCHES)
        # One boolean row of WIDE_TERMS terms of middling frequency:
        # ``t0 ... t37 AND NOT t38``, the traffic's ``andnot`` form.
        ranks = list(range(200, 200 + WIDE_TERMS))
        toks = [corpus.strings[r] for r in ranks]
        wide = traffic_mod.Query(
            f"{' '.join(toks[:-1])} AND NOT {toks[-1]}", ranks, "andnot")
        ref = Reference(corpus, torch.device("cpu"))
        yield SimpleNamespace(idx=idx, corpus=corpus, traffic=tr, wide=wide,
                              ref=ref, build=build, n_post=len(
                                  corpus.pair_rank))
    finally:
        log.removeHandler(null)
        log.setLevel(saved[0])
        log.propagate = saved[1]
        nxs.close()
        torch.set_num_threads(threads)


def batches(t) -> list:
    return [t.traffic.batch(b) for b in range(N_BATCHES)]


def queries(t) -> list:
    return [t.traffic.query(i) for i in range(N_BATCHES * BATCH)]


def params():
    return nxsearch_tpu_torch.Params().set_uint("limit", LIMIT)


def hold_to_reference(t, qs: list, got: list) -> None:
    assert len(got) == len(qs)
    misses, gap = 0, 0.0
    for q, a in zip(qs, got):
        want, acc = t.ref.answer(q, LIMIT)
        m, g = compare(a.results, want, acc, TOL)
        assert m == 0, (q.text, a.results, want)
        misses += m
        gap = max(gap, g)
    assert misses == 0 and gap <= TOL, (misses, gap)


def test_snapshot_holds_2_24_slots_and_an_exact_slot_column(tweets):
    dev = tweets.idx.dev
    assert dev.n_slots == 1 << 24
    assert dev.postings_slot is dev._slot_exact
    assert dev.postings_slot.dtype == torch.int32
    n = tweets.n_post
    assert torch.equal(dev.postings_slot[:n].to(torch.float32),
                       dev.postings_pack[:n, 0])


def test_pipelined_or_answers_equal_the_reference(tweets):
    """Every row on the candidate or dense executor; the answers are
    the reference's."""
    psearch.EXEC_STATS.clear()
    got = [r for b in tweets.idx.search_pipelined(batches(tweets), params())
           for r in b]
    stats = psearch.EXEC_STATS
    assert not any(stats.get(k, 0) for k in ("prefix", "sliced",
                                             "blockdense")), stats
    assert stats.get("candidate", 0) + stats.get("dense", 0) == len(got)
    assert sum(len(a.results) for a in got) > 0
    hold_to_reference(tweets, queries(tweets), got)


def test_wide_boolean_row_takes_the_dense_executor(tweets):
    psearch.EXEC_STATS.clear()
    got = [r for b in tweets.idx.search_pipelined([[tweets.wide.text]],
                                                  params()) for r in b]
    assert psearch.EXEC_STATS.get("dense", 0) == 1, psearch.EXEC_STATS
    assert len(got[0].results) == LIMIT
    hold_to_reference(tweets, [tweets.wide], got)


def test_snapshot_slot_exact_span(tweets):
    """The exact column's build and upload: one span inside the
    snapshot's build, over the corpus's postings."""
    by = {}
    for s in tweets.build:
        by.setdefault(s.name, []).append(s)
    (col,) = by["snapshot.slot_exact"]
    (build,) = by["snapshot.build"]
    assert col.parent == build.id
    assert col.attrs["postings"] == tweets.n_post
    (pack,) = by["snapshot.pack"]
    assert pack.end_ns <= col.start_ns


@pytest.fixture
def tracing():
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


def test_plain_groups_have_spans_and_counters(tweets, tracing, monkeypatch):
    """One ``submit.plain`` span a candidate or dense dispatch group,
    under its batch's ``batch.submit``; ``plain.lanes`` is the sum of
    the dispatched plans' q_len, ``plain.plane_lanes`` the planes'
    padded lanes, ``plain.groups`` the dispatches."""
    seen = []
    dispatch = psearch._dispatch_plain

    def spy(dev, key, plans, sp, k, n_pad):
        seen.append((list(plans), n_pad))
        return dispatch(dev, key, plans, sp, k, n_pad)

    monkeypatch.setattr(psearch, "_dispatch_plain", spy)
    psearch.EXEC_STATS.clear()
    got = [r for b in tweets.idx.search_pipelined(
        batches(tweets) + [[tweets.wide.text]], params()) for r in b]
    assert len(got) == N_BATCHES * BATCH + 1
    stats = dict(psearch.EXEC_STATS)
    assert {k for k in stats if k.startswith("plain.")} == \
        set(trace.PLAIN_COUNTERS)
    lanes = [sum(int(p.q_len.sum()) for p in plans) for plans, _ in seen]
    planes = [n_pad * (tweets.idx.dev.n_slots if plans[0].use_dense
                       else plans[0].budget) for plans, n_pad in seen]
    assert stats["plain.groups"] == len(seen) >= 2
    assert stats["plain.lanes"] == sum(lanes) > 0
    assert stats["plain.plane_lanes"] == sum(planes)
    assert stats["plain.plane_lanes"] >= stats["plain.lanes"]
    assert any(plans[0].use_dense for plans, _ in seen)
    assert sum(len(plans) for plans, _ in seen) == len(got)

    spans = trace.spans()
    submits = {s.id for s in spans if s.name == "batch.submit"}
    plain = [s for s in spans if s.name == "submit.plain"]
    assert len(submits) == N_BATCHES + 1
    assert len(plain) == len(seen)
    for s, (plans, _), n in zip(plain, seen, lanes):
        assert s.parent in submits
        attrs = {k: s.attrs.get(k) for k in ("rows", "budget", "dense",
                                             "lanes")}
        assert attrs == {"rows": len(plans), "budget": plans[0].budget,
                         "dense": bool(plans[0].use_dense), "lanes": n}
