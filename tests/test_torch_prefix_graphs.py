"""The CUDA graph cache of the impact-prefix dispatch groups
(nxsearch_tpu_torch/ops/graphs.py, search._dispatch_prefix) on the CPU:
the capture is replaced by a stand-in that runs the chain eagerly on
each replay, so the bookkeeping runs here -- the key, eager on a
signature's first sighting, capture on its second and replay after, a
new cache with each generation ``refresh`` installs, no engagement for
R > 0 groups, a mesh or a CPU device, the LRU limit, and two threads.
The card-only tests in tests/test_torch_cuda.py hold real graphs to the
eager chain."""

import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import bench
from nxsearch_tpu_torch import Nxs, Params
from nxsearch_tpu_torch import search as psearch
from nxsearch_tpu_torch.index.device import DeviceIndex
from nxsearch_tpu_torch.ops import graphs
from nxsearch_tpu_torch.utils.trace import GRAPH_COUNTERS

KEY_FIELDS = {"n_pad", "qs", "T", "R", "n_run", "k", "k_ret", "M", "algo",
              "alive_all", "n_slots"}
LIMIT10 = Params().set_uint("limit", 10)


class StandIn:
    """What stands in for ``graphs.CapturedChain`` in these tests: the chain kept
    and run eagerly at each replay, over a static input buffer into a
    static output, as a CUDA graph reads and writes them."""

    made: list = []

    def __init__(self, device, n, fn, pool):
        self.static_in = torch.empty(n, dtype=torch.int32)
        self.fn, self.pool = fn, None
        StandIn.made.append(self)

    def replay(self, host_in):
        self.static_in.copy_(torch.from_numpy(host_in))
        time.sleep(0)                   # another thread may run here
        self.static_out = self.fn(self.static_in)
        return self.static_out.clone()


def _engage_on_cpu(dev, r):
    """search._prefix_graphs without its device test."""
    return None if r or hasattr(dev, "mesh") else dev.prefix_graphs


@pytest.fixture
def stand_in(monkeypatch):
    StandIn.made = []
    monkeypatch.setattr(graphs, "CapturedChain", StandIn)
    return StandIn


@pytest.fixture
def corpus(tmp_path):
    nxs = Nxs(str(tmp_path), device="cpu")
    idx = nxs.index_create("t")
    idx.add_many(bench.zipf_range(0, 3000, 6000, 20))
    words = np.array([f"w{i:05d}" for i in range(6000)])
    probs = 1.0 / (np.arange(6000) + 10.0)
    yield nxs, idx, words, probs / probs.sum()
    nxs.close()


def _counts():
    return {k: psearch.EXEC_STATS.get(k, 0) for k in GRAPH_COUNTERS}


def _answers(monkeypatch, idx, queries, on: bool):
    monkeypatch.setattr(psearch, "_prefix_graphs",
                        _engage_on_cpu if on else _REAL_PREFIX_GRAPHS)
    return [r.results for r in idx.search_many(queries, LIMIT10)]


_REAL_PREFIX_GRAPHS = psearch._prefix_graphs


# -- the cache alone -----------------------------------------------------------

def _double(t):
    return t * 2


def test_eager_then_capture_then_replay(stand_in):
    cache = graphs.GraphCache(torch.device("cpu"))
    snap = (torch.zeros(1),)
    a = np.arange(6, dtype=np.int32)
    hows = []
    for i in range(4):
        out, how = cache.run("A", snap, a + i, _double)
        assert torch.equal(out, torch.from_numpy((a + i) * 2))
        hows.append(how)
    assert hows == ["eager", "capture", "replay", "replay"]
    assert len(stand_in.made) == 1
    assert cache.run("B", snap, a, _double)[1] == "eager"
    assert list(cache.graphs) == ["A"]


def test_lru_limit(stand_in):
    cache = graphs.GraphCache(torch.device("cpu"), limit=2)
    snap = (torch.zeros(1),)
    a = np.zeros(4, dtype=np.int32)
    for key in "AABB":
        cache.run(key, snap, a, _double)
    assert cache.run("A", snap, a, _double)[1] == "replay"
    assert list(cache.graphs) == ["B", "A"]      # A used last
    for key in "CC":
        cache.run(key, snap, a, _double)
    assert list(cache.graphs) == ["A", "C"]      # B evicted
    # An evicted signature was seen: it is captured again at once.
    assert cache.run("B", snap, a, _double)[1] == "capture"
    assert list(cache.graphs) == ["C", "B"]
    assert len(stand_in.made) == 4
    assert graphs.LIMIT >= 26


def test_threads_keep_their_own_results(stand_in):
    """More threads than cores on two signatures, thread switches as
    often as the interpreter allows: every result is its own input's,
    which a replay whose static input another thread overwrote would
    break."""
    cache = graphs.GraphCache(torch.device("cpu"))
    snap = (torch.zeros(1),)
    errors = []

    def worker(t):
        try:
            for i in range(150):
                a = np.full(8, t * 1000 + i, dtype=np.int32)
                out, _how = cache.run("AB"[i % 2], snap, a, _double)
                assert torch.equal(out, torch.from_numpy(a * 2))
        except BaseException as e:          # noqa: BLE001 - reported below
            errors.append(e)

    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(was)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert list(cache.graphs) == ["A", "B"] and len(stand_in.made) == 2


def test_other_snapshot_tensors_drop_the_graphs(stand_in):
    cache = graphs.GraphCache(torch.device("cpu"))
    a = np.zeros(4, dtype=np.int32)
    first, second = (torch.zeros(1),), (torch.zeros(1),)
    for _ in range(2):
        cache.run("A", first, a, _double)
    assert list(cache.graphs) == ["A"]
    assert cache.run("A", second, a, _double)[1] == "eager"
    assert not cache.graphs


# -- engagement ----------------------------------------------------------------

def test_engages_only_for_r0_groups_on_one_cuda_device():
    cache = object()
    card = types.SimpleNamespace(device=torch.device("cuda"),
                                 prefix_graphs=cache)
    assert psearch._prefix_graphs(card, 0) is cache
    assert psearch._prefix_graphs(card, 1) is None
    mesh = types.SimpleNamespace(device=torch.device("cuda"), mesh=[],
                                 prefix_graphs=cache)
    assert psearch._prefix_graphs(mesh, 0) is None
    cpu = types.SimpleNamespace(device=torch.device("cpu"),
                                prefix_graphs=cache)
    assert psearch._prefix_graphs(cpu, 0) is None


def test_cpu_search_counts_no_graph_groups(corpus, stand_in):
    _nxs, idx, words, probs = corpus
    queries = bench.make_queries(96, words, probs, np.random.default_rng(1))
    psearch.EXEC_STATS.clear()
    for _ in range(3):
        idx.search_many(queries, LIMIT10)
    assert psearch.EXEC_STATS.get("prefix", 0) > 0
    assert not set(GRAPH_COUNTERS) & set(psearch.EXEC_STATS)
    assert not idx.dev.prefix_graphs.seen and not stand_in.made


def test_wide_groups_stay_eager(corpus, stand_in, monkeypatch):
    """R > 0 groups (wide terms on) never reach the cache; the R = 0
    groups beside them do."""
    _nxs, idx, words, probs = corpus
    # The snapshot is built at the first search, with the region.
    monkeypatch.setattr(DeviceIndex, "PREFIX_CAP", 64)
    monkeypatch.setattr(DeviceIndex, "WIDE_MIN_DF", 64)
    monkeypatch.setattr(psearch, "_PREFIX_MAX_WIDE", 4)
    queries = bench.make_queries(120, words, probs, np.random.default_rng(5))
    want = _answers(monkeypatch, idx, queries, False)
    seen_r = []
    real_run = graphs.GraphCache.run

    def run(self, key, *a):
        seen_r.append(dict(key)["R"])
        return real_run(self, key, *a)

    monkeypatch.setattr(graphs.GraphCache, "run", run)
    psearch.EXEC_STATS.clear()
    for _ in range(2):
        assert _answers(monkeypatch, idx, queries, True) == want
    assert idx.dev.prefix_stats["wide_terms"] > 0
    assert psearch.EXEC_STATS.get("prefix", 0) > 0
    assert seen_r and set(seen_r) == {0}


def test_mesh_groups_stay_eager(tmp_path, stand_in, monkeypatch):
    from nxsearch_tpu_torch.parallel import make_mesh
    nxs = Nxs(str(tmp_path), mesh=make_mesh([torch.device("cpu")] * 2))
    idx = nxs.index_create("t")
    idx.add_many(bench.zipf_range(0, 3000, 6000, 20))
    words = np.array([f"w{i:05d}" for i in range(6000)])
    probs = 1.0 / (np.arange(6000) + 10.0)
    queries = bench.make_queries(64, words, probs / probs.sum(),
                                 np.random.default_rng(8))
    monkeypatch.setattr(psearch, "_prefix_graphs", _engage_on_cpu)
    psearch.EXEC_STATS.clear()
    for _ in range(2):
        idx.search_many(queries, LIMIT10)
    assert psearch.EXEC_STATS.get("sharded_prefix", 0) > 0
    assert not set(GRAPH_COUNTERS) & set(psearch.EXEC_STATS)
    assert not stand_in.made
    nxs.close()


# -- the cache in the search path ------------------------------------------------

def test_key_and_passes_match_the_eager_chain(corpus, stand_in, monkeypatch):
    """Three passes of one request: every answer equal to the eager
    chain's; a signature eager once, captured once; the third pass all
    replays."""
    _nxs, idx, words, probs = corpus
    queries = bench.make_queries(200, words, probs, np.random.default_rng(2))
    want = _answers(monkeypatch, idx, queries, False)
    passes = []
    for _ in range(3):
        psearch.EXEC_STATS.clear()
        assert _answers(monkeypatch, idx, queries, True) == want
        passes.append(_counts())
    cache = idx.dev.prefix_graphs
    groups = sum(passes[0].values())
    assert groups > 1
    assert all(sum(p.values()) == groups for p in passes)
    assert passes[0]["prefix.graph_eager"] == len(cache.seen)
    assert passes[2] == {"prefix.graph_replay": groups,
                         "prefix.graph_capture": 0, "prefix.graph_eager": 0}
    assert sum(p["prefix.graph_capture"] for p in passes) == \
        len(cache.graphs) == len(stand_in.made) == len(cache.seen)
    dev = idx.dev
    for key in cache.graphs:
        k = dict(key)
        assert set(k) == KEY_FIELDS
        assert k["R"] == 0 and k["n_slots"] == dev.n_slots
        assert k["alive_all"] is dev.alive_all
        assert k["k_ret"] == 10 and k["k"] >= 10
        assert k["n_pad"] in (1, 8) or k["n_pad"] % 64 == 0


def test_two_chunks_of_one_signature_keep_their_results(
        corpus, stand_in, monkeypatch):
    """Groups chunked to 8 rows: one batch dispatches one signature many
    times, and each chunk answers its own rows."""
    _nxs, idx, words, probs = corpus
    monkeypatch.setattr(psearch, "_group_rows_cap", lambda dev, key: 8)
    queries = bench.make_queries(160, words, probs, np.random.default_rng(3))
    want = _answers(monkeypatch, idx, queries, False)
    psearch.EXEC_STATS.clear()
    for _ in range(2):
        assert _answers(monkeypatch, idx, queries, True) == want
    assert psearch.EXEC_STATS["prefix.graph_replay"] > len(
        idx.dev.prefix_graphs.graphs)


def test_pipelined_batches_match(corpus, stand_in, monkeypatch):
    _nxs, idx, words, probs = corpus
    queries = bench.make_queries(240, words, probs, np.random.default_rng(4))
    batches = [queries[i: i + 60] for i in range(0, 240, 60)]
    want = [r.results for r in idx.search_many(queries, LIMIT10)]
    monkeypatch.setattr(psearch, "_prefix_graphs", _engage_on_cpu)
    psearch.EXEC_STATS.clear()
    for _ in range(2):
        got = idx.search_pipelined(batches, LIMIT10)
        assert [r.results for b in got for r in b] == want
    assert psearch.EXEC_STATS["prefix.graph_replay"] > 0


def test_refresh_installs_a_new_cache(corpus, stand_in, monkeypatch):
    """A bulk add after captures: the next search runs on a new
    generation with an empty cache, and answers from the new
    snapshot."""
    _nxs, idx, words, probs = corpus
    queries = bench.make_queries(120, words, probs, np.random.default_rng(6))
    for _ in range(2):
        _answers(monkeypatch, idx, queries, True)
    old = idx.dev.prefix_graphs
    assert old.graphs
    idx.add_many(bench.zipf_range(3000, 6000, 6000, 20))
    psearch.EXEC_STATS.clear()
    got = _answers(monkeypatch, idx, queries, True)
    new = idx.dev.prefix_graphs
    assert new is not old and not new.graphs
    assert psearch.EXEC_STATS["prefix.graph_eager"] == sum(_counts().values())
    assert _answers(monkeypatch, idx, queries, True) == got
    assert new.graphs
    assert _answers(monkeypatch, idx, queries, False) == got
    assert any(d > 3000 for r in got for d, _s in r)


def test_two_threads_get_their_own_answers(corpus, stand_in, monkeypatch):
    _nxs, idx, words, probs = corpus
    rng = np.random.default_rng(7)
    sets = [bench.make_queries(64, words, probs, rng) for _ in range(2)]
    wants = [_answers(monkeypatch, idx, q, False) for q in sets]
    monkeypatch.setattr(psearch, "_prefix_graphs", _engage_on_cpu)
    errors = []

    def worker(queries, want):
        try:
            for _ in range(6):
                got = idx.search_many(queries, LIMIT10)
                assert [r.results for r in got] == want
        except BaseException as e:          # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(q, w))
               for q, w in zip(sets, wants)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert psearch.EXEC_STATS["prefix.graph_replay"] > 0
