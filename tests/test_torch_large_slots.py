"""Snapshots of 2**24 device slots and more: the port answers exactly.

A real index of just over 2**24 documents (``large_slots_corpus``: a
snapshot of 17,825,792 device slots) on the CPU.  The planner gates the
impact-prefix, sliced and blockdense routes below 2**24 slots, as the
reference's does, so every query takes the candidate or dense
executor; they read the snapshot's exact int32 slot column.  Documents
in odd and even device slots past 2**24, and below it, come back by
their own ids through ``search_many``, ``search_pipelined`` and
``search``, under BM25 and TF-IDF, with scores within 1e-4 of a numpy
oracle (f64, ties to the lowest device slot; delta documents after
the base snapshot's), before and after a delta add and a removal past
2**24.  The same index on a mesh of one device (a shard of 2**24 slots
or more) answers through the mesh's candidate and dense bodies, which
read the exact int32 shard column: its documents in odd and even
global slots past 2**24 come back with the oracle's ids and scores.
The last test mutates the shared index.

At the executor level the reference's fault is kept on record: its
candidate executor, given the slot column derived from its f32 pack,
names slot 2**24 where the port names 2**24 + 1.
"""

import math

import numpy as np
import pytest
import torch

import large_slots_corpus as corpus
import nxsearch_tpu_torch
from nxsearch_tpu_torch import search as psearch
from nxsearch_tpu_torch.index.device import DeviceIndex
from nxsearch_tpu_torch.parallel import make_mesh
from nxsearch_tpu_torch.parallel import sharded as psharded
from nxsearch_tpu_torch.utils.trace import ROUTE_COUNTERS
from nxsearch_tpu_torch.query.ast import (EXPR_OP_AND, EXPR_OP_OR,
                                          EXPR_VAL_TOKEN)
from nxsearch_tpu_torch.query.parser import parse_query

TOL = 1e-4
LIMIT = 30
ALGOS = {"BM25": 0, "TF-IDF": 1}


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    nxs = nxsearch_tpu_torch.Nxs(str(tmp_path_factory.mktemp("big")),
                                 device="cpu")
    try:
        idx = nxs.index_create("big")
        corpus.add_corpus(idx.host)
        with pytest.MonkeyPatch.context() as mp:
            # f0 alone (df 4159) above the dense-row threshold.
            mp.setattr(DeviceIndex, "DENSE_DF_DIV", 4300)
            idx.search("tail")                   # builds the snapshot
        yield idx
    finally:
        nxs.close()
        torch.set_num_threads(threads)


def params(algo: str):
    return nxsearch_tpu_torch.Params().set_uint("limit", LIMIT).set_str(
        "algo", algo)


class Oracle:
    """Straightforward f64 BM25 / TF-IDF over the host index's live
    postings; ties to the lowest device slot, delta documents (past the
    base snapshot) after every base document."""

    def __init__(self, idx, algo: str):
        self.host = host = idx.host
        dev = idx.dev
        self.algo = ALGOS[algo]
        self.rank = np.arange(host.doc_ids.n, dtype=np.int64) + dev.n_slots
        self.rank[dev.slot_perm] = np.arange(len(dev.slot_perm))
        self.n = host.doc_count
        self.adl = float(host.token_count // host.doc_count)

    def term(self, word):
        """(term id, {host slot: score}) of one query word."""
        host = self.host
        t = host.term_lookup(word)
        if t is None:
            return None, {}
        df = int(host.term_df.a[t - 1])
        if self.algo == 1:
            idf = math.log(float(np.float32(self.n) / np.float32(df))) + 1.0
        else:
            idf = math.log((self.n - df + 0.5) / (df + 0.5) + 1.0)
        out = {}
        for s in host.term_docs(t).tolist():
            tf = host.get_doc_termcount(int(host.doc_ids.a[s]), t)
            ltf = math.log(tf + 1.0)
            if self.algo == 1:
                out[s] = ltf * idf
            else:
                dl = float(host.doc_len.a[s])
                out[s] = ltf / (ltf + 1.2 * (0.25 + 0.75 * dl / self.adl)) \
                    * idf
        return t, out

    def top(self, query: str, limit: int = LIMIT):
        """[(doc id, score)] of the query's top ``limit`` documents."""
        root = parse_query(query)
        acc, seen = {}, set()

        def docs(expr):
            if expr.type == EXPR_VAL_TOKEN:
                t, scores = self.term(expr.value)
                if t is not None and t not in seen:
                    seen.add(t)
                    for s, v in scores.items():
                        acc[s] = acc.get(s, 0.0) + v
                return set(scores)
            left, right = (docs(e) for e in expr.elements)
            if expr.type == EXPR_OP_AND:
                return left & right
            if expr.type == EXPR_OP_OR:
                return left | right
            return left - right

        match = docs(root)
        hit = sorted(match, key=lambda s: (-acc[s], self.rank[s]))[:limit]
        return [(int(self.host.doc_ids.a[s]), acc[s]) for s in hit]


def check(oracle, queries, responses, limit: int = LIMIT):
    assert len(responses) == len(queries)
    for q, resp in zip(queries, responses):
        want = oracle.top(q, limit)
        got = resp.results
        assert [d for d, _ in got] == [d for d, _ in want], q
        np.testing.assert_allclose([s for _, s in got],
                                   [s for _, s in want], rtol=0, atol=TOL,
                                   err_msg=q)


def run(idx, entry: str, queries, sp):
    if entry == "search_many":
        return idx.search_many(queries, sp)
    if entry == "search_pipelined":
        half = len(queries) // 2
        return [r for b in idx.search_pipelined(
            [queries[:half], queries[half:]], sp) for r in b]
    return [idx.search(q, sp) for q in queries]


def assert_plain_routes(n_rows: int):
    """The reference's routing from 2**24 slots: candidate and dense
    rows only."""
    stats = psearch.EXEC_STATS
    assert not any(stats.get(k, 0) for k in ("prefix", "sliced",
                                             "blockdense")), stats
    assert stats.get("candidate", 0) + stats.get("dense", 0) == n_rows, stats


def test_snapshot_keeps_an_exact_slot_column(big):
    dev = big.dev
    assert dev.n_slots == 17_825_792 and dev.n_slots >= 1 << 24
    col = dev.postings_slot
    assert col.dtype == torch.int32 and col.shape[0] == dev.n_postings
    rounded = 0
    for k, host_slot in enumerate(corpus.TAIL_HOST):
        slot = corpus.device_slot_of(dev, host_slot + 1)
        assert slot == corpus.N_DOCS - corpus.TAIL + k
        start, n = dev.term_range(big.host.term_lookup(f"u{k}"))
        assert n == 1 and int(col[start]) == slot
        rounded += int(dev.postings_pack[start, 0]) != slot
    assert rounded == corpus.TAIL // 2          # the odd ones, in f32
    dev.drop_legacy_cols()
    assert dev.postings_slot is col             # never dropped


def test_dense_row_scattered_by_exact_slots(big):
    """The dense row of f0 holds its ltf at its exact device slots,
    odd ones past 2**24 included (the f32 slots would move them)."""
    dev = big.dev
    t = big.host.term_lookup("f0")
    assert dev.dense_row_of == {t: 0}
    start, n = dev.term_range(t)
    slots = dev.postings_slot[start: start + n].long()
    assert ((slots >= 1 << 24) & (slots % 2 == 1)).any()
    want = torch.zeros(dev.n_slots)
    want[slots] = dev.postings_ltf[start: start + n]
    assert torch.equal(dev.dense_rows[0], want)


@pytest.mark.parametrize("entry", ["search_many", "search_pipelined",
                                   "search"])
@pytest.mark.parametrize("algo", list(ALGOS))
def test_answers_past_2_24_slots(big, algo, entry):
    psearch.EXEC_STATS.clear()
    got = run(big, entry, corpus.QUERIES, params(algo))
    assert_plain_routes(len(corpus.QUERIES))
    check(Oracle(big, algo), corpus.QUERIES, got)
    # Every tail document came back, from odd and even slots past 2**24.
    tail = {d for r in got for d, _ in r.results
            if d - 1 in corpus.TAIL_HOST}
    assert len(tail) == corpus.TAIL


@pytest.mark.parametrize("entry", ["search_many", "search"])
def test_dense_executor_past_2_24_slots(big, entry):
    psearch.EXEC_STATS.clear()
    got = run(big, entry, [corpus.WIDE], params("BM25"))
    assert psearch.EXEC_STATS.get("dense", 0) == 1
    assert_plain_routes(1)
    check(Oracle(big, "BM25"), [corpus.WIDE], got)
    assert len(got[0].results) == LIMIT


@pytest.fixture(scope="module")
def mesh_big(big):
    """``big`` on a mesh of one CPU device, through a second handle over
    its basedir (global slot == host slot)."""
    big.checkpoint()                 # the second handle opens this
    nxs = nxsearch_tpu_torch.Nxs(big.nxs.basedir,
                                 mesh=make_mesh([torch.device("cpu")]))
    try:
        idx = nxs.index_open("big")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(DeviceIndex, "DENSE_DF_DIV", 4300)
            idx.search("tail")                   # builds the shard
        yield idx
    finally:
        nxs.close()


# Every document of f0 (df 4159, each of length 1: all tie) and every
# match of the dense query fit under this limit.
MESH_LIMIT = 4200
MESH_DENSE = ("(" + " ".join([f"u{k}" for k in range(corpus.TAIL)]
                             + [f"p{m}" for m in range(corpus.TAIL // 2)]
                             + ["low0", "low1", "f0"]) + ") AND NOT p3")


@pytest.mark.parametrize("query,dense", [("f0", False),
                                         (MESH_DENSE, True)])
def test_mesh_shard_past_2_24_slots(mesh_big, big, monkeypatch, query,
                                    dense):
    """A mesh whose one shard holds 2**24 slots or more: the mesh's
    prefix, sliced and kernel bodies are gated below 2**24 per shard,
    so ``f0`` takes the candidate body and the 40-term query the dense
    body, over the exact int32 shard column.  The 64 documents of host
    (= global) slots 2**24 .. 2**24 + 63, odd and even, hold f0: each
    comes back with the oracle's ids and scores, ties to the lowest
    host slot."""
    assert mesh_big.dev.slots_per_shard >= 1 << 24
    bodies = []
    batch = psharded.sharded_search_batch

    def spy(*a, **kw):
        bodies.append(kw["use_dense"])
        return batch(*a, **kw)

    monkeypatch.setattr(psharded, "sharded_search_batch", spy)
    psearch.EXEC_STATS.clear()
    sp = nxsearch_tpu_torch.Params().set_uint("limit", MESH_LIMIT)
    got = mesh_big.search_many([query], sp)
    assert {k: v for k, v in psearch.EXEC_STATS.items()
            if k in ROUTE_COUNTERS} == \
        {"sharded_fallback": 1}
    assert bodies == [dense]
    oracle = Oracle(big, "BM25")
    oracle.rank = np.arange(big.host.doc_ids.n)
    check(oracle, [query], got, MESH_LIMIT)
    past = {d for d, _ in got[0].results if d - 1 >= 1 << 24}
    assert past == set(range((1 << 24) + 1, (1 << 24) + 65))


def test_reference_names_the_even_neighbour():
    """The reference's candidate executor reads the slot column its
    snapshot derives from the f32 pack (``_pack_slot_column``): for a
    posting in slot 2**24 + 1 it names slot 2**24.  The port's dispatch
    over the exact column names 2**24 + 1."""
    import jax.numpy as jnp

    from nxsearch_tpu.index.device import _pack_slot_column
    from nxsearch_tpu.ops import executor as jexec

    slots = [(1 << 24) + 1, (1 << 24) + 3]
    cols = corpus.plain_columns(slots)
    pack = np.zeros((4096, 3), dtype=np.float32)
    pack[:2, 0] = cols["slot"]
    pack[:2, 1] = cols["ltf"]
    j_slot = _pack_slot_column(jnp.asarray(pack), p_pad=4096)
    plan = corpus.plain_plan(0, False)
    _s, want = jexec.device_search_batch(
        j_slot, np.pad(cols["ltf"], (0, 4094)), cols["dl"], cols["alive"],
        plan.q_start[None], plan.q_len[None], plan.q_idf[None],
        np.float32(1.0), plan.prog_ops[None], plan.prog_args[None],
        budget=plan.budget, k=16, algo=0, use_mask=False, depth=4)
    assert int(np.asarray(want)[0, 0]) == 1 << 24

    sp = psearch.SearchParams(limit=10, algo=0, fuzzymatch=False)
    packed = psearch._dispatch_plain(
        corpus.plain_dev(slots), psearch._Plan.batch_key.fget(plan), [plan],
        sp, 16, 1)
    _s, got = psearch.unpack_bits(packed.numpy())
    assert int(got[0, 0]) == slots[0]


def test_delta_and_removal_past_2_24_slots(big):
    """A delta document merged beside the base answers, then a removal
    of the tail document in the odd device slot 2**24 + 41: it leaves
    every answer (runs last: it mutates the shared index)."""
    sp = params("BM25")
    new_id = corpus.N_DOCS + 1
    big.add(new_id, "tail tail u1")
    queries = ["tail", "u1", "p0", "u1 low1"]
    got = big.search_many(queries, sp)
    assert big.dev.has_delta
    check(Oracle(big, "BM25"), queries, got)
    assert new_id in [d for d, _ in got[0].results]

    gone = corpus.TAIL_HOST[1] + 1
    assert corpus.device_slot_of(big.dev, gone) == (1 << 24) + 41
    assert gone in [d for d, _ in got[1].results]
    big.remove(gone)
    for entry in ("search_many", "search_pipelined", "search"):
        got = run(big, entry, queries, sp)
        check(Oracle(big, "BM25"), queries, got)
        assert all(gone not in [d for d, _ in r.results] for r in got)
