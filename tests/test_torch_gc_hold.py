"""The collector hold (nxsearch_tpu_torch/utils/trace.py
``collector_hold``): automatic cyclic collection held off for the span
of a search call, nested holds, exceptions, a collector the application
turned off, overlapping calls on threads; that the search paths leave no
cyclic garbage for the collector; and ``check_nesting``'s limit without
its recursive closure."""

import gc
import queue
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

import nxsearch_tpu_torch
from nxsearch_tpu.errors import NxsError as JNxsError
from nxsearch_tpu.ops.boolean import check_nesting as j_check_nesting
from nxsearch_tpu_torch.errors import ErrorCode, NxsError
from nxsearch_tpu_torch.ops.boolean import QUERY_NESTING_LIMIT, check_nesting
from nxsearch_tpu_torch.query.ast import (EXPR_OP_AND, EXPR_OP_NOT,
                                          EXPR_OP_OR, Expr)
from nxsearch_tpu_torch.utils import trace
from nxsearch_tpu_torch.utils.trace import collector_hold


@pytest.fixture
def collector_on():
    """The collector on, no hold open; the collector's state restored
    after."""
    was = gc.isenabled()
    gc.enable()
    assert trace._holders == 0
    yield
    assert trace._holders == 0
    (gc.enable if was else gc.disable)()


def _hits(key):
    return trace.COUNTERS.get(key, 0)


class _Cycle:
    pass


def _cyclic_garbage():
    """One unreachable reference cycle; a weak reference to it."""
    c = _Cycle()
    c.me = c
    return weakref.ref(c)


# -- the hold ------------------------------------------------------------------

def test_hold_nests_and_releases_on_exception(collector_on):
    n = _hits("gc.hold")
    with collector_hold():
        assert not gc.isenabled()
        with collector_hold():
            assert not gc.isenabled()
        assert not gc.isenabled()        # the outer hold still holds
    assert gc.isenabled()
    with pytest.raises(ValueError):
        with collector_hold():
            with collector_hold():
                raise ValueError("inside a held call")
    assert gc.isenabled()
    # A hold nested on its thread is part of the outer one: two calls.
    assert _hits("gc.hold") == n + 2


def test_hold_leaves_a_disabled_collector_off(collector_on):
    gc.disable()
    n = _hits("gc.hold_collect")
    with collector_hold():
        assert not gc.isenabled()
    assert not gc.isenabled()
    # Nor does it collect for calls that overlap: the application chose.
    a, b = _Holder(), _Holder()
    try:
        a.do("enter")
        for _ in range(4):
            b.do("enter")
            a.do("exit")
            a.do("enter")
            b.do("exit")
        a.do("exit")
    finally:
        a.stop()
        b.stop()
    assert not gc.isenabled()
    assert _hits("gc.hold_collect") == n


def test_held_call_runs_no_collection(collector_on):
    threshold = gc.get_threshold()[0]
    gen0 = _hits("gc.gen0")
    with collector_hold():
        kept = [[] for _ in range(10 * threshold)]
        assert gc.get_count()[0] > threshold
        assert _hits("gc.gen0") == gen0
    assert len(kept) == 10 * threshold


class _Holder:
    """A thread that enters and leaves the hold on command, one step at a
    time, so a test sets the exact interleaving of two threads' calls."""

    def __init__(self):
        self.todo = queue.Queue()
        self.done = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        held = []
        while True:
            step = self.todo.get()
            if step is None:
                return
            try:
                if step == "enter":
                    held.append(collector_hold())
                    held[-1].__enter__()
                else:
                    held.pop().__exit__(None, None, None)
                self.done.put(None)
            except BaseException as e:       # handed to the test thread
                self.done.put(e)

    def do(self, step):
        self.todo.put(step)
        err = self.done.get(timeout=30)
        if err is not None:
            raise err

    def stop(self):
        self.todo.put(None)
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def test_overlapping_calls_still_collect(collector_on):
    """Two threads whose calls overlap for many rounds, so that one of
    them always holds: the releases run young collections, one for each
    call that outlasts the last (not one a release), and cyclic garbage
    made between calls is reclaimed within two calls."""
    n = _hits("gc.hold_collect")
    a, b = _Holder(), _Holder()
    rounds = 0
    try:
        a.do("enter")
        for _ in range(50):
            ref = _cyclic_garbage()
            calls = 0
            while ref() is not None:
                assert calls < 2 and trace._holders > 0
                first, second = (a, b) if calls % 2 == 0 else (b, a)
                second.do("enter")
                first.do("exit")
                first.do("enter")
                second.do("exit")
                calls += 1
            rounds += calls
        a.do("exit")
    finally:
        a.stop()
        b.stop()
    assert gc.isenabled()
    assert _hits("gc.hold_collect") - n == rounds >= 50


def test_hold_under_many_threads(collector_on):
    """16 threads enter and leave the hold 300 times each with the
    interpreter switching threads every microsecond: no count is lost,
    and the collector is on again when the last leaves."""
    n = _hits("gc.hold")
    interval = sys.getswitchinterval()
    errors = []

    def work():
        try:
            for _ in range(300):
                with collector_hold():
                    _ = [[] for _ in range(3)]
        except BaseException as e:
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    assert _hits("gc.hold") == n + 16 * 300
    assert trace._holders == 0 and gc.isenabled()


def test_hold_counters_are_collector_keys():
    # Route comparisons leave every collector key out.
    assert trace.GC_COUNTERS[:4] == ("gc.gen0", "gc.gen1", "gc.gen2",
                                     "gc.us")
    assert {"gc.hold", "gc.hold_collect"} <= set(trace.GC_COUNTERS)


# -- the search paths make no cyclic garbage -----------------------------------

LETTERS, VOWELS = "bcdfghjklmnpqrstvz", "aeiou"


def _corpus():
    rng = np.random.default_rng(3)
    words = sorted({"".join(rng.choice(list(LETTERS)) + rng.choice(list(VOWELS))
                            for _ in range(4)) + "t" for _ in range(2500)})
    p = 1.0 / (np.arange(len(words)) + 10.0)
    p /= p.sum()
    docs = [(i + 1, " ".join(rng.choice(words, size=int(rng.integers(5, 40)),
                                        p=p))) for i in range(3000)]
    pq = p ** 0.35 / (p ** 0.35).sum()

    def queries(n):
        return [" ".join(rng.choice(words, size=int(rng.integers(1, 6)),
                                    replace=False, p=pq)) for _ in range(n)]

    plain = queries(128)
    boolean = ([f"{a} AND {b}" for a, b in zip(queries(32), queries(32))]
               + [f"{a} AND NOT {b}" for a, b in zip(queries(32),
                                                     queries(32))])
    typos = [w[:2] + w[3] + w[2] + w[4:] for w in rng.choice(words, 32)]
    return docs, plain, boolean, typos


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    docs, plain, boolean, typos = _corpus()
    out = {}
    for name, mesh in (("one", None), ("mesh", [torch.device("cpu")] * 2)):
        nxs = nxsearch_tpu_torch.Nxs(str(tmp_path_factory.mktemp(name)),
                                     device="cpu", mesh=mesh)
        idx = nxs.index_create("t")
        idx.add_many(docs)
        out[name] = (nxs, idx)
    yield out, plain, boolean, typos
    for nxs, _ in out.values():
        nxs.close()


ROUTES = {
    "search_many": ("one", lambda idx, q: idx.search_many(q["plain"])),
    "search_pipelined": ("one", lambda idx, q: [
        r for b in idx.search_pipelined([q["plain"][:64], q["plain"][64:]])
        for r in b]),
    "search": ("one", lambda idx, q: [idx.search(x) for x in q["plain"][:8]]
               + [idx.search(x) for x in q["boolean"][:8]]),
    "boolean": ("one", lambda idx, q: idx.search_many(q["boolean"])),
    "fuzzy": ("one", lambda idx, q: idx.search_many(q["typos"])),
    "mesh": ("mesh", lambda idx, q: idx.search_many(q["plain"]
                                                    + q["boolean"])),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_search_route_leaves_no_cyclic_garbage(indexes, route):
    """Every object a search makes dies by reference counting: with the
    collector off, two calls leave nothing unreachable behind."""
    out, plain, boolean, typos = indexes
    where, run = ROUTES[route]
    idx = out[where][1]
    q = {"plain": plain, "boolean": boolean, "typos": typos}
    got = run(idx, q)                       # warm-up (snapshot, memos)
    assert sum(len(r.results) for r in got) > 0
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        run(idx, q)
        run(idx, q)
        unreachable = gc.collect()
    finally:
        (gc.enable if was else gc.disable)()
    assert unreachable == 0, route


# -- check_nesting -------------------------------------------------------------

def _chain(depth, op):
    """A tree whose deepest leaf lies ``depth`` levels below its root."""
    node = Expr.leaf("a")
    for i in range(depth):
        leaf = Expr.leaf(f"b{i}")
        node = (Expr.operator(op, node, leaf) if i % 2
                else Expr.operator(op, leaf, node))
    return node


@pytest.mark.parametrize("op", [EXPR_OP_AND, EXPR_OP_OR, EXPR_OP_NOT])
@pytest.mark.parametrize("depth", [0, 1, QUERY_NESTING_LIMIT - 1,
                                   QUERY_NESTING_LIMIT,
                                   QUERY_NESTING_LIMIT + 1,
                                   QUERY_NESTING_LIMIT + 40])
def test_check_nesting_limit(depth, op):
    """Passes at the limit and raises LIMIT past it, as the JAX
    package's recursive walk does, with the same message."""
    root = _chain(depth, op)
    try:
        j_check_nesting(root)
        want = None
    except JNxsError as e:
        want = (int(e.code), e.msg)
    if depth <= QUERY_NESTING_LIMIT:
        assert want is None
        check_nesting(root)
        return
    with pytest.raises(NxsError) as got:
        check_nesting(root)
    assert got.value.code == ErrorCode.LIMIT
    assert (int(got.value.code), got.value.msg) == want


def test_check_nesting_limit_of_a_balanced_tree():
    """A deep leaf under a wide, shallow tree still counts."""
    def balanced(levels):
        if levels == 0:
            return Expr.leaf("x")
        return Expr.operator(EXPR_OP_OR, balanced(levels - 1),
                             balanced(levels - 1))

    root = Expr.operator(EXPR_OP_AND, balanced(6),
                         _chain(QUERY_NESTING_LIMIT, EXPR_OP_OR))
    with pytest.raises(NxsError) as got:
        check_nesting(root)
    assert got.value.code == ErrorCode.LIMIT
    check_nesting(Expr.operator(EXPR_OP_AND, balanced(6),
                                _chain(QUERY_NESTING_LIMIT - 1,
                                       EXPR_OP_OR)))
