"""Tracing: structured spans, counters and the collector's account.

The reference has no tracing beyond the benchmark CLI's wall-clock
printer (src/utils/benchmark.c:44-70); SURVEY §5 calls for profiler
hooks and per-phase timings in the rebuild.

- ``phase(name, **attrs)``: the one span API.  Tracing is on while the
  ``nxsearch_tpu.trace`` logger is enabled for DEBUG (NXS_LOG_LEVEL=DEBUG,
  or a handler that sets the level).  Off, a span costs one level check
  and reads no clock.  On, it records a ``Span`` in a bounded ring
  (``spans()``) and logs ``<name>: <ms> ms`` at DEBUG when it ends.
- ``COUNTERS`` / ``count()``: the engine's counters (``search.EXEC_STATS``
  is this dict).  The collector hook adds ``gc.gen0`` / ``gc.gen1`` /
  ``gc.gen2`` (collections by generation) and ``gc.us`` (their time),
  always, and a ``host.gc`` span while tracing is on.
- ``collector_hold()``: holds automatic collection off for the span of a
  search call (``nxs.Index``'s search entry points), counted in
  ``gc.hold`` / ``gc.hold_collect``.
- ``profiler_trace(logdir)``: wraps ``torch.profiler.profile`` so a
  block of searches can be captured as a TensorBoard / Chrome trace;
  enabled with NXS_PROFILE_DIR or explicitly.

Times are ``time.perf_counter_ns()``, the clock of ``time.perf_counter``.
A leaf span (one that held no other) and a ``host.gc`` span also carry
how their thread stalled inside them, from ``getrusage(RUSAGE_THREAD)``
read at their open and close: ``offcpu_ms``, the wall time less the
thread's user and system time (preemption, waits on locks, the GIL or
the device), ``sys_ms`` (the thread's system time, split from its user
time at the kernel's tick), ``minflt`` / ``majflt`` (page faults) and
``nivcsw`` / ``nvcsw`` (involuntary / voluntary context switches).  A
span that held others carries none: its children's and the time between
them say it, and the reads would cost more than they tell.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass, field

try:
    import resource
    _RUSAGE_THREAD = getattr(resource, "RUSAGE_THREAD", None)
except ImportError:                      # pragma: no cover - not POSIX
    resource = None
    _RUSAGE_THREAD = None

from .log import get_logger

_log = get_logger("trace")
_DEBUG = logging.DEBUG

# -- counters --------------------------------------------------------------

# Executor-path counters (observability; reset freely).  The route
# counters, ROUTE_COUNTERS: prefix / prefix_exact / sliced /
# sliced_head / blockdense / candidate / dense count QUERIES routed
# through each path, prefix_fallback the uncertified prefix rows re-run
# classically and prefix_spec_used those a speculative twin answered,
# sliced_masked / sliced_masked_rows the masked sliced rows and those
# of them on the masked dense-row hybrid; coalesced / coalesced_pf
# count rows merged into widened groups; sharded_prefix /
# sharded_sliced / sharded_fallback count a mesh's rows by shard body
# (search._count_route bumps the routes; the reference's EXEC_STATS
# keeps the same names, less the two sliced_masked ones).  The collector
# hook and the collector hold add GC_COUNTERS; the candidate and dense
# dispatch groups (search._dispatch_plain) add PLAIN_COUNTERS: the
# posting lanes their rows hold, the lanes of their planes as
# dispatched, and the dispatches.  Impact-prefix groups dispatched on a
# CUDA device (search._dispatch_prefix) add GRAPH_COUNTERS: the groups
# that replayed a captured CUDA graph, that captured one, and that ran
# eagerly.
COUNTERS: dict[str, int] = {}
ROUTE_COUNTERS = ("prefix", "prefix_exact", "prefix_fallback",
                  "prefix_spec_used", "sliced", "sliced_head",
                  "sliced_masked", "sliced_masked_rows", "blockdense",
                  "candidate", "dense", "coalesced", "coalesced_pf",
                  "sharded_prefix", "sharded_sliced", "sharded_fallback")
GC_COUNTERS = ("gc.gen0", "gc.gen1", "gc.gen2", "gc.us", "gc.hold",
               "gc.hold_collect")
PLAIN_COUNTERS = ("plain.lanes", "plain.plane_lanes", "plain.groups")
GRAPH_COUNTERS = ("prefix.graph_replay", "prefix.graph_capture",
                  "prefix.graph_eager")
# Request threads of the service search concurrently: the counters'
# read-modify-write takes this lock, so no count is lost.
_COUNT_LOCK = threading.Lock()


def count(key: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        COUNTERS[key] = COUNTERS.get(key, 0) + n


def counters() -> dict:
    """A copy of the counters."""
    return dict(COUNTERS)


# -- spans -----------------------------------------------------------------

@dataclass(slots=True)
class Span:
    """One finished span, as ``spans()`` returns it.  ``parent`` is the
    id of the span that was open on the same thread when this one opened
    (None at the top); ``seq`` numbers spans in the order they closed."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    thread: int
    seq: int
    attrs: dict = field(default_factory=dict)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


CAPACITY = 1 << 16
# Records are flat tuples: a Span's fields, then its attributes' keys
# and values in turn.  A tuple of atomic values leaves the collector's
# lists at its first collection (a dict or a nested tuple would keep it
# there longer), so a full ring adds nothing to what a generation-2
# sweep walks.
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_seqs = itertools.count()
_seq_base = 0
_local = threading.local()


def _enabled() -> bool:
    """The trace logger's level, read without the logging module's lock
    (the collector hook runs inside whatever code allocated)."""
    log = _log
    if log.disabled or log.manager.disable >= _DEBUG:
        return False
    while log is not None:
        if log.level:
            return log.level <= _DEBUG
        log = log.parent
    return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _rusage():
    return (None if _RUSAGE_THREAD is None
            else resource.getrusage(_RUSAGE_THREAD))


def _stalls(attrs: dict, wall_ns: int, r0, r1) -> None:
    """The stall attributes between two readings around ``wall_ns``.
    The kernel brings a running thread's CPU time up to date at its
    scheduler tick, so ``offcpu_ms`` is good to about a tick and can
    read below 0 by as much."""
    if r0 is None or r1 is None:
        return
    cpu_s = (r1.ru_utime - r0.ru_utime) + (r1.ru_stime - r0.ru_stime)
    attrs["offcpu_ms"] = round(wall_ns / 1e6 - cpu_s * 1e3, 3)
    attrs["sys_ms"] = round((r1.ru_stime - r0.ru_stime) * 1e3, 3)
    attrs["minflt"] = r1.ru_minflt - r0.ru_minflt
    attrs["majflt"] = r1.ru_majflt - r0.ru_majflt
    attrs["nivcsw"] = r1.ru_nivcsw - r0.ru_nivcsw
    attrs["nvcsw"] = r1.ru_nvcsw - r0.ru_nvcsw


def _record(name: str, t0: int, t1: int, span_id: int, parent,
            attrs: dict) -> None:
    _ring.append((name, t0, t1, span_id, parent, threading.get_ident(),
                  next(_seqs)) + tuple(itertools.chain.from_iterable(
                      attrs.items())))


class _Open:
    """A span while it is open (tracing on).  ``leaf`` holds until a
    span opens inside it."""

    __slots__ = ("name", "attrs", "id", "parent", "t0", "r0", "leaf")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        if stack:
            stack[-1].leaf = False
            self.parent = stack[-1].id
        else:
            self.parent = None
        self.id = next(_ids)
        self.leaf = True
        stack.append(self)
        self.r0 = _rusage()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        wall = t1 - self.t0
        if self.leaf:
            _stalls(self.attrs, wall, self.r0, _rusage())
        _record(self.name, self.t0, t1, self.id, self.parent, self.attrs)
        _log.debug("%s: %.2f ms", self.name, wall / 1e6)
        return False


class _Off:
    """The span of a switched-off tracer: does nothing."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def phase(name: str, **attrs):
    """A span around a block: ``with phase("batch.submit", rows=n) as sp:``.

    While tracing is on it is recorded (``spans()``) and logs
    ``<name>: <ms> ms`` at DEBUG on the trace logger when it ends;
    ``sp.set(key=value)`` adds attributes from inside the block."""
    if not _log.isEnabledFor(_DEBUG):
        return _OFF
    return _Open(name, attrs)


def spans() -> list[Span]:
    """The recorded spans, oldest first by close (at most ``CAPACITY``;
    ``dropped()`` counts those the ring let go)."""
    return [Span(*r[:7], dict(zip(r[7::2], r[8::2])))
            for r in sorted(_ring, key=lambda r: r[6])]


def dropped() -> int:
    """Spans recorded since the last ``reset()`` that the ring dropped,
    the oldest first."""
    if not _ring:
        return 0
    return max(r[6] for r in _ring) + 1 - _seq_base - len(_ring)


def reset() -> None:
    """Drop every recorded span."""
    global _seq_base
    _ring.clear()
    _seq_base = next(_seqs) + 1


# -- the cyclic collector --------------------------------------------------

# (wall ns, traced, rusage, parent) of the running collection.
# Collections do not nest, and one runs at a time.
_gc_open: list = []


def _gc_hook(phase_: str, info: dict) -> None:
    """gc.callbacks: count each collection and its time; record a
    ``host.gc`` span under the triggering thread's open span while
    tracing is on.  It takes no lock and logs nothing: it runs inside
    whatever code allocated, which may hold any lock.  Only this hook
    writes the gc keys, and collections never overlap."""
    if phase_ == "start":
        if _enabled():
            stack = _stack()
            r0 = _rusage()
            _gc_open.append((time.perf_counter_ns(), True, r0,
                             stack[-1].id if stack else None))
        else:
            _gc_open.append((time.perf_counter_ns(), False, None, None))
        return
    if not _gc_open:
        return
    t0, traced, r0, parent = _gc_open.pop()
    t1 = time.perf_counter_ns()
    gen = info.get("generation", 0)
    key = GC_COUNTERS[gen] if 0 <= gen < 3 else "gc.gen2"
    COUNTERS[key] = COUNTERS.get(key, 0) + 1
    COUNTERS["gc.us"] = COUNTERS.get("gc.us", 0) + (t1 - t0) // 1000
    if traced:
        attrs = {"generation": gen, "collected": info.get("collected", 0)}
        _stalls(attrs, t1 - t0, r0, _rusage())
        _record("host.gc", t0, t1, next(_ids), parent, attrs)


def _install_gc_hook() -> None:
    # One hook per process, also when this module is loaded again.
    gc.callbacks[:] = [cb for cb in gc.callbacks
                       if getattr(cb, "__qualname__", "") != "_gc_hook"
                       or getattr(cb, "__module__", "") != __name__]
    gc.callbacks.append(_gc_hook)


_install_gc_hook()


# -- the collector hold ----------------------------------------------------

# The hold's state, under _HOLD_LOCK: threads holding it; the ticket of
# its start, or of the last collection a release ran; whether it turned
# automatic collection off (a collector the application turned off is
# left off).  Tickets order the holds' starts.
_HOLD_LOCK = threading.Lock()
_holders = 0
_hold_since = 0
_hold_owned = False
_tickets = itertools.count(1)


class collector_hold:
    """Hold CPython's automatic cyclic collection off for the span of a
    search call: ``with collector_hold(): ...``.

    A call's objects then die by reference counting when it lets them
    go, unwalked and unpromoted, so they no longer trigger the
    generation-2 sweeps of the whole heap that paced the host path.  The
    hold is process-wide: the first holder turns automatic collection
    off if it was on, and the last turns it back on only then.  A hold
    inside another on the same thread is part of the outer one.

    Overlapping calls on several threads could keep the hold for good,
    so a release that finds the hold older than its own call (calls
    overlapped for a whole call) runs the young collection that the
    automatic collector would have run by then (generation 1 where its
    count is due, else 0) and restarts the hold's clock: no collection
    is held off longer than one call of the thread that holds it
    longest.  Counters: ``gc.hold`` (calls under the hold) and
    ``gc.hold_collect`` (collections such releases ran; the collector
    hook counts and times them as any other)."""

    __slots__ = ("ticket",)

    def __enter__(self):
        global _holders, _hold_since, _hold_owned
        depth = getattr(_local, "hold", 0)
        _local.hold = depth + 1
        if depth:
            self.ticket = None
            return self
        with _HOLD_LOCK:
            self.ticket = next(_tickets)
            if not _holders:
                _hold_since = self.ticket
                _hold_owned = gc.isenabled()
                if _hold_owned:
                    gc.disable()
            _holders += 1
        count("gc.hold")
        return self

    def __exit__(self, *exc):
        global _holders, _hold_since
        _local.hold -= 1
        if self.ticket is None:
            return False
        collect = False
        with _HOLD_LOCK:
            _holders -= 1
            if not _holders:
                if _hold_owned:
                    gc.enable()
            elif _hold_owned and _hold_since < self.ticket:
                _hold_since = next(_tickets)
                collect = True
        if collect:
            due = gc.get_count()[1] > gc.get_threshold()[1]
            gc.collect(1 if due else 0)
            count("gc.hold_collect")
        return False


# -- torch.profiler --------------------------------------------------------

@contextlib.contextmanager
def profiler_trace(logdir: str | None = None):
    """Capture a torch profiler trace (host and, with a card, CUDA
    activity) around the block.

    ``logdir`` defaults to $NXS_PROFILE_DIR; when neither is set the
    block runs untraced.
    """
    logdir = logdir or os.environ.get("NXS_PROFILE_DIR")
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     logdir)):
        yield
