"""What a traced run reads: the engine's phase spans and the device trace.

Spans.  The engine logs each ``utils.trace.phase`` as a DEBUG line
``<name>: <ms> ms`` on the ``nxsearch_tpu.trace`` logger when the phase
ends.  ``SpanLog`` is a logging handler that turns each line into a
span (name, start, end) on the host's ``perf_counter`` clock: the end is
the moment of the line, the start that less the duration.  The harness
adds spans of its own around its calls into the engine.

Device.  ``DeviceTrace`` runs ``torch.profiler`` with CUDA activity
over the window and keeps each device operation (kernel, copy, set) as
(name, start, end) on the host clock.  The clocks are tied by a marker:
after a synchronise, the host notes the time and launches one short
sleep kernel, whose device start is that time.  The busy share is the
union of the operations' intervals over the window (as
tools/profile_port.py takes it); an idle gap is a stretch of the
window between them, labelled by the innermost span that covers its
middle, or ``host.other`` where none does.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict

TRACE_LOGGER = "nxsearch_tpu.trace"


class SpanLog(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.spans: list = []          # (name, start, end), host clock
        self._logger = None

    def emit(self, record):
        end = time.perf_counter()
        args = record.args
        if (isinstance(args, tuple) and len(args) == 2
                and isinstance(args[0], str)):
            self.spans.append((args[0], end - args[1] / 1e3, end))

    def add(self, name: str, start: float, end: float) -> None:
        self.spans.append((name, start, end))

    def __enter__(self):
        log = logging.getLogger(TRACE_LOGGER)
        self._saved = (log.level, log.propagate)
        log.addHandler(self)
        log.setLevel(logging.DEBUG)
        log.propagate = False
        self._logger = log
        return self

    def __exit__(self, *exc):
        log = self._logger
        log.removeHandler(self)
        log.setLevel(self._saved[0])
        log.propagate = self._saved[1]
        return False

    def total(self, names, t0: float, t1: float) -> float:
        """Seconds of the named spans that end inside [t0, t1]."""
        return sum(e - s for n, s, e in self.spans
                   if n in names and t0 <= e <= t1)


def _events(prof):
    """(name, start_us, end_us) of every device operation."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "cuda" not in str(e.device_type()).lower():
            continue
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            s, d = e.start_us(), e.duration_us()
        out.append((e.name(), s, s + d))
    return out


class DeviceTrace:
    """torch.profiler over the window, device operations only."""

    def __init__(self, device):
        self.device = device
        self.ops: list = []            # (name, start_s, end_s), host clock

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._t_mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)
        evs = sorted(_events(self._prof), key=lambda e: e[1])
        if not evs:
            return False
        # The marker: the first sleep kernel, else the first operation.
        mark = next((e for e in evs[:8] if "spin" in e[0].lower()), evs[0])
        off = self._t_mark - mark[1] / 1e6
        self.ops = [(ev[0], ev[1] / 1e6 + off, ev[2] / 1e6 + off)
                    for ev in evs if ev is not mark]
        return False

    def busy(self, t0: float, t1: float):
        """(busy seconds, merged intervals) inside [t0, t1]."""
        ivs = sorted((max(s, t0), min(e, t1)) for _, s, e in self.ops
                     if e > t0 and s < t1)
        merged = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        return sum(e - s for s, e in merged), merged

    def top_ops(self, t0: float, t1: float, n: int = 10):
        by = defaultdict(float)
        for name, s, e in self.ops:
            if e > t0 and s < t1:
                by[name[:64]] += min(e, t1) - max(s, t0)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, merged, spans, t0: float, t1: float, n: int = 10):
        edges = [t0] + [x for iv in merged for x in iv] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            cover = [(se - ss, name) for name, ss, se in spans
                     if ss <= mid <= se]
            out.append([min(cover)[1] if cover else "host.other", e - s])
        return out
