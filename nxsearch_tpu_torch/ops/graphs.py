"""CUDA graphs of fixed-shape launch chains, one per dispatch signature.

An R = 0 impact-prefix dispatch group (ops/executor.prefix_topk_packed)
is a chain of 100-200 small device operations (window gather, BM25,
stable slot sort, shifted run sums, stable top-k, packing) whose shapes
and constants follow from its signature alone, with no host
synchronisation inside.  The planner keeps those signatures on fixed
ladders, so a few dozen of them recur batch after batch.  A
``GraphCache`` runs a signature eagerly the first time it sees it (that
run also does the sort kernels' lazy set-up, which a capture must not
contain), captures the chain as one CUDA graph the second time, and
from then on replaces its launches by three steps: one asynchronous
copy of the packed host plan from pinned staging into the graph's
static input, one replay, and one device copy of the static output into
a fresh tensor, so that two chunks of one signature in one batch keep
their own results.

A graph reads the addresses of the snapshot tensors it was captured
against, so a cache belongs to one snapshot: ``DeviceIndex.refresh``
installs a new cache with every generation, and a cache handed other
snapshot tensors than it captured against drops its graphs.

The graphs of a cache share one memory pool.  That is safe because
replays are serialised by the cache's lock on the device's current
stream (the stream every dispatch of the engine is issued on) and each
output is copied out at once.  The lock also makes the copy-in /
replay / copy-out triple and every capture safe for concurrent request
threads.  Captures run on a side stream with ``capture_begin`` /
``capture_end`` (``torch.cuda.graph`` would run a full ``gc.collect()``
and ``empty_cache()`` at each capture), in thread-local capture mode,
so other threads' device calls may go on meanwhile.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

# Graphs a cache keeps, the least recently used evicted first (a cell's
# traffic shows 18-26 prefix signatures).
LIMIT = 64


class CapturedChain:
    """``fn`` captured as a CUDA graph over an ``n``-word int32 static
    input; ``pool`` is a live graph's pool to share, or None.  (The
    CPU tests put a stand-in here.)"""

    def __init__(self, device: torch.device, n: int, fn, pool):
        self.device = device
        with torch.cuda.device(device):
            self.static_in = torch.empty(n, dtype=torch.int32,
                                         device=device)
            self.graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self.graph.capture_begin(pool=pool,
                                         capture_error_mode="thread_local")
                try:
                    self.static_out = fn(self.static_in)
                finally:
                    self.graph.capture_end()
        self.pool = self.graph.pool()

    def replay(self, host_in: np.ndarray) -> torch.Tensor:
        stage = torch.empty(host_in.shape, dtype=torch.int32,
                            pin_memory=True)
        stage.numpy()[...] = host_in
        with torch.cuda.device(self.device):
            self.static_in.copy_(stage, non_blocking=True)
            self.graph.replay()
            return self.static_out.clone()


class GraphCache:
    """The captured chains of one snapshot, by signature (see the
    module note)."""

    def __init__(self, device: torch.device, limit: int = LIMIT):
        self.device = torch.device(device)
        self.limit = limit
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.seen: set = set()
        self._snapshot: tuple = ()
        self._lock = threading.Lock()

    def run(self, key, snapshot: tuple, host_in: np.ndarray,
            fn) -> tuple[torch.Tensor, str]:
        """``fn(device_input)`` for the int32 ``host_in``; returns the
        result and how it ran: ``"eager"``, ``"capture"`` or
        ``"replay"``.  ``key`` fixes every shape and constant of
        ``fn``'s chain, ``snapshot`` holds the device tensors it
        reads."""
        with self._lock:
            if (len(snapshot) != len(self._snapshot)
                    or any(a is not b
                           for a, b in zip(snapshot, self._snapshot))):
                self.graphs.clear()
                self.seen.clear()
                self._snapshot = snapshot
            chain = self.graphs.get(key)
            if chain is not None:
                self.graphs.move_to_end(key)
                return chain.replay(host_in), "replay"
            if key in self.seen:
                # Share the pool of a live graph: a pool no graph holds
                # any longer may not be named again.
                pool = next(iter(self.graphs.values())).pool \
                    if self.graphs else None
                chain = CapturedChain(self.device, len(host_in), fn, pool)
                self.graphs[key] = chain
                if len(self.graphs) > self.limit:
                    self.graphs.popitem(last=False)
                return chain.replay(host_in), "capture"
            self.seen.add(key)
        return fn(torch.from_numpy(host_in).to(self.device)), "eager"
