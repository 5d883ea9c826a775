#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path, on one card.

Ingests chip_smoke.py's workload (bench.py's 1M tier) on the card and
reports, on stderr and as one JSON line on stdout:

- the host phases of search_pipelined, per 2048-query batch, from the
  package's own ``phase`` spans (utils/trace.py): prep.* (parse,
  resolve, fuzzy), batch.plan, pipeline.submit (plan and batch.submit
  included) and pipeline.collect (batch.collect: batch.fetch, the
  device wait and result copy, and batch.respond);
- one search_pipelined pass and one fuzzy search_many under
  torch.profiler: wall time, the union of device kernel intervals (the
  device's busy share of the pass; the profiler slows the host, so the
  share is also given against the same call's unprofiled wall time),
  the ops with the most device self time, and the Myers and segsum
  kernels' time and launches;
- the same for boolean traffic: the mixed trace (chip_smoke.py's
  mixed phase: masked sliced and masked-hybrid rows) through
  search_pipelined, with its host phases per batch, and the blockdense
  route (chip_smoke.py's blockdense queries with the masked hybrid
  off: segsum kernel, program evaluation, top-k over every slot);
- peak device memory.

Usage: python3 tools/profile_port.py   (needs a CUDA card)
"""

from __future__ import annotations

import json
import logging
import os
import sys
import tempfile
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402


class _Spans(logging.Handler):
    """Sums the milliseconds of every ``phase`` span by name."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.ms = defaultdict(float)

    def emit(self, record):
        if isinstance(record.args, tuple) and len(record.args) == 2:
            name, ms = record.args
            self.ms[name] += ms


def host_phases(idx, batches, sp) -> dict:
    """Per-batch milliseconds of each phase span over one pass."""
    log = logging.getLogger("nxsearch_tpu.trace")
    spans = _Spans()
    level, propagate = log.level, log.propagate
    log.addHandler(spans)
    log.setLevel(logging.DEBUG)
    log.propagate = False
    try:
        idx.search_pipelined(batches, sp)
    finally:
        log.removeHandler(spans)
        log.setLevel(level)
        log.propagate = propagate
    return {k: v / len(batches) for k, v in sorted(spans.ms.items())}


def profiled(fn) -> dict:
    """Wall ms, device busy ms (union of kernel intervals), the top ops
    by device self time and the Myers kernel's time, for one call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    myers = [e.time_range.elapsed_us() for e in kernels if "myers" in e.name]
    segsum = [e.time_range.elapsed_us() for e in kernels
              if "segsum" in e.name]
    # key_averages() lists each kernel a second time as its own entry:
    # keep the host ops (their self device time covers their kernels).
    ops = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0 and evt.device_type == DeviceType.CPU:
            ops.append((us / 1e3, evt.key, evt.count))
    ops.sort(reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / wall_ms,
            "kernels": len(spans),
            "myers_ms": sum(myers) / 1e3, "myers_launches": len(myers),
            "segsum_ms": sum(segsum) / 1e3, "segsum_launches": len(segsum),
            "top_ops_ms": [[k, round(ms, 4), n] for ms, k, n in ops[:10]]}


def unprofiled(fn) -> float:
    """Wall ms of one call without the profiler."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    import numpy as np
    import torch

    import bench
    from nxsearch_tpu_torch import Params
    from nxsearch_tpu_torch import search as search_mod

    if not torch.cuda.is_available():
        smoke.log("profile_port: no CUDA device")
        return 1
    card = smoke.card_line()
    smoke.log(f"card: {card}")
    sp = Params().set_uint("limit", 10)
    with tempfile.TemporaryDirectory() as workdir:
        nxs, idx, ingest_s = smoke.ingest(workdir)
        idx.search("w00001", sp)                 # builds the snapshot
        snapshot_gib = torch.cuda.memory_allocated() / 2**30
        _queries, batches, fuzzy = smoke.workload()
        idx.search_pipelined(batches, sp)        # warm-up
        idx.search_many(fuzzy[0], sp)
        torch.cuda.reset_peak_memory_stats()
        phases = [host_phases(idx, batches, sp) for _ in range(2)]
        plain = [unprofiled(lambda: idx.search_pipelined(batches, sp))
                 for _ in range(2)]
        search = [profiled(lambda: idx.search_pipelined(batches, sp))
                  for _ in range(2)]
        fz = [profiled(lambda s=s: idx.search_many(s, sp))
              for s in fuzzy[1:3]]
        fz_plain = unprofiled(lambda: idx.search_many(fuzzy[3], sp))

        words, probs = smoke.vocab()
        mq = bench.make_mixed_queries(smoke.N_MIXED, words, probs,
                                      np.random.default_rng(43))
        mb = [mq[i: i + smoke.BATCH]
              for i in range(0, smoke.N_MIXED, smoke.BATCH)]
        idx.search_pipelined(mb, sp)             # warm-up
        mixed_phases = [host_phases(idx, mb, sp) for _ in range(2)]
        mixed_plain = min(unprofiled(lambda: idx.search_pipelined(mb, sp))
                          for _ in range(2))
        mixed = [profiled(lambda: idx.search_pipelined(mb, sp))
                 for _ in range(2)]

        bdq = smoke.bd_queries(idx)
        search_mod._MASKED_HYBRID = False
        try:
            idx.search_many(bdq[:64], sp)        # warm-up
            bd_plain = unprofiled(lambda: idx.search_many(bdq, sp))
            bd = [profiled(lambda: idx.search_many(bdq, sp))
                  for _ in range(2)]
        finally:
            search_mod._MASKED_HYBRID = True
        for runs, wall in ((search, min(plain)), (fz, fz_plain),
                           (mixed, mixed_plain), (bd, bd_plain)):
            for r in runs:
                r["unprofiled_wall_ms"] = wall
                r["busy_share_unprofiled"] = r["device_busy_ms"] / wall
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        nxs.close()
    out = {"card": card, "ingest_s": ingest_s,
           "snapshot_gib": snapshot_gib, "peak_gib": peak_gib,
           "batch": smoke.BATCH, "phases_ms_per_batch": phases,
           "search_pipelined": search, "fuzzy_search_many": fz,
           "mixed_phases_ms_per_batch": mixed_phases,
           "mixed_search_pipelined": mixed, "blockdense_search_many": bd}
    for name, runs in (("search_pipelined", search), ("fuzzy", fz),
                       ("mixed", mixed), ("blockdense", bd)):
        for r in runs:
            smoke.log(f"{name}: wall {r['wall_ms']:.1f} ms, device busy "
                      f"{r['device_busy_ms']:.1f} ms "
                      f"({r['busy_share']:.3f}; "
                      f"{r['busy_share_unprofiled']:.3f} of the unprofiled "
                      f"{r['unprofiled_wall_ms']:.1f} ms), "
                      f"{r['kernels']} kernels, "
                      f"myers {r['myers_ms']:.3f} ms in "
                      f"{r['myers_launches']} launches, segsum "
                      f"{r['segsum_ms']:.3f} ms in "
                      f"{r['segsum_launches']} launches")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
