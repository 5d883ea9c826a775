#!/usr/bin/env python3
"""Where the time goes on the doc-sharded mesh, on one card.

Ingests chip_smoke.py's workload (bench.py's 1M tier) on the card, then
runs its pure-OR and mixed traces through search_pipelined on one
device and through a mesh of chip_smoke.MESH_SHARDS shards of the card
(chip_smoke.py's phase 14), in turns, and reports for each, on stderr
and as one JSON line on stdout: the host phases per 2048-query batch
(the package's ``phase`` spans), the unprofiled wall of a pass, and one
pass under torch.profiler (device busy share, kernels, top ops by
device self time) -- tools/profile_port.py's measurements.

Usage: python3 tools/profile_mesh.py   (needs a CUDA card)
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import profile_port as prof  # noqa: E402  (puts the repo on sys.path)

import chip_smoke as smoke  # noqa: E402


def measure(idx, batches, sp) -> dict:
    """Host phases per batch, the unprofiled wall and one profiled pass
    of search_pipelined over ``batches``."""
    idx.search_pipelined(batches, sp)                # warm-up
    out = {"phases_ms_per_batch": prof.host_phases(idx, batches, sp),
           "unprofiled_wall_ms": prof.unprofiled(
               lambda: idx.search_pipelined(batches, sp))}
    out.update(prof.profiled(lambda: idx.search_pipelined(batches, sp)))
    out["busy_share_unprofiled"] = (out["device_busy_ms"]
                                    / out["unprofiled_wall_ms"])
    return out


def main() -> int:
    import numpy as np
    import torch

    import bench
    from nxsearch_tpu_torch import Nxs, Params
    from nxsearch_tpu_torch.parallel import make_mesh

    if not torch.cuda.is_available():
        smoke.log("profile_mesh: no CUDA device")
        return 1
    card = smoke.card_line()
    smoke.log(f"card: {card}")
    sp = Params().set_uint("limit", 10)
    words, probs = smoke.vocab()
    _queries, batches, _fuzzy = smoke.workload()
    mixed = bench.make_mixed_queries(smoke.N_MIXED, words, probs,
                                     np.random.default_rng(43))
    traces = {"pure_or": batches,
              "mixed": [mixed[i: i + smoke.BATCH]
                        for i in range(0, smoke.N_MIXED, smoke.BATCH)]}
    out = {"card": card, "mesh_shards": smoke.MESH_SHARDS}
    with tempfile.TemporaryDirectory() as workdir:
        nxs, idx, _ingest_s = smoke.ingest(workdir)
        mesh_nxs = Nxs(workdir, mesh=make_mesh(
            [torch.device("cuda", 0)] * smoke.MESH_SHARDS))
        try:
            midx = mesh_nxs.index_open("bench")
            for name, trace in traces.items():
                for label, index in (("device", idx), ("mesh", midx),
                                     ("mesh_2", midx), ("device_2", idx)):
                    r = measure(index, trace, sp)
                    out[f"{name}_{label}"] = r
                    phases = {k: round(v, 2) for k, v in
                              r["phases_ms_per_batch"].items()}
                    smoke.log(
                        f"{name} on the {label} ({card}): wall "
                        f"{r['unprofiled_wall_ms']:.1f} ms unprofiled, "
                        f"device busy {r['device_busy_ms']:.1f} ms "
                        f"({r['busy_share_unprofiled']:.3f}), "
                        f"{r['kernels']} kernels; phases per batch "
                        f"{phases}; top ops {r['top_ops_ms'][:5]}")
        finally:
            mesh_nxs.close()
            nxs.close()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
