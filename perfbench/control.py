#!/usr/bin/env python3
"""The control of the check: the plain reference in bfloat16 in the
engine's place.

    python3 perfbench/control.py --workload <name> --seed <n> [--seed ...]

The configuration states float32 scores; the control computes the
reference's BM25 (reference.py) in bfloat16, the nearest precision
below, on the cell's own corpus and on as many of its queries as a run
checks, drawn the same way, and holds its answers to the float64
reference by the run's own comparison.  It has to come out not
correct: each seed prints the numbers compared beside their limits.
It needs no engine: run it on the card at the cell's size, and the
CPU test runs it at a small one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from perfbench import corpus as corpus_mod  # noqa: E402
from perfbench import traffic as traffic_mod  # noqa: E402
from perfbench.reference import Reference, compare  # noqa: E402
from perfbench.run import Reservoir  # noqa: E402


def control(name: str, seed: int, device, root: str = ROOT,
            seconds: int = 10) -> dict:
    """The bfloat16 reference against the float64 one on ``seed``'s
    corpus and a run's worth of checked queries."""
    import torch

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    with open(os.path.join(root, "perfbench", "configs",
                           f"{cell['config']}.json")) as f:
        cfg = json.load(f)
    tp = traffic_mod.load(cell["traffic"], os.path.join(root, "perfbench"))
    corpus = corpus_mod.make_corpus(cfg, seed, device)
    bsz = int(tp["batch"])
    n_batches = math.ceil(tp["prefetch_qps"] * seconds / bsz)
    tr = traffic_mod.make_traffic(cell["traffic"], tp, cfg, corpus.strings,
                                  seed, n_batches)
    # As many answers as a run checks, drawn as a run draws them.
    rng = np.random.default_rng(corpus_mod.derive(seed, "check"))
    keep_all = Reservoir(int(tp["check_sample"]), rng)
    keep_typo = Reservoir(int(tp["check_typos"]), rng)
    for b in range(n_batches):
        pool = list(range(b * bsz, (b + 1) * bsz))
        keep_all.offer(pool)
        keep_typo.offer([i for i, t in zip(pool, tr.typos_of(b)) if t >= 0])
    pick = set(keep_all.items) | set(keep_typo.items)
    f64 = Reference(corpus, device)
    low = Reference(corpus, device, dtype=torch.bfloat16)
    misses, gap = 0, 0.0
    limit = int(tp["limit"])
    for i in sorted(pick):
        q = tr.query(i)
        got, _ = low.answer(q, limit)
        want, acc = f64.answer(q, limit)
        m, g = compare(got, want, acc, cfg["score_tol"])
        misses += m
        gap = max(gap, g)
    correct = misses <= 0 and gap <= cfg["score_tol"]
    return {"workload": name, "seed": seed, "correct": bool(correct),
            "answers_checked": len(pick),
            "rank_misses": {"value": misses, "limit": 0},
            "score_gap": {"value": gap, "limit": cfg["score_tol"]}}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seed:
        out = control(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
