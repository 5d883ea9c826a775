#!/usr/bin/env python3
"""Variants of the segsum kernel, timed in turns on one card.

A variant is csrc/segsum.cu with some ``constexpr int NAME = value;``
lines changed (the CTA size kThreads, the persistent grid's kCtasPerSm,
the rows of a tile kTileRows, the bounds pairs a thread fetches
kPairsPerThread, the postings a thread loads for a sparse tile's list
kListPerThread, and the terms of one posting round kTermRegs), ``base``
for the source as it is, or ``@PATH`` for a whole other source with the same C entry point
(another commit's csrc/segsum.cu).  Each is built with the kernels' nvcc flags plus
-Xptxas -v (registers, shared memory and spills) into a temporary
library, held bit for bit to the plain twin, and timed with
chip_smoke.py's CUDA-event harness, the variants in turns (in order,
then in reverse), on chip_smoke.py's three synthetic launches
(SEGSUM_CASES, made on the card from one seed): the 1M tier's 64 rows
of 1,048,576 slots, the north-star tier's 7 rows of 9,437,184 slots,
and the heavy case; and the tier's launch with every range empty
("empty": stores alone).  Beside each time: the launch's bound
(chip_smoke.segsum_bound), torch.zeros of the same output bytes (the
store floor) and a fill of them with ones (a store kernel that cannot
be a memset).  Prints the card line, one JSON line per shape
(postings, occupied blocks, bound, store floor) and one per variant.

With ``--tier-seeds K`` it times the variants in turns on K draws of the
north-star tier's launch instead (segsum_synthetic("tier") with seeds
45, 46, ...: as many launches as the tier's 512 blockdense rows make
when K is 74), each held bit for bit to the twin, and prints one JSON
line per seed (postings, occupied blocks, bound, each variant's ms and
ratio) and one per variant with the spread (least, median, most) of its
ms and ratio over the seeds.

Usage (needs a CUDA card):
    python3 tools/segsum_variants.py base kCtasPerSm=6 kCtasPerSm=8
    python3 tools/segsum_variants.py base kThreads=128,kCtasPerSm=8
    python3 tools/segsum_variants.py base @OTHER/csrc/segsum.cu
    python3 tools/segsum_variants.py --tier-seeds 74 base @OTHER/csrc/segsum.cu
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (ROOT, os.path.join(ROOT, "tools")):
    if path not in sys.path:
        sys.path.insert(0, path)

import chip_smoke as smoke  # noqa: E402
from myers_variants import apply_changes, parse_variant  # noqa: E402

SOURCE = "segsum.cu"
SYMBOL = "nxs_segsum_blockdense"
SHAPES = ("1m", "tier", "heavy", "empty")


def variant_source(spec: str) -> tuple[str, str]:
    """(label, source text) of a variant spec: ``base``, ``@PATH`` or
    ``NAME=INT[,NAME=INT]`` applied to csrc/segsum.cu."""
    from nxsearch_tpu_torch.ops import kernels

    if spec.startswith("@"):
        with open(spec[1:]) as f:
            return spec, f.read()
    with open(os.path.join(kernels.CSRC_DIR, SOURCE)) as f:
        text = f.read()
    if spec == "base":
        return spec, text
    return spec, apply_changes(text, parse_variant(spec), SOURCE)


def build(workdir: str, text: str):
    """(library path, ptxas usage) of ``text`` as csrc/segsum.cu (beside
    the other sources and headers), built in ``workdir``."""
    from nxsearch_tpu_torch.ops import kernels

    src_dir = os.path.join(workdir, "csrc")
    shutil.copytree(kernels.CSRC_DIR, src_dir)
    path = os.path.join(src_dir, SOURCE)
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(workdir, "variant.so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", lib, path], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return lib, smoke.parse_ptxas(proc.stdout + proc.stderr)


def launcher(lib: str):
    """A function of blockdense_scores' inputs -> (scores, bits) that
    launches the library's entry point (BM25, presence bits) on the
    current stream."""
    import torch

    from nxsearch_tpu_torch.ops import kernels

    fn = getattr(ctypes.CDLL(lib), SYMBOL)
    fn.argtypes = kernels.SEGSUM.argtypes
    fn.restype = ctypes.c_int

    def run(ps, pf, dl, alive, bounds, coef):
        n, q = bounds.shape[0], bounds.shape[1]
        scores = torch.empty((n, dl.shape[0]), dtype=torch.float32,
                             device=dl.device)
        bits = torch.empty((n, dl.shape[0]), dtype=torch.int32,
                           device=dl.device)
        rc = fn(ps.data_ptr(), pf.data_ptr(), dl.data_ptr(),
                alive.data_ptr(), bounds.data_ptr(), coef.data_ptr(),
                scores.data_ptr(), bits.data_ptr(), n, q,
                dl.shape[0] // kernels.BLOCK_SLOTS, 0, 1,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{SYMBOL}: CUDA launch failed ({rc})")
        return scores, bits
    return run


def shape_facts(args) -> dict:
    """The launch's postings, occupied blocks, bound and store floor."""
    import torch

    bounds, n_slots = args[4], args[2].shape[0]
    n_out = 2 * bounds.shape[0] * n_slots
    floor = smoke.cuda_time_ms(
        lambda: torch.zeros(n_out, dtype=torch.float32,
                            device=bounds.device), 21, smoke.KERNEL_REPS)
    ones = torch.empty(n_out, dtype=torch.float32, device=bounds.device)
    fill = smoke.cuda_time_ms(lambda: ones.fill_(1.0), 21,
                              smoke.KERNEL_REPS)
    return {"N": bounds.shape[0], "Q": bounds.shape[1], "S": n_slots,
            **smoke.segsum_bound(bounds, n_slots), "store_floor_ms": floor,
            "fill_ones_ms": fill}


def check(label: str, run, args, want, where: str) -> None:
    """Raise unless ``run(*args)`` equals the twin's ``want`` bit for
    bit."""
    import torch

    got_s, got_b = run(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got_s, want[0]) and torch.equal(got_b, want[1])):
        raise AssertionError(f"{label} differs from the twin on {where}")


def spread(values: list[float]) -> dict:
    return {"min": min(values), "median": smoke.median(values),
            "max": max(values)}


def seed_sweep(variants, runs, n_seeds: int, seed0: int = 45,
               device: str = "cuda") -> None:
    """The variants in turns on ``n_seeds`` draws of the tier's launch:
    one JSON line per seed, then one per variant with its spread."""
    from nxsearch_tpu_torch.ops import kernels

    order = list(range(len(variants)))
    ms_all = [[] for _ in variants]
    ratio_all = [[] for _ in variants]
    print(smoke.card_line())
    for seed in range(seed0, seed0 + n_seeds):
        args, _ = smoke.segsum_synthetic("tier", seed=seed, device=device)
        want = kernels.blockdense_scores_ref(*args, algo=0, use_mask=True)
        for (label, _), run in zip(variants, runs):
            check(label, run, args, want, f"tier seed {seed}")
        del want
        times = [[] for _ in variants]
        for n in order + order[::-1]:
            times[n] += smoke.cuda_times(
                lambda run=runs[n]: run(*args), 5, smoke.KERNEL_REPS)
        facts = smoke.segsum_bound(args[4], args[2].shape[0])
        ms = [smoke.median(t) for t in times]
        for n in order:
            ms_all[n].append(ms[n])
            ratio_all[n].append(facts["bound_ms"] / ms[n])
        print(json.dumps({
            "shape": "tier", "seed": seed, **facts,
            "ms": {label: m for (label, _), m in zip(variants, ms)},
            "ratio": {label: facts["bound_ms"] / m
                      for (label, _), m in zip(variants, ms)}}), flush=True)
    for n, (label, _) in enumerate(variants):
        print(json.dumps({"kernel": "segsum", "variant": label,
                          "seeds": n_seeds, "ms": spread(ms_all[n]),
                          "ratio": spread(ratio_all[n])}))


def main(argv: list[str]) -> int:
    import torch

    from nxsearch_tpu_torch.ops import kernels

    n_seeds = 0
    if argv[:1] == ["--tier-seeds"] and len(argv) > 1:
        n_seeds, argv = int(argv[1]), argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("segsum_variants: no CUDA device", file=sys.stderr)
        return 1
    variants = [variant_source(spec) for spec in argv]
    if n_seeds:
        with tempfile.TemporaryDirectory() as tmp:
            runs = [launcher(build(os.path.join(tmp, str(n)), text)[0])
                    for n, (_label, text) in enumerate(variants)]
            seed_sweep(variants, runs, n_seeds)
        return 0
    shapes = {name: smoke.segsum_synthetic(name)[0] for name in SHAPES[:3]}
    empty = list(shapes["tier"])
    empty[4] = torch.zeros_like(empty[4])
    shapes["empty"] = tuple(empty)
    with tempfile.TemporaryDirectory() as tmp:
        runs, usage = [], []
        for n, (_label, text) in enumerate(variants):
            lib, ptxas = build(os.path.join(tmp, str(n)), text)
            runs.append(launcher(lib))
            usage.append(ptxas)
        facts = {}
        for shape, args in shapes.items():
            want = kernels.blockdense_scores_ref(*args, algo=0,
                                                 use_mask=True)
            for (label, _), run in zip(variants, runs):
                check(label, run, args, want, shape)
            del want
            facts[shape] = shape_facts(args)
        times = [{shape: [] for shape in shapes} for _ in variants]
        order = list(range(len(variants)))
        for n in order + order[::-1]:
            for shape, args in shapes.items():
                times[n][shape] += smoke.cuda_times(
                    lambda run=runs[n], args=args: run(*args), 11,
                    smoke.KERNEL_REPS)
    print(smoke.card_line())
    for shape, f in facts.items():
        print(json.dumps({"shape": shape, **f}))
    for (label, _), ptxas, t in zip(variants, usage, times):
        ms = {s: smoke.median(v) for s, v in t.items()}
        print(json.dumps({
            "kernel": "segsum", "variant": label, "ptxas": ptxas, "ms": ms,
            "ratio": {s: facts[s]["bound_ms"] / ms[s] for s in ms}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
