#!/usr/bin/env python3
"""Variants of the transposed and single-query Myers kernels, timed in
turns on one card.

A variant is csrc/myers_rev.cu ("rev") or csrc/myers.cu ("one") with
some ``constexpr int NAME = value;`` lines changed.  Each is built with
the kernels' nvcc flags plus -Xptxas -v (registers, shared memory and
spills per kernel) into a temporary library, held exactly to its plain
twin, and timed with chip_smoke.py's CUDA-event harness on
chip_smoke.py's inputs, the variants in turns (in order, then in
reverse): "rev" on the band, the random and the full-byte-range rows
at M = 64, on the band's first 25,600 terms at M = 64 (100 blocks of
256 terms: under one block per SM, so latency is not hidden by other
warps) and on the band at M = 1; "one" on the band at M = 1.
Prints the card line, then one JSON line per variant.

Usage (needs a CUDA card):
    python3 tools/myers_variants.py rev kBlocksPerSm=5 kBlocksPerSm=6
    python3 tools/myers_variants.py one kOneBlocksPerSm=6 kOneBlocksPerSm=8
A variant of several changes joins them with commas:
    python3 tools/myers_variants.py one kOneThreads=512,kOneBlocksPerSm=3
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

# kernel -> (source, C entry point, whether the entry takes M)
ENTRIES = {"rev": ("myers_rev.cu", "nxs_myers_rev_distances", True),
           "one": ("myers.cu", "nxs_myers_distances_one", False)}


def parse_variant(spec: str) -> dict:
    """"kOneThreads=512,kOneBlocksPerSm=3" -> {"kOneThreads": "512",
    "kOneBlocksPerSm": "3"}."""
    out = {}
    for part in spec.split(","):
        name, _, value = part.partition("=")
        if not re.fullmatch(r"k\w+", name) or not re.fullmatch(r"\d+", value):
            raise SystemExit(f"bad variant {spec!r}: NAME=INT[,NAME=INT]")
        out[name] = value
    return out


def apply_changes(text: str, changes: dict, source: str) -> str:
    """``text`` with each ``constexpr int NAME = ...;`` of ``changes``
    set to its value; exits if a name is not declared exactly once."""
    for name, value in changes.items():
        text, n = re.subn(rf"(constexpr int {name} = )[^;]+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise SystemExit(f"{source}: no single 'constexpr int {name}'")
    return text


def build(workdir: str, source: str, changes: dict):
    """(library path, ptxas usage) of csrc/``source`` with ``changes``
    applied to its ``constexpr int`` lines, built in ``workdir``."""
    from nxsearch_tpu_torch.ops import kernels

    src_dir = os.path.join(workdir, "csrc")
    shutil.copytree(kernels.CSRC_DIR, src_dir)
    path = os.path.join(src_dir, source)
    with open(path) as f:
        text = apply_changes(f.read(), changes, source)
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(workdir, "variant.so")
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", lib, path], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {changes}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return lib, smoke.parse_ptxas(proc.stdout + proc.stderr)


def launcher(lib: str, symbol: str, takes_m: bool):
    """A function (vb, vl, qb, ql) -> int32[M, W] that launches the
    library's entry point on the current stream."""
    import torch

    fn = getattr(ctypes.CDLL(lib), symbol)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 5 + [i] * (2 if takes_m else 1) + [p]
    fn.restype = ctypes.c_int

    def run(vb, vl, qb, ql):
        out = torch.empty((qb.shape[0], vb.shape[0]), dtype=torch.int32,
                          device=vb.device)
        m = (qb.shape[0],) if takes_m else ()
        rc = fn(vb.data_ptr(), vl.data_ptr(), qb.data_ptr(), ql.data_ptr(),
                out.data_ptr(), vb.shape[0], *m,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{symbol}: CUDA launch failed ({rc})")
        return out
    return run


def main(argv: list[str]) -> int:
    import torch

    from nxsearch_tpu_torch.ops import kernels

    if len(argv) < 2 or argv[0] not in ENTRIES:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("myers_variants: no CUDA device", file=sys.stderr)
        return 1
    which = argv[0]
    source, symbol, takes_m = ENTRIES[which]
    variants = [parse_variant(spec) for spec in argv[1:]]
    sets = smoke.myers_inputs()
    vb, vl, qb, ql = sets["band"]
    band_m1 = (vb, vl, qb[:1], ql[:1])
    if which == "rev":
        shapes = {"band": sets["band"], "random": sets["random"],
                  "full": sets["full"],
                  "band_small": (vb[:25_600], vl[:25_600], qb, ql),
                  "band_m1": band_m1}
        twin = kernels.myers_rev_distances_ref
    else:
        shapes = {"band_m1": band_m1}

        def twin(vb, vl, qb, ql):
            return kernels.myers_distances_one_ref(vb, vl, qb[0], ql[0])[None]
    with tempfile.TemporaryDirectory() as tmp:
        runs, usage = [], []
        for n, changes in enumerate(variants):
            lib, ptxas = build(os.path.join(tmp, str(n)), source, changes)
            runs.append(launcher(lib, symbol, takes_m))
            usage.append(ptxas)
        for shape, args in shapes.items():
            want = twin(*args)
            for changes, run in zip(variants, runs):
                got = run(*args)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{changes} differs from the twin "
                                         f"on {shape}")
        times = [{shape: [] for shape in shapes} for _ in variants]
        order = list(range(len(variants)))
        for n in order + order[::-1]:
            for shape, args in shapes.items():
                times[n][shape] += smoke.cuda_times(
                    lambda run=runs[n], args=args: run(*args), 11,
                    smoke.KERNEL_REPS)
    print(smoke.card_line())
    for changes, ptxas, t in zip(variants, usage, times):
        print(json.dumps({"kernel": which, "changes": changes,
                          "ptxas": ptxas,
                          "ms": {s: smoke.median(v) for s, v in t.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
