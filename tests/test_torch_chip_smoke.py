"""chip_smoke.py's host-side helpers that run without a card: the SASS
instruction count behind the Myers kernels' bound, and the bound; and
a rehearsal of the fallback-routes phase on the CPU at a small size."""

import pytest
import torch

import chip_smoke

SASS = """
\tcode for sm_90a
\t\tFunction : _Z5probeILi9EEvPKjPj
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/  LDC R1, c[0x0][0x28] ;  /* 0x00000a00ff017b82 */
                  /* 0x000fe20000000800 */
        /*0010*/  S2R R0, SR_TID.X ;  /* 0x0000000000007919 */
        /*0020*/  ULDC.64 UR4, c[0x0][0x208] ;  /* 0x0000820000047ab9 */
        /*0030*/  IMAD.WIDE.U32 R2, R0, 0x40, R2 ;  /* 0x0000004000027825 */
        /*0040*/  LDG.E R5, desc[UR4][R2.64] ;  /* 0x0000000402057981 */
        /*0050*/  LOP3.LUT R7, R5, R6, RZ, 0xc0, !PT ;  /* 0x000000060507 */
        /*0060*/  @!P0 IADD3 R7, R7, 0x1, RZ ;  /* 0x0000000107078810 */
        /*0070*/  LEA R8, R7, 0x1, 0x1 ;  /* 0x0000000107087811 */
        /*0080*/  STG.E desc[UR4][R2.64], R8 ;  /* 0x0000000802007986 */
        /*0090*/  EXIT ;  /* 0x000000000000794d */
        /*00a0*/  BRA 0xa0;  /* 0xfffffffc00fc7947 */
\t\t..........

\t\tFunction : _Z5probeILi1EEvPKjPj
        /*0000*/  LDC R1, c[0x0][0x28] ;  /* 0x00000a00ff017b82 */
        /*0010*/  LOP3.LUT R7, R5, R6, RZ, 0xc0, !PT ;  /* 0x000000060507 */
        /*0020*/  NOP;  /* 0x0000000000007918 */
        /*0030*/  EXIT ;  /* 0x000000000000794d */
"""


PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3revPKhPi' for 'sm_90a'
ptxas info    : Function properties for _Z3revPKhPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 35272 bytes smem, \
400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3onePKhPi' for 'sm_90a'
ptxas info    : Function properties for _Z3onePKhPi
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 38 registers, 384 bytes cmem[0]
"""


def test_parse_ptxas_per_function():
    assert chip_smoke.parse_ptxas(PTXAS) == {
        "_Z3revPKhPi": {"registers": 40, "smem_bytes": 35272,
                        "spill_stores": 0, "spill_loads": 0},
        "_Z3onePKhPi": {"registers": 38, "smem_bytes": 0,
                        "spill_stores": 12, "spill_loads": 8}}


def test_sass_alu_counts_per_function():
    # Memory, control, special-register and uniform ops are not counted;
    # predicated ops are; encoding-only lines are skipped.
    assert chip_smoke.sass_alu_counts(SASS) == {
        "_Z5probeILi9EEvPKjPj": 4, "_Z5probeILi1EEvPKjPj": 1}


@pytest.mark.parametrize("rev", [False, True])
def test_myers_ops_counts_the_swept_lengths(rev):
    vl = torch.tensor([6, 7, 40], dtype=torch.int32)   # 40 sweeps 32
    ql = torch.tensor([0, 8], dtype=torch.int32)
    steps = 3 * (0 + 8) if rev else 2 * (6 + 7 + 32)
    assert chip_smoke.myers_ops(vl, ql, rev, 15.0) == 15.0 * steps


def test_bound_takes_the_larger_time():
    by_ops = chip_smoke.bound(3.35e9, 1.0e12, 1.0e13)      # 1 ms vs 100 ms
    assert by_ops == {"bound_ms": pytest.approx(100.0),
                      "bound_by": "operations"}
    by_bytes = chip_smoke.bound(3.35e12, 1.0, 1.0e13)
    assert by_bytes == {"bound_ms": pytest.approx(1000.0),
                        "bound_by": "bytes"}


def _variants():
    """tools/myers_variants.py, loaded from its path (sys.path is left
    as it is)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(chip_smoke.__file__), "tools",
                        "myers_variants.py")
    spec = importlib.util.spec_from_file_location("myers_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_myers_variants_parse_specs():
    mv = _variants()
    assert mv.parse_variant("kChains=4,kSigma=64") == {"kChains": "4",
                                                       "kSigma": "64"}
    for bad in ("chains=4", "kChains=four", "kChains"):
        with pytest.raises(SystemExit):
            mv.parse_variant(bad)


SOURCE = """constexpr int kTerms = 256;       // terms per block
constexpr int kTermsPerWarp = kTerms / 8;
constexpr int kSigma = 32;
__global__ void __launch_bounds__(kTerms, kBlocks) k() {}
"""


@pytest.mark.parametrize("source,name", [("a.cu", "kTerms"),
                                         ("b.cu", "kTermsPerWarp"),
                                         ("c.cu", "kSigma")])
def test_myers_variants_change_one_declaration(source, name):
    """Only the named declaration changes (not one whose name it
    prefixes, nor a use), and an undeclared name exits."""
    mv = _variants()
    out = mv.apply_changes(SOURCE, {name: "7"}, source)
    assert f"constexpr int {name} = 7;" in out
    changed = [(a, b) for a, b in zip(SOURCE.splitlines(), out.splitlines())
               if a != b]
    assert len(changed) == 1 and f"int {name} =" in changed[0][0]
    with pytest.raises(SystemExit):
        mv.apply_changes(SOURCE, {"kNoSuchConstant": "1"}, source)


def test_fallback_phase_rehearsal(tmp_path, monkeypatch):
    """The fallback-routes phase on a small CPU index: the dense route
    serves every > 32-term query and agrees with the boolean oracle,
    search_many with the other routers off answers like the default
    routes on the candidate executor, and the R > 0 prefix rows (small
    impact-prefix thresholds) answer like the MAX_WIDE = 0 ones, some
    certified and some falling back, with the captured R > 0 groups
    replayed."""
    import bench
    from nxsearch_tpu_torch import Nxs, Params
    from nxsearch_tpu_torch import search as psearch
    from nxsearch_tpu_torch.index.device import DeviceIndex

    for name, value in {"N_DOCS": 3000, "VOCAB": 6000, "N_DENSE": 12,
                        "N_DENSE_ORACLE": 4, "N_MIXED": 96, "N_CAND": 96,
                        "N_WIDE": 96, "WIDE_BATCH": 32,
                        "N_WIDE_SINGLE": 8}.items():
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(DeviceIndex, "PREFIX_CAP", 64)
    monkeypatch.setattr(DeviceIndex, "WIDE_MIN_DF", 64)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    nxs = Nxs(str(tmp_path), device="cpu")
    idx = nxs.index_create("bench")
    idx.add_many(bench.zipf_range(0, 3000, 6000, 20))
    sp = Params().set_uint("limit", 10)
    idx.search("w00001", sp)                  # builds the snapshot
    try:
        out = chip_smoke.fallback_phase(idx, sp, chip_smoke.HostOracle(idx),
                                        "a card, 700 W")
    finally:
        nxs.close()
    assert out["dense"]["rows"] == 12
    assert out["candidate"]["rows"] > 0
    wide = out["prefix_wide"]
    stats = wide["stats"]
    assert stats["prefix"] > 0 and stats["prefix_fallback"] > 0
    assert 0 < wide["certified_wide"] <= wide["plans_wide"]
    assert wide["replayed"] > 0 and wide["replay_max_abs_err"] == 0.0
    assert wide["region"]["wide_terms"] > 0
    for name in ("_prefix_mode", "_use_sliced", "_use_blockdense"):
        assert getattr(psearch, name).__name__ == name     # restored
    assert psearch._PREFIX_MAX_WIDE == 0      # restored


def test_ingest_service_entry_phases_rehearsal(tmp_path, monkeypatch):
    """Phases 11-13 on a small CPU index: parallel ingest equal to the
    serial build, the in-process service (batched, typo, sequential and
    boolean traffic, each answer equal to the library's, the route
    counters equal to the library's, one single-query sweep per
    distinct uncached typo), and the service and the CLI as
    subprocesses.  The kernels' plain twins stand in for the kernels
    and bump their launch counts."""
    import bench
    from nxsearch_tpu_torch import Nxs, Params
    from nxsearch_tpu_torch.index.device import DeviceIndex
    from nxsearch_tpu_torch.ops import kernels

    monkeypatch.setattr(DeviceIndex, "PREFIX_CAP", 64)   # sliced rows too
    monkeypatch.setattr(DeviceIndex, "WIDE_MIN_DF", 64)
    for name, value in {"N_DOCS": 3000, "VOCAB": 6000, "MEAN_LEN": 20,
                        "N_QUERIES": 512, "BATCH": 128, "N_FUZZY": 64,
                        "N_PAR_CHECK": 16, "SVC_REQ": 64, "N_SEQ": 16,
                        "INGEST_WORKERS": 2}.items():
        monkeypatch.setattr(chip_smoke, name, value)
    for twin, kernel in (("myers_distances_ref", kernels.MYERS),
                         ("myers_distances_one_ref", kernels.MYERS_ONE),
                         ("myers_rev_distances_ref", kernels.MYERS_REV)):
        def counted(*a, _fn=getattr(kernels, twin), _k=kernel, **kw):
            _k.launches += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(kernels, twin, counted)
    for name, fn in {"synchronize": lambda *a, **kw: None,
                     "empty_cache": lambda: None,
                     "memory_allocated": lambda *a: 0,
                     "mem_get_info": lambda *a: (0, 0)}.items():
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setenv("NXS_MALLOC_TUNE", "0")
    workdir = str(tmp_path / "work")
    nxs = Nxs(workdir, device="cpu")
    idx = nxs.index_create("bench")
    idx.add_many(bench.zipf_range(0, 3000, 6000, 20))
    sp = Params().set_uint("limit", 10)
    card = "a card, 700 W"
    try:
        idx.checkpoint()
        par = chip_smoke.parallel_ingest_phase(idx, sp, 1.0, card, "cpu")
        svc = chip_smoke.service_phase(workdir, idx, sp, card, "cpu")
        ep = chip_smoke.entry_point_phase(workdir, idx, sp, card, "cpu")
    finally:
        nxs.close()
    assert par["workers"] == 2 and par["seconds"] > 0
    assert svc["routes"]["prefix"] > 0 and svc["routes"]["sliced"] > 0
    assert svc["typo_launches"]["fwd"] > 0
    assert svc["seq_launches"]["one"] == svc["seq_typos"] > 0
    assert svc["requests"] > 0
    assert ep["cli_timings"] and ep["service_ready_s"] > 0


def test_mesh_phase_rehearsal(tmp_path, monkeypatch):
    """Phase 14 on a small CPU index: a mesh of four CPU shards over the
    same basedir -- pure-OR rows on the prefix body, mixed rows on the
    sliced and fallback bodies, blockdense rows on the kernel body (the
    segsum twin, one replayed), dense rows, single queries with typos
    and a removal -- every answer equal to the single device's, and the
    dryrun.  The kernels' plain twins bump their launch counts."""
    import bench
    from nxsearch_tpu_torch import Nxs, Params
    from nxsearch_tpu_torch.ops import kernels

    for name, value in {"N_DOCS": 3000, "VOCAB": 6000, "N_QUERIES": 512,
                        "BATCH": 128, "N_FUZZY": 16, "N_MIXED": 256,
                        "N_BD": 64, "N_DENSE": 8, "N_MESH_DENSE": 8,
                        "N_MESH_SINGLE": 8}.items():
        monkeypatch.setattr(chip_smoke, name, value)
    for twin, kernel in (("myers_distances_ref", kernels.MYERS),
                         ("myers_distances_one_ref", kernels.MYERS_ONE),
                         ("blockdense_scores_ref", kernels.SEGSUM)):
        def counted(*a, _fn=getattr(kernels, twin), _k=kernel, **kw):
            _k.launches += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(kernels, twin, counted)
    for name, fn in {"synchronize": lambda *a, **kw: None,
                     "empty_cache": lambda: None}.items():
        monkeypatch.setattr(torch.cuda, name, fn)
    workdir = str(tmp_path / "work")
    nxs = Nxs(workdir, device="cpu")
    idx = nxs.index_create("bench")
    idx.add_many(bench.zipf_range(0, 3000, 6000, 20))
    sp = Params().set_uint("limit", 10)
    idx.search("w00001", sp)                  # builds the snapshot
    # Small tensors: one intra-op thread runs them faster, and keeps
    # doing so when the suite's workers share the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chip_smoke.mesh_phase(workdir, idx, sp, "a card, 700 W",
                                    {"qps": 1.0, "mixed_qps": 1.0}, "cpu")
    finally:
        torch.set_num_threads(threads)
        nxs.close()
    assert out["stats"]["sharded_prefix"] > 0
    assert out["mixed_stats"]["sharded_fallback"] > 0
    assert out["bd_segsum_launches"] >= 4 and out["bd_max_abs_err"] == 0.0
    assert out["launches"]["nxs_myers_distances_one"] > 0
    assert out["shard_bytes"] and len(out["dense_rows"]) == 4


def test_large_phase_rehearsal(monkeypatch):
    """Phase 15 on a small CPU index: the prefix, sliced and blockdense
    routers off, and the mesh's (as phase 10(b) turns them off; from
    2**24 slots the planner does), every drive on the candidate and
    dense executors, the oracles, the targeted documents from a small
    slot threshold in odd and even slots, the same index on a mesh of
    one device (its candidate and dense bodies), and the removal.  The
    kernels' plain twins bump their launch counts."""
    from nxsearch_tpu_torch import Params
    from nxsearch_tpu_torch import search as psearch
    from nxsearch_tpu_torch.ops import kernels

    for name, value in {"N_LARGE": 4000, "VOCAB": 6000,
                        "LARGE_CHUNK": 1500, "LARGE_GEN_WORKERS": 1,
                        "LARGE_SLOT_FROM": 2000, "N_LARGE_QUERIES": 256,
                        "BATCH": 64, "N_LARGE_FUZZY": 32, "N_LARGE_MIXED": 96,
                        "N_LARGE_SINGLE": 8, "N_LARGE_DENSE": 2,
                        "N_LARGE_ORACLE": 8, "N_LARGE_FUZZY_ORACLE": 4,
                        "N_LARGE_BOOL_ORACLE": 4, "N_ODD": 4, "N_EVEN": 2,
                        "LARGE_DF_MAX": 20}.items():
        monkeypatch.setattr(chip_smoke, name, value)
    for twin, kernel in (("myers_distances_ref", kernels.MYERS),
                         ("myers_distances_one_ref", kernels.MYERS_ONE)):
        def counted(*a, _fn=getattr(kernels, twin), _k=kernel, **kw):
            _k.launches += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(kernels, twin, counted)
    for name in ("_prefix_mode", "_use_sliced", "_use_blockdense",
                 "_prefix_mode_sharded", "_sharded_sliced",
                 "_sharded_kernel"):
        monkeypatch.setattr(psearch, name, lambda *a, **kw: False)
    # Small tensors: one intra-op thread, as in the mesh rehearsal.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chip_smoke.large_phase(Params().set_uint("limit", 10),
                                     "a card, 700 W", "cpu")
    finally:
        torch.set_num_threads(threads)
    assert out["n_slots"] >= 2000 and out["targeted"] == 6
    assert out["targeted_odd"] == 4 and out["f32_rounded"] == 0
    assert out["fuzzy"]["launches"]["nxs_myers_distances"] > 0
    assert out["single"]["launches"]["nxs_myers_distances_one"] > 0
    assert out["dense"]["stats"]["dense"] == 2
    assert out["plain"]["stats"]["candidate"] == 256
    mesh = out["mesh"]
    assert mesh["targeted"] == 6 and mesh["targeted_odd"] == 4
    assert mesh["stats"]["sharded_fallback"] == 6 + 2
    assert psearch._submit_plans.__name__ == "_submit_plans"   # restored


def test_north_phase_rehearsal(monkeypatch):
    """Phase 16 on a small CPU index of the north-star shapes' generator
    (vocabulary 6000, mean length 60): the dense-row budget lowered to
    the full tier's row count (and restored), every drive's routes and
    launches (forward, transposed, single-query Myers and segsum, each
    through its twin), the transposed and blockdense answers equal to
    the forward and default routes', the oracles, the kernels at the
    phase's shapes against their twins (a host clock for the card's
    events), the widest dispatch groups, and bench_torch.py as a
    subprocess on the CPU."""
    import os
    import shutil
    import time

    from nxsearch_tpu_torch import Params
    from nxsearch_tpu_torch import search as psearch
    from nxsearch_tpu_torch.index.device import DeviceIndex
    from nxsearch_tpu_torch.ops import kernels

    bench_args = ["--docs", "3000", "--vocab", "6000", "--queries", "64",
                  "--batch", "32"]
    for name, value in {"N_NORTH": 4000, "NORTH_VOCAB": 6000,
                        "LARGE_CHUNK": 1500, "LARGE_GEN_WORKERS": 1,
                        "N_NORTH_QUERIES": 256, "BATCH": 64,
                        "N_NORTH_FUZZY": 32, "N_NORTH_SINGLE": 8,
                        "N_NORTH_DENSE": 2, "N_NORTH_ORACLE": 8,
                        "N_NORTH_FUZZY_ORACLE": 4, "N_NORTH_BOOL_ORACLE": 4,
                        "N_BD": 32, "KERNEL_M": 8, "KERNEL_REPS": 1,
                        "NORTH_BENCH": bench_args}.items():
        monkeypatch.setattr(chip_smoke, name, value)
    for twin, kernel in (("myers_distances_ref", kernels.MYERS),
                         ("myers_distances_one_ref", kernels.MYERS_ONE),
                         ("myers_rev_distances_ref", kernels.MYERS_REV),
                         ("blockdense_scores_ref", kernels.SEGSUM)):
        def counted(*a, _fn=getattr(kernels, twin), _k=kernel, **kw):
            _k.launches += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(kernels, twin, counted)

    def host_times(fn, runs, reps=1, flush=None):
        out = []
        for _ in range(runs):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / reps)
        return out

    monkeypatch.setattr(chip_smoke, "cuda_times", host_times)
    monkeypatch.setattr(chip_smoke, "int32_ops_per_s", lambda: 1.0e13)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setenv("NXS_MALLOC_TUNE", "0")
    # The bench_torch.py subprocess too takes one intra-op thread: with
    # every core's worth beside the suite's other workers its small
    # ops run thousands of times slower.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    budget = DeviceIndex.DENSE_ROWS_MAX_BYTES
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cache = os.path.join(chip_smoke.ROOT, ".bench_cache",
                         "d3000-v6000-l40-s42")
    try:
        out = chip_smoke.north_phase(Params().set_uint("limit", 10),
                                     "a card, 700 W", 17.0, "cpu")
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(cache, ignore_errors=True)
    assert DeviceIndex.DENSE_ROWS_MAX_BYTES == budget            # restored
    assert psearch._group_rows_cap.__name__ == "_group_rows_cap"
    assert psearch._MASKED_HYBRID is True
    rows = out["dense_budget"]["rows"]
    assert rows == budget // (4 * 9 * (1 << 20))                # full tier
    assert out["dense_budget"]["set"] == rows * 4 * 4096
    assert out["dense_rows"] == rows < out["heavy_terms"]
    assert out["plain"]["stats"]["prefix"] > 0
    assert out["fuzzy"]["launches"]["nxs_myers_distances"] > 0
    assert out["single"]["launches"]["nxs_myers_distances_one"] > 0
    assert out["rev"]["launches"]["nxs_myers_rev_distances"] > 0
    assert out["blockdense"]["launches"]["nxs_segsum_blockdense"] > 0
    assert out["dense"]["stats"]["dense"] == 2
    for name in ("nxs_myers_distances", "nxs_myers_distances_one",
                 "nxs_myers_rev_distances", "nxs_segsum_blockdense"):
        assert out["launches"][name] > 0, name
    for name in ("fwd", "rev", "one", "segsum"):
        k = out["kernels"][name]
        assert k["max_abs_err"] == 0 and k["bound_ms"] > 0, name
    assert out["kernels"]["fwd"]["shape"]["W"] == 6000
    assert out["widest"]["pf"]["qs"] > 0 and out["widest"]["bd"]["q"] > 0
    line = out["bench"]["line"]
    assert line["detail"]["docs"] == 3000 and line["value"] > 0


def _host_times(fn, runs, reps=1, flush=None):
    """chip_smoke.cuda_times on the host's clock (no card here)."""
    import time

    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append((time.perf_counter() - t0) * 1e3 / reps)
    return out


def test_occupied_blocks_counts_blocks_with_a_posting():
    bounds = torch.zeros((2, 2, 5), dtype=torch.int32)
    bounds[0, 0] = torch.tensor([0, 0, 3, 3, 3])      # block 1
    bounds[1, 1] = torch.tensor([5, 5, 5, 5, 9])      # block 3
    bounds[1, 0] = torch.tensor([2, 2, 5, 5, 5])      # block 1 again
    assert chip_smoke.occupied_blocks(bounds) == 2
    assert chip_smoke.occupied_blocks(bounds[:, :0]) == 0
    # Per-slot columns only in the 2 occupied blocks: 8 B x 1024 each.
    assert chip_smoke.segsum_bytes(bounds, 4096, 7, 2) == (
        8 * 2 * 4096 + 8 * 7 + 8 * 1024 * 2 + 4 * 20 + 16 * 4)


def test_distinct_postings_counts_shared_ranges_once():
    """A term several rows share is read once: the bound counts the
    union of the (row, term) ranges, not their sum."""
    bounds = torch.zeros((3, 2, 3), dtype=torch.int32)
    bounds[0, 0] = torch.tensor([0, 4, 10])     # term A: postings 0-9
    bounds[1, 1] = torch.tensor([0, 4, 10])     # A again, another row
    bounds[2, 0] = torch.tensor([20, 20, 26])   # term B: 20-25
    bounds[2, 1] = torch.tensor([8, 12, 22])    # overlaps A and B
    assert chip_smoke.distinct_postings(bounds) == 26
    assert chip_smoke.distinct_postings(bounds[:, :1]) == 16
    assert chip_smoke.distinct_postings(bounds[:, :0]) == 0
    assert chip_smoke.distinct_postings(torch.zeros_like(bounds)) == 0
    b = chip_smoke.segsum_bound(bounds, 2048)
    assert (b["postings"], b["distinct_postings"],
            b["occupied_blocks"]) == (10 + 10 + 6 + 14, 26, 2)
    assert b["bound_ms"] == pytest.approx(chip_smoke.segsum_bytes(
        bounds, 2048, 26, 2) / chip_smoke.HBM_BYTES_PER_S * 1e3)


SMALL_SEGSUM_CASES = {
    "1m": {"rows": 16, "slots": 1 << 14, "docs": 16_000, "vocab": 6000,
           "postings": 640_000, "dense": 20, "mean_len": 40},
    "tier": {"rows": 7, "slots": 64 << 10, "docs": 60_000, "vocab": 6000,
             "postings": 600_000, "dense": 20, "mean_len": 60},
    "heavy": {"rows": 7, "slots": 9 << 10, "docs": 9000, "heavy": 8,
              "heavy_df": 1000, "mean_len": 60},
}


@pytest.mark.parametrize("case", ["1m", "tier", "heavy"])
def test_segsum_cases_rehearsal(case, monkeypatch):
    """chip_smoke.py's synthetic segsum launches (segsum_synthetic,
    segsum_case) at a small S on the CPU, the kernel's wrapper taking
    its twin: exact, the shape, postings, distinct postings and occupied
    blocks counted, the bound over the distinct postings and the
    occupied blocks' columns, a store-floor time;
    the heavy case's rows hold every heavy term in every block."""
    monkeypatch.setattr(chip_smoke, "SEGSUM_CASES", SMALL_SEGSUM_CASES)
    monkeypatch.setattr(chip_smoke, "cuda_times", _host_times)
    monkeypatch.setattr(chip_smoke, "KERNEL_REPS", 1)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    c = SMALL_SEGSUM_CASES[case]
    args, facts = chip_smoke.segsum_synthetic(case, device="cpu")
    again, _ = chip_smoke.segsum_synthetic(case, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(args, again))   # seeded
    out = chip_smoke.segsum_case(args, case)
    bounds = args[4]
    n_blocks = c["slots"] // 1024
    assert out["max_abs_err"] == 0.0
    assert out["shape"] == {"N": c["rows"], "Q": 8, "S": c["slots"]}
    assert out["postings"] == int((bounds[:, :, -1] - bounds[:, :, 0]).sum())
    read = set()
    for lo, hi in zip(bounds[:, :, 0].flatten().tolist(),
                      bounds[:, :, -1].flatten().tolist()):
        read.update(range(lo, hi))
    assert out["distinct_postings"] == len(read) <= facts["term_postings"]
    assert 0 < out["occupied_blocks"] <= n_blocks
    n_bytes = chip_smoke.segsum_bytes(bounds, c["slots"],
                                      out["distinct_postings"],
                                      out["occupied_blocks"])
    assert out["bound_ms"] == pytest.approx(
        n_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert out["store_floor_ms"] > 0 and out["ms"] > 0
    alive = args[3]
    assert not alive[c["docs"]:].any() and alive[: c["docs"]].mean() > 0.9
    if case == "heavy":
        assert facts == {"terms": 8, "term_postings": 8 * 1000}
        assert out["postings"] == 7 * 8 * 1000
        assert out["distinct_postings"] == 8 * 1000
        assert out["occupied_blocks"] == n_blocks
        assert bool((bounds[:, :, 1:] > bounds[:, :, :-1]).all())
    else:
        # Rows as bd_queries': one or two kernel terms, the rest zero.
        live = (bounds[:, :, -1] > bounds[:, :, 0]).sum(1)
        assert bool((live <= 2).all()) and int(live.sum()) > 0
        assert not bounds[:, 3:].any()


def _segsum_variants():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(chip_smoke.__file__), "tools",
                        "segsum_variants.py")
    spec = importlib.util.spec_from_file_location("segsum_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_segsum_variants_sources(tmp_path):
    """tools/segsum_variants.py's specs: ``base`` is csrc/segsum.cu as it
    is, each tunable constant it documents is declared once there, and
    ``@PATH`` reads another source whole."""
    from nxsearch_tpu_torch.ops import kernels

    sv = _segsum_variants()
    with open(f"{kernels.CSRC_DIR}/segsum.cu") as f:
        text = f.read()
    assert sv.variant_source("base") == ("base", text)
    for name in ("kThreads", "kCtasPerSm", "kTileRows", "kPairsPerThread",
                 "kListPerThread", "kTermRegs"):
        label, out = sv.variant_source(f"{name}=3")
        assert f"constexpr int {name} = 3;" in out and label == f"{name}=3"
    other = tmp_path / "segsum.cu"
    other.write_text("// another commit's kernel\n")
    assert sv.variant_source(f"@{other}") == (
        f"@{other}", "// another commit's kernel\n")


def test_segsum_variants_seed_sweep(monkeypatch, capsys):
    """tools/segsum_variants.py --tier-seeds on the CPU at a small S, the
    twin standing in for a built variant: a line per seed with its
    bound and ratio, then the variant's spread over the seeds."""
    import json

    from nxsearch_tpu_torch.ops import kernels

    sv = _segsum_variants()
    monkeypatch.setattr(chip_smoke, "SEGSUM_CASES", SMALL_SEGSUM_CASES)
    monkeypatch.setattr(chip_smoke, "cuda_times", _host_times)
    monkeypatch.setattr(chip_smoke, "KERNEL_REPS", 1)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "card, 1 W")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)

    def twin(*args):
        return kernels.blockdense_scores_ref(*args, algo=0, use_mask=True)

    sv.seed_sweep([("twin", "")], [twin], 3, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "card, 1 W" and len(lines) == 5
    seeds = [json.loads(line) for line in lines[1:4]]
    assert [x["seed"] for x in seeds] == [45, 46, 47]
    for x in seeds:
        assert x["ratio"]["twin"] == pytest.approx(
            x["bound_ms"] / x["ms"]["twin"])
        assert x["distinct_postings"] <= x["postings"]
    last = json.loads(lines[4])
    ms = sorted(x["ms"]["twin"] for x in seeds)
    assert last["seeds"] == 3 and last["variant"] == "twin"
    assert (last["ms"]["min"], last["ms"]["median"],
            last["ms"]["max"]) == (ms[0], ms[1], ms[2])
