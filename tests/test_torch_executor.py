"""Executor parity: the port's prefix_topk (R = 0) and sliced_topk held to
nxsearch_tpu's on identical inputs.

One small Zipf index is built through nxsearch_tpu on the CPU; its
DeviceIndex arrays are exported with np.asarray and loaded into the
port with DeviceIndex.from_arrays, and the reference's own planner
(_build_plans, with its packers) produces every group buffer, so both
executors read the same bytes.  Covered branches: prefix R = 0,
sliced single, windowed n_run, the dense-row hybrid use_rows and the
head merge T_head, each with and without tombstoned documents.
Tolerance: scores within 1e-4 (the reference's own tests); slots
identical.  The port's own snapshot build is held to the reference's
arrays too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import nxsearch_tpu.search as jsearch
from nxsearch_tpu import Nxs as JNxs
from nxsearch_tpu.index.device import DeviceIndex as JDeviceIndex
from nxsearch_tpu.ops import executor as jexec
from nxsearch_tpu.search import SearchParams, _build_plans, _prepare_many
from nxsearch_tpu_torch.index.device import DeviceIndex as PDeviceIndex
from nxsearch_tpu_torch.index.hostindex import HostIndex as PHostIndex
from nxsearch_tpu_torch.ops import executor as pexec

N_DOCS, VOCAB, MEAN_LEN = 2000, 3000, 20
K = 16
TOL = 1e-4

# Small impact-prefix thresholds so the little corpus has wide terms
# (whose rows the planner sends down the classic sliced path).
_SMALL_PREFIX = {"PREFIX_CAP": 256, "WIDE_MIN_DF": 256}


def export_arrays(dev) -> dict:
    """The reference snapshot's state, as from_arrays takes it."""
    return {
        "postings_pack": np.asarray(dev.postings_pack),
        "doc_len": np.asarray(dev.doc_len),
        "alive_mask": np.asarray(dev.alive_mask),
        "dense_rows": np.asarray(dev.dense_rows),
        "term_starts": dev.term_starts, "slot_perm": dev.slot_perm,
        "dense_row_lookup": dev.dense_row_lookup,
        "prefix_start_lookup": dev.prefix_start_lookup,
        "prefix_tail": dev.prefix_tail, "prefix_len": dev.prefix_len,
        "n_postings": dev.n_postings, "slice_t_cap": dev.slice_t_cap,
    }


def _queries():
    ranks = np.arange(VOCAB, dtype=np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    words = np.array([f"w{i:05d}" for i in range(VOCAB)])
    rng = np.random.default_rng(5)
    multi = bench.make_queries(120, words, probs, rng)
    single = [str(w) for w in words[rng.choice(VOCAB, 40, p=probs)]]
    head = [str(w) for w in words[:12]]     # the heaviest terms
    return multi + single + head + [f"{a} {b}" for a, b in
                                    zip(head, single)]


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    for cls in (JDeviceIndex, PDeviceIndex):
        for name, value in _SMALL_PREFIX.items():
            mp.setattr(cls, name, value)
    basedir = str(tmp_path_factory.mktemp("exec"))
    nxs = JNxs(basedir)
    idx = nxs.index_create("t")
    idx.add_many(bench.zipf_range(0, N_DOCS, VOCAB, MEAN_LEN))
    idx._read_synced()
    idx._rw.read_release()
    yield idx
    nxs.close()
    mp.undo()


def _remove_some(idx):
    """Tombstone every 7th document (alive_all becomes False)."""
    for doc_id in range(1, N_DOCS + 1, 7):
        idx.remove(doc_id)
    idx._read_synced()
    idx._rw.read_release()
    assert not idx.dev.alive_all


def _port_dev(idx):
    return PDeviceIndex.from_arrays(idx.host, export_arrays(idx.dev),
                                    "cpu")


def _groups(plans, key_of):
    groups: dict = {}
    for p in plans:
        if p is not None:
            groups.setdefault(key_of(p), []).append(p)
    return groups


def _check(want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert want.shape == got.shape
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    assert (want[:, 0] > 0).any()


def _run_prefix(idx, pdev, sp):
    jdev = idx.dev
    plans = _build_plans(jdev, _prepare_many(
        jdev, idx.pipeline, _queries(), sp), sp)
    groups = _groups([p for p in plans if p is not None and p.pf],
                     lambda p: (p.sl_T, p.n_run))
    assert groups
    for (T, n_run), members in groups.items():
        assert all(len(p.pf_tail) == 0 for p in members)     # R = 0
        qs = max(len(p.sl_start) for p in members)
        n = len(members)
        arr = {f: np.zeros((n, qs), np.float32 if f == "sl_idf"
                           else np.int32)
               for f in ("sl_start", "sl_len", "sl_idf", "pf_bits")}
        for row, p in enumerate(members):
            w = len(p.sl_start)
            for f in arr:
                arr[f][row, :w] = getattr(p, f)
        empty = np.zeros((n, 0), np.float32)
        buf = jexec.pack_prefix_group(
            arr["sl_start"], arr["sl_len"], arr["sl_idf"], arr["pf_bits"],
            empty, empty.astype(np.int32), empty.astype(np.int32), empty)
        want = jexec.device_search_prefix_packed(
            jdev.postings_pack, jdev.alive_mask, jnp.asarray(buf),
            jdev.adl_dev, qs=qs, R=0, T=T, k=K, M=32, algo=0,
            n_slots=jdev.n_slots, alive_all=jdev.alive_all, n_run=n_run,
            k_ret=10)
        got = pexec.prefix_topk_packed(
            pdev.postings_pack, pdev.alive_mask, torch.from_numpy(buf),
            pdev.adl_dev, qs=qs, R=0, T=T, k=K, algo=0,
            n_slots=pdev.n_slots, alive_all=pdev.alive_all, n_run=n_run)
        _check(want, got)


def _run_sliced(idx, pdev, sp, branch):
    jdev = idx.dev
    plans = _build_plans(jdev, _prepare_many(
        jdev, idx.pipeline, _queries(), sp), sp, no_prefix=True)
    pick = {
        "single": lambda p: p.single and not p.use_rows,
        "n_run": lambda p: (not p.single and not p.use_rows
                            and not p.h_T),
        "use_rows": lambda p: p.use_rows,
        "T_head": lambda p: p.h_T > 0,
    }[branch]
    groups = _groups([p for p in plans if p is not None and pick(p)],
                     lambda p: (p.sl_T, p.single, p.use_rows, p.h_T,
                                p.n_run))
    assert groups, branch
    for (T, single, use_rows, t_head, n_run), members in groups.items():
        qs = max(len(p.sl_start) for p in members)
        n = len(members)
        sl = {f: np.zeros((n, qs), np.float32 if f == "sl_idf"
                          else np.int32)
              for f in ("sl_start", "sl_len", "sl_idf")}
        d_row = np.full((n, 4), -1, np.int32)
        d_idf = np.zeros((n, 4), np.float32)
        h = {"h_start": np.zeros(n, np.int32), "h_len": np.zeros(n, np.int32),
             "h_idf": np.zeros(n, np.float32), "h_row": np.zeros(n, np.int32),
             "h_pass": np.zeros(n, np.bool_)}
        for row, p in enumerate(members):
            w = len(p.sl_start)
            for f in sl:
                sl[f][row, :w] = getattr(p, f)
            d_row[row], d_idf[row] = p.d_row, p.d_idf
            for f in h:
                h[f][row] = getattr(p, f)
        buf = jexec.pack_sliced_group(
            sl["sl_start"], sl["sl_len"], sl["sl_idf"], None, None,
            d_row if use_rows else None, d_idf if use_rows else None,
            *([h[f] for f in h] if t_head else [None] * 5))
        want = jexec.device_search_sliced_packed(
            jdev.postings_pack, jdev.alive_mask, jdev.doc_len,
            jnp.asarray(buf), jdev.adl_dev,
            jdev.dense_rows if use_rows else None,
            qs=qs, L=1, D=4, T=T, k=K, algo=0, n_slots=jdev.n_slots,
            use_mask=False, single=single, alive_all=jdev.alive_all,
            use_rows=use_rows, depth=4, T_head=t_head, n_run=n_run)
        got = pexec.sliced_topk_packed(
            pdev.postings_pack, pdev.alive_mask, pdev.doc_len,
            torch.from_numpy(buf), pdev.adl_dev,
            pdev.dense_rows if use_rows else None,
            qs=qs, D=4, T=T, k=K, algo=0, n_slots=pdev.n_slots,
            use_mask=False, single=single, alive_all=pdev.alive_all,
            use_rows=use_rows, T_head=t_head, n_run=n_run)
        _check(want, got)


SP = SearchParams(limit=10, algo=0, fuzzymatch=True)
BRANCHES = ["single", "n_run", "use_rows", "T_head"]


@pytest.fixture
def head_thresholds(monkeypatch):
    """Turn the (default-off) head-term extraction on in the planner."""
    monkeypatch.setattr(jsearch, "_HEAD_MIN_DF", 64)
    monkeypatch.setattr(jsearch, "_HEAD_MIN_DF_PAIR", 64)


def test_prefix_r0_matches_reference(index):
    _run_prefix(index, _port_dev(index), SP)


@pytest.mark.parametrize("branch", BRANCHES)
def test_sliced_matches_reference(index, branch, head_thresholds):
    _run_sliced(index, _port_dev(index), SP, branch)


def test_snapshot_build_matches_reference(index):
    """The port's own rebuild over the same journals equals the
    reference snapshot array for array (ltf is an f32 log on both
    sides; the two libraries' log may differ by an ulp)."""
    jdev = index.dev
    host = PHostIndex(index.host.idxdir)
    try:
        pdev = PDeviceIndex(host, "cpu")
        assert pdev.refresh()
        p_pad = jdev.n_postings
        assert (pdev.n_slots, pdev.n_postings, pdev.slice_t_cap) == \
            (jdev.n_slots, p_pad, jdev.slice_t_cap)
        np.testing.assert_array_equal(pdev.term_starts, jdev.term_starts)
        np.testing.assert_array_equal(pdev.slot_perm, jdev.slot_perm)
        np.testing.assert_array_equal(pdev.dense_row_lookup,
                                      jdev.dense_row_lookup)
        np.testing.assert_array_equal(pdev.prefix_start_lookup,
                                      jdev.prefix_start_lookup)
        assert (jdev.prefix_start_lookup >= 0).any()
        assert pdev.prefix_ready and pdev.adl_built == jdev.adl_built
        jpack = np.asarray(jdev.postings_pack)[:p_pad]
        ppack = pdev.postings_pack.numpy()[:p_pad]
        np.testing.assert_array_equal(ppack[:, 0], jpack[:, 0])
        np.testing.assert_array_equal(ppack[:, 2], jpack[:, 2])
        np.testing.assert_allclose(ppack[:, 1], jpack[:, 1], rtol=2e-7)
        np.testing.assert_array_equal(pdev.doc_len.numpy(),
                                      np.asarray(jdev.doc_len))
        np.testing.assert_array_equal(
            pdev.alive_mask.numpy(),
            np.asarray(jdev.alive_mask).view(np.int32))
        np.testing.assert_allclose(pdev.dense_rows.numpy(),
                                   np.asarray(jdev.dense_rows), rtol=2e-7)
    finally:
        host.close()


def test_tombstoned_docs_match_reference(index, head_thresholds):
    """After removals (alive_all False) every branch still agrees.
    Runs last in this module: it tombstones documents of the shared
    index."""
    _remove_some(index)
    pdev = _port_dev(index)
    assert not pdev.alive_all
    _run_prefix(index, pdev, SP)
    for branch in BRANCHES:
        _run_sliced(index, pdev, SP, branch)
