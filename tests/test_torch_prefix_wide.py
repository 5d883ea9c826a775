"""Impact prefixes with wide terms (R > 0): the port held to nxsearch_tpu.

Both packages run with PREFIX_CAP = WIDE_MIN_DF = 8 and
_PREFIX_MAX_WIDE = 4 (as tests/test_prefix.py sets them), so a small
Zipf corpus has many wide terms and prefix plans carry up to four.

- The region build: the port's ``_build_prefix`` over the reference's
  own pack (loaded with ``DeviceIndex.from_arrays``, region rows wiped)
  gives the same offsets, tails and cut lengths and the same region
  rows [0, cut) bit for bit; the port's own rebuild from the journals
  gives the same layout.
- ``prefix_topk`` R > 0 on the reference planner's groups, read from
  the reference's pack with its region through ``from_arrays``:
  scores within 1e-4, slots equal (an adjacent swap only where the
  reference's scores differ by <= 1e-4), exact flags equal; with and
  without dead slots.
- Search level: responses and the counters prefix, prefix_exact,
  prefix_fallback and prefix_spec_used equal to the reference's for
  ``search_many`` (fallback sub-batch), ``search`` (speculative twin)
  and ``search_pipelined`` (deferred fallback), on the random corpus,
  the corpus whose impact hierarchy certifies, and after a delta.
"""

import numpy as np
import pytest
import torch

import nxsearch_tpu
import nxsearch_tpu.search as jsearch
import nxsearch_tpu_torch
from nxsearch_tpu.index.device import DeviceIndex as JDeviceIndex
from nxsearch_tpu.ops import executor as jexec
from nxsearch_tpu.search import SearchParams, _build_plans, _prepare_many
from nxsearch_tpu_torch import search as psearch
from nxsearch_tpu_torch.index.device import DeviceIndex as PDeviceIndex
from nxsearch_tpu_torch.index.hostindex import HostIndex as PHostIndex
from nxsearch_tpu_torch.ops import executor as pexec

TOL = 1e-4
CAP = 8
COUNTERS = ("prefix", "prefix_exact", "prefix_fallback", "prefix_spec_used")


def _small_cap(mp):
    for cls in (JDeviceIndex, PDeviceIndex):
        mp.setattr(cls, "PREFIX_CAP", CAP)
        mp.setattr(cls, "WIDE_MIN_DF", CAP)
    mp.setattr(jsearch, "_PREFIX_MAX_WIDE", 4)
    mp.setattr(psearch, "_PREFIX_MAX_WIDE", 4)


def _words(n=80):
    words = [f"t{i:03d}" for i in range(n)]
    probs = 1.0 / (np.arange(n) + 3.0)
    return words, probs / probs.sum()


def _zipf_docs(seed=11, n_docs=300):
    rng = np.random.default_rng(seed)
    words, probs = _words()
    return [(i + 1, " ".join(rng.choice(words, size=max(3, int(
        rng.poisson(14))), p=probs))) for i in range(n_docs)]


def _queries(seed, n=40):
    rng = np.random.default_rng(seed)
    words, _ = _words()
    return [" ".join(rng.choice(words, size=int(rng.integers(1, 5))))
            for _ in range(n)]


def _certify_docs():
    """tests/test_prefix.py's corpus with a clear impact hierarchy: 8
    short documents with "pad" x4 dominate the term's excluded tail
    (ids from 10,001, beside the Zipf documents)."""
    docs, did = [], 10_001
    for i in range(8):
        docs.append((did, " ".join(["pad"] * 4 + ["x"] * (2 + i))))
        did += 1
    for i in range(52):
        docs.append((did, "pad " + " ".join(
            f"f{j:02d}" for j in range(30 + i % 9))))
        did += 1
    for i in range(300):
        docs.append((did, " ".join(f"g{j:02d}" for j in range(20 + i % 7))))
        did += 1
    return docs


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(reference index, port index) over one basedir with small
    impact-prefix thresholds, holding the Zipf and the certifying
    corpus; the reference handle writes."""
    mp = pytest.MonkeyPatch()
    _small_cap(mp)
    basedir = str(tmp_path_factory.mktemp("wide"))
    jnxs = nxsearch_tpu.Nxs(basedir)
    jidx = jnxs.index_create("z")
    jidx.add_many(_zipf_docs() + _certify_docs())
    jidx._read_synced()             # build the reference snapshot
    jidx._rw.read_release()
    pnxs = nxsearch_tpu_torch.Nxs(basedir, device="cpu")
    yield jidx, pnxs.index_open("z")
    pnxs.close()
    jnxs.close()
    mp.undo()


def export_arrays(dev) -> dict:
    """The reference snapshot's state, as from_arrays takes it (the
    pack with its impact-prefix region)."""
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


def _wide(jdev):
    counts = np.diff(jdev.term_starts)
    return np.nonzero(counts > CAP)[0], counts


def _assert_region(jdev, lookup, tails, plens, pack, same_ltf=True):
    """Offsets and cuts equal; tails and region rows [0, cut) bit for
    bit.  ``same_ltf`` False: the pack's ltf was computed by another
    library's f32 log, which may differ by an ulp, so ltf and the tails
    are held to 2e-7 relative (slots and lengths stay exact)."""
    np.testing.assert_array_equal(lookup, jdev.prefix_start_lookup)
    np.testing.assert_array_equal(plens, jdev.prefix_len)
    jpack = np.asarray(jdev.postings_pack)
    tids = np.nonzero(jdev.prefix_start_lookup >= 0)[0]
    assert len(tids) > 10 and (jdev.prefix_len[tids] > 0).any()
    assert (jdev.prefix_len[tids] < CAP).any()     # boundary ties cut
    rows = np.concatenate([np.arange(s, s + c) for s, c in zip(
        jdev.prefix_start_lookup[tids], jdev.prefix_len[tids])])
    if same_ltf:
        np.testing.assert_array_equal(tails.view(np.int32),
                                      jdev.prefix_tail.view(np.int32))
        np.testing.assert_array_equal(pack[rows].view(np.int32),
                                      jpack[rows].view(np.int32))
    else:
        np.testing.assert_allclose(tails, jdev.prefix_tail, rtol=2e-7)
        np.testing.assert_array_equal(pack[rows][:, [0, 2]],
                                      jpack[rows][:, [0, 2]])
        np.testing.assert_allclose(pack[rows, 1], jpack[rows, 1],
                                   rtol=2e-7)


def test_region_build_matches_reference(pair):
    """The port's build over the reference's own pack."""
    jdev = pair[0].dev
    pdev = PDeviceIndex.from_arrays(pair[0].host, export_arrays(jdev),
                                    "cpu")
    wide, counts = _wide(jdev)
    p_pad = jdev.n_postings
    pack = pdev.postings_pack.clone()
    pack[p_pad: p_pad + len(wide) * CAP] = 0.0
    pdev.base_nterms = jdev.base_nterms
    pdev._build_prefix(pack, wide, jdev.term_starts, counts, cap=CAP,
                       p_pad=p_pad, adl_build=jdev.adl_built)
    _assert_region(jdev, pdev.prefix_start_lookup, pdev.prefix_tail,
                   pdev.prefix_len, pack.numpy())
    assert pdev.prefix_stats["wide_terms"] == len(wide)
    assert pdev.prefix_stats["bytes"] == len(wide) * CAP * 12


def test_own_rebuild_matches_reference(pair):
    """The port's rebuild from the journals: same pack length, layout,
    offsets and cuts; its ltf is torch's log (see _assert_region)."""
    jidx = pair[0]
    jdev = jidx.dev
    host = PHostIndex(jidx.host.idxdir)
    try:
        pdev = PDeviceIndex(host, "cpu")
        assert pdev.refresh()
        assert pdev.postings_pack.shape == tuple(jdev.postings_pack.shape)
        assert pdev.slice_t_cap == jdev.slice_t_cap
        assert pdev.adl_built == jdev.adl_built
        _assert_region(jdev, pdev.prefix_start_lookup, pdev.prefix_tail,
                       pdev.prefix_len, pdev.postings_pack.numpy(),
                       same_ltf=False)
    finally:
        host.close()


def _prefix_groups(jidx, sp, queries):
    jdev = jidx.dev
    plans = _build_plans(jdev, _prepare_many(jdev, jidx.pipeline,
                                             queries, sp), sp)
    groups: dict = {}
    for p in plans:
        if p is not None and p.pf and len(p.pf_tail):
            groups.setdefault((p.sl_T, p.n_run, len(p.pf_tail)),
                              []).append(p)
    assert groups
    return groups


def _assert_packed(want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert want.shape == got.shape
    np.testing.assert_array_equal(got[:, 2], want[:, 2])       # exact
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=TOL)
    for r in range(want.shape[0]):
        w, g, s = want[r, 1], got[r, 1], want[r, 0]
        i = 0
        while i < len(w):
            if w[i] != g[i]:
                assert (i + 1 < len(w) and g[i] == w[i + 1]
                        and g[i + 1] == w[i]
                        and abs(s[i] - s[i + 1]) <= TOL), (r, i, w, g)
                i += 1
            i += 1


@pytest.mark.parametrize("corpus,dead", [("z", False), ("z", True),
                                         ("c", False), ("c", True)])
def test_prefix_topk_wide_matches_reference(pair, corpus, dead):
    """The Zipf words' rows (uncertified, almost all) and the
    impact-hierarchy words' (certified)."""
    jidx = pair[0]
    jdev = jidx.dev
    queries = _queries(5, 80) if corpus == "z" else [
        "pad", "pad x", "x pad", "pad g01", "pad f03", "f01 x pad"]
    arrays = export_arrays(jdev)
    alive = np.asarray(jdev.alive_mask).copy()
    if dead:
        alive[::3] &= np.uint32(0x5F5F5F5F)       # every third word
        arrays["alive_mask"] = alive
    pdev = PDeviceIndex.from_arrays(jidx.host, arrays, "cpu")
    sp = SearchParams(limit=10, algo=0, fuzzymatch=True)
    n_exact = n_rows = 0
    assert pdev.prefix_tail is not None and (pdev.prefix_len > 0).any()
    for (T, n_run, R), members in _prefix_groups(jidx, sp,
                                                 queries).items():
        qs = max(len(p.sl_start) for p in members)
        n = len(members)
        sl = {f: np.zeros((n, qs), np.float32 if f == "sl_idf" else np.int32)
              for f in ("sl_start", "sl_len", "sl_idf", "pf_bits")}
        w = {f: np.zeros((n, R), np.float32 if f in ("pf_tail", "pf_idf")
                         else np.int32)
             for f in ("pf_tail", "pf_start", "pf_len", "pf_idf")}
        for row, p in enumerate(members):
            for f in sl:
                sl[f][row, : len(p.sl_start)] = getattr(p, f)
            for f in w:
                w[f][row] = getattr(p, f)
        buf = jexec.pack_prefix_group(*sl.values(), *w.values())
        kw = dict(qs=qs, R=R, T=T, k=16, M=psearch._prefix_m(sp, R),
                  algo=0, n_slots=jdev.n_slots, alive_all=not dead,
                  n_run=n_run, k_ret=10)
        want = jexec.device_search_prefix_packed(
            jdev.postings_pack, alive, buf, jdev.adl_dev, **kw)
        got = pexec.prefix_topk_packed(
            pdev.postings_pack, pdev.alive_mask, torch.from_numpy(buf),
            pdev.adl_dev, **kw)
        _assert_packed(want, got)
        n_exact += int((np.asarray(want)[:, 2, 0] > 0.5).sum())
        n_rows += n
    assert n_exact < n_rows if corpus == "z" else n_exact > 0


def _stats(*mods):
    return [{k: m.EXEC_STATS.get(k, 0) for k in COUNTERS} for m in mods]


def _clear():
    jsearch.EXEC_STATS.clear()
    psearch.EXEC_STATS.clear()


def assert_same(ref, got, query=""):
    ids_r = [d for d, _ in ref.results]
    ids_g = [d for d, _ in got.results]
    sc_r = [s for _, s in ref.results]
    assert len(ids_g) == len(ids_r), query
    np.testing.assert_allclose([s for _, s in got.results], sc_r, rtol=0,
                               atol=TOL, err_msg=query)
    i = 0
    while i < len(ids_g):
        if ids_g[i] != ids_r[i]:
            assert (i + 1 < len(ids_g) and ids_g[i] == ids_r[i + 1]
                    and ids_g[i + 1] == ids_r[i]
                    and abs(sc_r[i] - sc_r[i + 1]) <= TOL), \
                (query, i, ids_r, ids_g)
            i += 1
        i += 1


def _params(limit=10):
    return (nxsearch_tpu.Params().set_uint("limit", limit),
            nxsearch_tpu_torch.Params().set_uint("limit", limit))


@pytest.mark.parametrize("limit", [10, 100])
def test_search_many_matches_reference(pair, limit):
    jidx, pidx = pair
    jp, pp = _params(limit)
    queries = _queries(7)
    _clear()
    want = jidx.search_many(queries, jp)
    got = pidx.search_many(queries, pp)
    for q, r, g in zip(queries, want, got):
        assert_same(r, g, q)
    j, p = _stats(jsearch, psearch)
    assert j == p
    assert j["prefix"] > 0 and j["prefix_fallback"] > 0


def test_search_matches_reference(pair):
    """Index.search: an uncertified R > 0 row answers from its
    speculative sliced twin, fetched in the same copy."""
    jidx, pidx = pair
    jp, pp = _params()
    _clear()
    for q in _queries(8, 24):
        assert_same(jidx.search(q, jp), pidx.search(q, pp), q)
    j, p = _stats(jsearch, psearch)
    assert j == p
    assert j["prefix_spec_used"] > 0


def test_search_pipelined_matches_reference(pair):
    """search_pipelined: batch i-1's uncertified rows re-run as a
    deferred fallback sub-batch."""
    jidx, pidx = pair
    jp, pp = _params()
    queries = _queries(9, 60)
    batches = [queries[i: i + 20] for i in range(0, len(queries), 20)]
    _clear()
    want = jidx.search_pipelined(batches, jp)
    got = pidx.search_pipelined(batches, pp)
    for b_q, b_r, b_g in zip(batches, want, got):
        for q, r, g in zip(b_q, b_r, b_g):
            assert_same(r, g, q)
    j, p = _stats(jsearch, psearch)
    assert j == p
    assert j["prefix_fallback"] > 0


def test_certified_wide_row_matches_reference(pair):
    """The impact hierarchy of tests/test_prefix.py certifies "pad" in
    both packages, for search and search_many."""
    jidx, pidx = pair
    jp, pp = _params(5)
    for run in (lambda idx, sp: [idx.search("pad", sp)],
                lambda idx, sp: idx.search_many(["pad", "pad x"], sp)):
        _clear()
        want, got = run(jidx, jp), run(pidx, pp)
        for r, g in zip(want, got):
            assert_same(r, g)
        j, p = _stats(jsearch, psearch)
        assert j == p
        assert p["prefix_exact"] >= 1


def test_delta_matches_reference(pair):
    """A long document added after the snapshot moves adl off the
    impacts' adl: both packages stop planning prefix rows (or keep
    them, if adl held) and answer alike, delta document included."""
    jidx, pidx = pair
    rng = np.random.default_rng(3)
    words, _ = _words()
    jidx.add(90_001, " ".join(rng.choice(words, size=400)))
    jp, pp = _params()
    queries = _queries(10, 24)
    _clear()
    want = jidx.search_many(queries, jp) + [jidx.search(q, jp)
                                            for q in queries[:8]]
    got = pidx.search_many(queries, pp) + [pidx.search(q, pp)
                                           for q in queries[:8]]
    for q, r, g in zip(queries + queries[:8], want, got):
        assert_same(r, g, q)
    assert pidx.dev.has_delta
    j, p = _stats(jsearch, psearch)
    assert j == p
