"""Slice parity: BM25 batch search with fuzzy resolution through both
packages on one basedir.

The index is created with nxsearch_tpu (CPU) from bench.py's Zipf
generator, with a vocabulary above fuzzy._DEVICE_THRESHOLD so typo
resolution takes the device path (the Myers twin on the CPU), and
opened by nxsearch_tpu_torch on the CPU.  Small impact-prefix
thresholds give the little corpus wide terms, whose rows route to the
sliced executor and its dense-row hybrid as the 1M tier's do.

Boolean traffic: bench.py's mixed trace (make_mixed_queries: 25 %
AND / AND NOT rows, 5 % typos) plus AND / AND NOT / grouped / nested
queries over the dense-row terms, with the masked dense-row hybrid on
(the default: masked sliced rows) and off (the port's blockdense
executor, the reference's candidate executor on the CPU).

Checks: doc ids identical in order -- an adjacent swap is allowed only
where the reference's two scores differ by <= 1e-4, since ltf is an
f32 log on both sides and two libraries' log may differ by an ulp --
and scores within 1e-4; for search_many, search, search_pipelined and
after add + remove (the delta path).
"""

import numpy as np
import pytest

import bench
import nxsearch_tpu
import nxsearch_tpu.search as jsearch
import nxsearch_tpu_torch
from nxsearch_tpu.index.device import DeviceIndex as JDeviceIndex
from nxsearch_tpu_torch import search as psearch
from nxsearch_tpu_torch.fuzzy import _DEVICE_THRESHOLD
from nxsearch_tpu_torch.index.device import DeviceIndex as PDeviceIndex
from nxsearch_tpu_torch.ops import executor as pexec
from nxsearch_tpu_torch.ops import kernels

N_DOCS, VOCAB, MEAN_LEN = 3000, 6000, 20
TOL = 1e-4
_SMALL_PREFIX = {"PREFIX_CAP": 256, "WIDE_MIN_DF": 256}


def _vocab():
    ranks = np.arange(VOCAB, dtype=np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    return np.array([f"w{i:05d}" for i in range(VOCAB)]), probs


def _queries(seed, n_plain, n_fuzzy, salt):
    words, probs = _vocab()
    rng = np.random.default_rng(seed)
    return (bench.make_queries(n_plain, words, probs, rng)
            + bench.make_fuzzy_queries(n_fuzzy, words, probs, rng, salt))


def _mixed(seed, n_mixed, n_dense):
    """bench's mixed trace plus boolean queries over the heaviest
    (dense-row) terms: AND, AND NOT, grouped and nested."""
    words, probs = _vocab()
    rng = np.random.default_rng(seed)
    out = bench.make_mixed_queries(n_mixed, words, probs, rng)
    for _ in range(n_dense):
        h, h2 = (str(w) for w in words[rng.integers(0, 12, 2)])
        a, b, c = (str(w) for w in words[rng.choice(VOCAB, 3, p=probs)])
        out += [f"{h} AND {a}", f"{a} {b} AND NOT {h}",
                f"({h} OR {a}) AND {b}", f"{h} AND {h2}",
                f"(({a} OR {b}) AND NOT {c}) OR ({h} AND {b})"]
    return out


@pytest.fixture(params=[True, False], ids=["hybrid", "blockdense"])
def hybrid(request, monkeypatch):
    """NXS_MASKED_HYBRID in both packages: on, masked rows with dense
    terms take the sliced hybrid; off, the port's blockdense route."""
    monkeypatch.setattr(jsearch, "_MASKED_HYBRID", request.param)
    monkeypatch.setattr(psearch, "_MASKED_HYBRID", request.param)
    psearch.EXEC_STATS.clear()
    return request.param


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(reference index, port index) over one basedir; the reference
    handle is the writer."""
    mp = pytest.MonkeyPatch()
    for cls in (JDeviceIndex, PDeviceIndex):
        for name, value in _SMALL_PREFIX.items():
            mp.setattr(cls, name, value)
    basedir = str(tmp_path_factory.mktemp("slice"))
    jnxs = nxsearch_tpu.Nxs(basedir)
    jidx = jnxs.index_create("b")
    jidx.add_many(bench.zipf_range(0, N_DOCS, VOCAB, MEAN_LEN))
    pnxs = nxsearch_tpu_torch.Nxs(basedir, device="cpu")
    pidx = pnxs.index_open("b")
    yield jidx, pidx
    pnxs.close()
    jnxs.close()
    mp.undo()


def _params(pkg, limit=10):
    return pkg.Params().set_uint("limit", limit)


# The reference answers one result deeper than the port, so a near-tie
# swap across the port's last rank can be checked too.
REF = _params(nxsearch_tpu, 11)
PORT = _params(nxsearch_tpu_torch, 10)


def assert_same(ref, got, query=""):
    ids_r = [d for d, _ in ref.results]
    sc_r = [s for _, s in ref.results]
    ids_g = [d for d, _ in got.results]
    sc_g = [s for _, s in got.results]
    n = len(ids_g)
    assert n == min(len(ids_r), 10), query
    np.testing.assert_allclose(sc_g, sc_r[:n], rtol=0, atol=TOL,
                               err_msg=query)
    i = 0
    while i < n:
        if ids_g[i] != ids_r[i]:
            swap = (i + 1 < len(ids_r) and ids_g[i] == ids_r[i + 1]
                    and (i + 1 == n or ids_g[i + 1] == ids_r[i])
                    and abs(sc_r[i] - sc_r[i + 1]) <= TOL)
            assert swap, (query, i, ids_r, ids_g)
            i += 1
        i += 1


@pytest.fixture
def traced(monkeypatch):
    """Record the port's forward Myers twin runs (batched and
    single-query) and sliced group flags."""
    seen = {"myers": 0, "use_rows": 0}
    ref_sliced = pexec.sliced_topk_packed

    for name in ("myers_distances_ref", "myers_distances_one_ref"):
        def twin(*a, _fn=getattr(kernels, name), **kw):
            seen["myers"] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(kernels, name, twin)

    def sliced(*a, **kw):
        seen["use_rows"] += bool(kw.get("use_rows"))
        return ref_sliced(*a, **kw)

    monkeypatch.setattr(pexec, "sliced_topk_packed", sliced)
    psearch.EXEC_STATS.clear()
    return seen


def test_search_many_matches_reference(pair, traced):
    jidx, pidx = pair
    assert pidx.host.term_count >= _DEVICE_THRESHOLD
    queries = _queries(1, 120, 60, "x")
    want = jidx.search_many(queries, REF)
    got = pidx.search_many(queries, PORT)
    for q, r, g in zip(queries, want, got):
        assert_same(r, g, q)
    stats = psearch.EXEC_STATS
    assert stats.get("prefix", 0) > 0 and stats.get("sliced", 0) > 0
    assert traced["use_rows"] > 0
    assert traced["myers"] > 0
    assert sum(len(g.results) for g in got) > 0


def test_search_matches_reference(pair, traced):
    jidx, pidx = pair
    for q in _queries(2, 8, 4, "z"):
        assert_same(jidx.search(q, REF),
                    pidx.search(q, PORT), q)
    assert traced["myers"] > 0


def test_search_pipelined_matches_reference(pair):
    jidx, pidx = pair
    queries = _queries(3, 90, 30, "v")
    batches = [queries[i: i + 40] for i in range(0, len(queries), 40)]
    want = jidx.search_pipelined(batches, REF)
    got = pidx.search_pipelined(batches, PORT)
    assert len(got) == len(batches)
    for b_q, b_r, b_g in zip(batches, want, got):
        for q, r, g in zip(b_q, b_r, b_g):
            assert_same(r, g, q)


def test_fuzzy_rev_matches_reference(pair, monkeypatch):
    """NXS_FUZZY_REV=1's flag on in the port: typos resolved by the
    transposed sweep (its twin on the CPU), through search_many and
    search, answer like nxsearch_tpu; no forward sweep runs."""
    from nxsearch_tpu_torch import fuzzy as pfuzzy
    jidx, pidx = pair
    monkeypatch.setattr(pfuzzy, "_USE_REV_KERNEL", True)
    runs = {"fwd": 0, "rev": 0}
    for key, name in (("fwd", "myers_distances_ref"),
                      ("fwd", "myers_distances_one_ref"),
                      ("rev", "myers_rev_distances_ref")):
        def counted(*a, _fn=getattr(kernels, name), _key=key, **kw):
            runs[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(kernels, name, counted)
    queries = _queries(5, 40, 60, "r")
    want = jidx.search_many(queries, REF)
    got = pidx.search_many(queries, PORT)
    for q, r, g in zip(queries, want, got):
        assert_same(r, g, q)
    after_many = runs["rev"]
    for q in _queries(6, 4, 6, "s"):
        assert_same(jidx.search(q, REF), pidx.search(q, PORT), q)
    assert after_many > 0 and runs["rev"] > after_many
    assert runs["fwd"] == 0


def _assert_routes(hybrid):
    stats = psearch.EXEC_STATS
    assert stats.get("sliced", 0) > 0
    if hybrid:
        assert stats.get("blockdense", 0) == 0, stats
    else:
        assert stats.get("blockdense", 0) > 0, stats


def test_mixed_search_many_matches_reference(pair, hybrid):
    jidx, pidx = pair
    queries = _mixed(11, 300, 16)
    want = jidx.search_many(queries, REF)
    got = pidx.search_many(queries, PORT)
    for q, r, g in zip(queries, want, got):
        assert_same(r, g, q)
    _assert_routes(hybrid)
    assert sum(len(g.results) for g, q in zip(got, queries)
               if " AND " in q) > 0


def test_mixed_search_matches_reference(pair, hybrid):
    jidx, pidx = pair
    for q in _mixed(12, 30, 3):
        assert_same(jidx.search(q, REF), pidx.search(q, PORT), q)
    _assert_routes(hybrid)


def test_mixed_search_pipelined_matches_reference(pair, hybrid):
    jidx, pidx = pair
    queries = _mixed(13, 160, 8)
    batches = [queries[i: i + 50] for i in range(0, len(queries), 50)]
    want = jidx.search_pipelined(batches, REF)
    got = pidx.search_pipelined(batches, PORT)
    for b_q, b_r, b_g in zip(batches, want, got):
        for q, r, g in zip(b_q, b_r, b_g):
            assert_same(r, g, q)
    _assert_routes(hybrid)


def test_mixed_tfidf_matches_reference(pair, hybrid):
    """TF-IDF has no impact-prefix plans: every row takes the sliced or
    blockdense executors."""
    jidx, pidx = pair
    queries = _mixed(15, 60, 4)
    want = jidx.search_many(queries, _params(nxsearch_tpu, 11).set_str(
        "algo", "TF-IDF"))
    got = pidx.search_many(queries, _params(nxsearch_tpu_torch).set_str(
        "algo", "TF-IDF"))
    for q, r, g in zip(queries, want, got):
        assert_same(r, g, q)
    _assert_routes(hybrid)
    assert psearch.EXEC_STATS.get("prefix", 0) == 0


def test_delta_path_matches_reference(pair, monkeypatch):
    """Add, then remove, then re-search: both packages sync the
    journals; the port scores the delta on the host and masks the
    tombstoned base documents on the device.  Boolean queries too, on
    both masked routes."""
    jidx, pidx = pair
    jidx.add_many([(doc_id + 100_000, text) for doc_id, text in
                   bench.zipf_range(N_DOCS, N_DOCS + 200, VOCAB,
                                    MEAN_LEN)])
    for doc_id in range(3, N_DOCS, 11):
        jidx.remove(doc_id)
    jidx.remove(100_000 + N_DOCS + 5)
    queries = _queries(4, 80, 20, "u")
    want = jidx.search_many(queries, REF)
    got = pidx.search_many(queries, PORT)
    assert pidx.dev.has_delta and not pidx.dev.alive_all
    for q, r, g in zip(queries, want, got):
        assert_same(r, g, q)
    for q in queries[:6]:
        assert_same(jidx.search(q, REF),
                    pidx.search(q, PORT), q)
    mixed = _mixed(14, 120, 6)
    for on in (True, False):
        monkeypatch.setattr(jsearch, "_MASKED_HYBRID", on)
        monkeypatch.setattr(psearch, "_MASKED_HYBRID", on)
        want = jidx.search_many(mixed, REF)
        got = pidx.search_many(mixed, PORT)
        for q, r, g in zip(mixed, want, got):
            assert_same(r, g, q)
        for q in mixed[-5:]:
            assert_same(jidx.search(q, REF), pidx.search(q, PORT), q)
