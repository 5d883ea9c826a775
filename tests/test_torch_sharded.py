"""The doc-sharded mesh (nxsearch_tpu_torch.parallel) held to
nxsearch_tpu's.

The reference runs on the conftest's 8 virtual CPU devices
(``make_mesh(jax.devices())``), the port on ``[cpu] * 8``, both over
one basedir (the reference writes, both read; a mutation through
either is seen by both after their journal sync).  Twins of every test
of tests/test_sharded.py: the mesh against one device for the six
queries under BM25 and TF-IDF, mutation and limit, refresh without a
re-upload, the wide boolean query, the kernel body against the
candidate body (the segsum twin on the CPU), windowed planes, the head
term, prefix routing, a small-scale equivalence sweep and dense rows.
Beside them: each shard body (``sharded_search_prefix_batch``,
``sharded_search_sliced_batch``, ``sharded_search_batch`` with the
kernel, dense and candidate bodies) on the same inputs as its
reference twin, the snapshot arrays shard by shard, the route counters
of ``search_many`` / ``search_pipelined`` (the port's
``_sharded_kernel`` patched to the reference's CPU router, and as it
stands), the merge of global slots past 2**24 (the port's, the
batch's f32 fetch, and the reference's), ``dryrun_multichip`` and the
service over a mesh.

Checks: scores within 1e-4; ids in the reference's order up to
near-ties (``assert_same``: a document may stand only at a rank whose
reference score is within 1e-4 of its own; ROADMAP queue 3, expected
difference 1, which a group of three or more near-equal scores turns
into more than an adjacent swap).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import nxsearch_tpu
import nxsearch_tpu.search as jsearch
import nxsearch_tpu_torch
from nxsearch_tpu.index.device import DeviceIndex as JDeviceIndex
from nxsearch_tpu.parallel import make_mesh as jmake_mesh
from nxsearch_tpu.parallel import sharded as jsh
from nxsearch_tpu_torch import search as psearch
from nxsearch_tpu_torch.index.device import DeviceIndex as PDeviceIndex
from nxsearch_tpu_torch.parallel import dryrun_multichip, make_mesh
from nxsearch_tpu_torch.parallel import sharded as psh
from nxsearch_tpu_torch.query.parser import parse_query
from nxsearch_tpu_torch.query.prepare import prepare
from nxsearch_tpu_torch.utils.trace import ROUTE_COUNTERS

TOL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The shards' tensors are small: one intra-op thread runs them
    faster, and keeps doing so when the suite's workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

DOCS = [
    (1, "The quick brown fox jumped over the lazy dog"),
    (2, "Once upon a time there were three little foxes"),
    (3, "Dogs and cats living together in harmony"),
    (4, "A dog chasing a cat chasing a mouse"),
    (5, "Textbook about Erlang in Linux environment"),
    (6, "Unix Shell scripting textbook"),
    (7, "Erlang and Python examples"),
    (8, "Textbook about Python using Linux and Windows"),
    (9, "All but NOT: Textbook Erlang Python Shell Linux Unix Java"),
    (10, "All keywords: Textbook Erlang Python Shell Linux Unix"),
]

QUERIES = [
    "dog",
    "fox dog cat",
    "dog AND cat",
    "dog AND NOT cat",
    "textbook AND (Erlang OR Python OR Shell) AND "
    "(Linux OR Unix) AND NOT (Windows OR Java)",
    "nonexistentterm",
]


def routes(stats) -> dict:
    """The route counters (utils/trace.ROUTE_COUNTERS)."""
    return {k: v for k, v in stats.items() if k in ROUTE_COUNTERS}


def jparams(**kw):
    p = nxsearch_tpu.Params()
    for k, v in kw.items():
        p.set_uint(k, v) if isinstance(v, int) else p.set_str(k, v)
    return p


def pparams(**kw):
    p = nxsearch_tpu_torch.Params()
    for k, v in kw.items():
        p.set_uint(k, v) if isinstance(v, int) else p.set_str(k, v)
    return p


def assert_same(ref, got, query=""):
    """Scores within TOL, and the reference's order up to near-ties:
    each rank holds a document that the reference ranks where its score
    is within TOL of this rank's -- an adjacent swap in a pair, any
    order inside a group of near-equal scores (f32 sums may differ by
    an ulp between the packages, and between the reference's own batch
    and single-query paths), and at the limit's cut any document of the
    last such group."""
    ids_r = [d for d, _ in ref.results]
    ids_g = [d for d, _ in got.results]
    sc_r = [s for _, s in ref.results]
    assert len(ids_g) == len(ids_r), (query, ids_r, ids_g)
    np.testing.assert_allclose([s for _, s in got.results], sc_r, rtol=0,
                               atol=TOL, err_msg=str(query))
    rank_r = {d: i for i, d in enumerate(ids_r)}
    for i, d in enumerate(ids_g):
        j = rank_r.get(d)
        if j is None:
            assert abs(sc_r[i] - sc_r[-1]) <= TOL, (query, i, ids_r, ids_g)
        else:
            assert abs(sc_r[j] - sc_r[i]) <= TOL, (query, i, ids_r, ids_g)


def assert_same_set(ref, got, query=""):
    """The reference's rule between a mesh and one device, whose slots
    are length-ordered, so equal scores may swap at the limit's cut:
    the score lists agree within TOL, and so does every document both
    hold."""
    want, have = dict(ref.results), dict(got.results)
    assert len(have) == len(want), query
    np.testing.assert_allclose(sorted(have.values(), reverse=True),
                               sorted(want.values(), reverse=True),
                               rtol=0, atol=TOL, err_msg=str(query))
    for d in set(want) & set(have):
        assert have[d] == pytest.approx(want[d], abs=TOL), (query, d)


def open_trio(basedir, name, n_dev=8):
    """The reference's mesh index, the port's mesh index and the port's
    single-device index over one basedir (the index must exist)."""
    jnxs = nxsearch_tpu.Nxs(basedir, mesh=jmake_mesh(jax.devices()[:n_dev]))
    pnxs = nxsearch_tpu_torch.Nxs(basedir, mesh=[CPU] * n_dev)
    snxs = nxsearch_tpu_torch.Nxs(basedir, device="cpu")
    return ((jnxs, pnxs, snxs),
            (jnxs.index_open(name), pnxs.index_open(name),
             snxs.index_open(name)))


def close_all(handles):
    for nxs in handles:
        nxs.close()


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    basedir = str(tmp_path_factory.mktemp("mesh"))
    writer = nxsearch_tpu.Nxs(basedir)
    idx = writer.index_create("c")
    for doc_id, text in DOCS:
        idx.add(doc_id, text)
    writer.close()
    handles, trio = open_trio(basedir, "c")
    yield trio
    close_all(handles)


def test_port_mesh_is_eight_cpu_shards(corpora):
    _jidx, pidx, _sidx = corpora
    pidx.search("dog")
    assert pidx.dev.n_dev == 8 and pidx.dev.mesh == [CPU] * 8
    assert pidx.dev.device == CPU


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("algo", ["BM25", "TF-IDF"])
def test_mesh_matches_single_device(corpora, query, algo):
    jidx, pidx, sidx = corpora
    got = pidx.search(query, pparams(algo=algo))
    assert_same(jidx.search(query, jparams(algo=algo)), got, query)
    assert_same_set(sidx.search(query, pparams(algo=algo)), got, query)


def test_mesh_mutation_and_limit(corpora):
    jidx, pidx, _sidx = corpora
    resp = pidx.search("dog", pparams(limit=1))
    assert resp.count == 1
    pidx.add(100, "another dog appears")
    assert 100 in dict(pidx.search("dog").results)
    assert_same(jidx.search("dog"), pidx.search("dog"), "dog")
    pidx.remove(100)
    assert 100 not in dict(pidx.search("dog").results)
    assert_same(jidx.search("dog"), pidx.search("dog"), "dog")


def test_mesh_incremental_no_reupload(tmp_path):
    """Removals flip the alive bitmaps and additions stay in the host
    delta: the per-shard pack and columns keep their identity."""
    nxs = nxsearch_tpu_torch.Nxs(str(tmp_path), mesh=[CPU] * 8)
    idx = nxs.index_create("inc")
    for doc_id, text in DOCS:
        idx.add(doc_id, text)
    idx.search("dog")
    dev = idx.dev
    base = (dev.postings_pack, dev.postings_slot, dev.postings_ltf)
    tensors = [t for shards in base for t in shards]
    base_gen = dev.generation

    def unchanged():
        now = (dev.postings_pack, dev.postings_slot, dev.postings_ltf)
        return (all(a is b for a, b in zip(now, base))
                and all(a is b for a, b in zip(
                    [t for shards in now for t in shards], tensors)))

    idx.add(200, "incremental dog document")
    assert 200 in dict(idx.search("dog").results)
    assert unchanged() and dev.has_delta
    idx.remove(200)
    assert 200 not in dict(idx.search("dog").results)
    assert unchanged()
    idx.remove(2)
    assert 2 not in dict(idx.search("fox").results)
    assert unchanged() and not dev.alive_all
    assert dev.generation != base_gen
    nxs.close()


def test_mesh_wide_boolean_query(corpora):
    """> 32 unique terms with boolean operators: the per-shard dense
    body."""
    jidx, pidx, sidx = corpora
    words = " ".join(f"zz{i:02d}" for i in range(40))
    if pidx.host.doc_lookup(300) is None:
        pidx.add(300, words + " dog")
        pidx.add(301, words)
    q = "(" + words + ") AND NOT dog"
    psearch.EXEC_STATS.clear()
    got = pidx.search(q)
    assert routes(psearch.EXEC_STATS) == {"sharded_fallback": 1}
    assert 301 in dict(got.results) and 300 not in dict(got.results)
    assert_same(jidx.search(q), got, q)
    assert_same_set(sidx.search(q), got, q)


def _prepared_plan(idx, query, algo=0):
    """The port's plan of one query on its (refreshed) index, and the
    search params."""
    idx.host.sync()
    idx.dev.refresh()
    sp = psearch.get_search_params(algo, None)
    q = prepare(parse_query(query), idx.pipeline, idx.host.term_lookup,
                fuzzymatch=False)
    return psearch._build_plan(idx.dev, q, sp), sp


def _live(scores, slots):
    scores, slots = np.asarray(scores), np.asarray(slots)
    return {int(s): float(v) for v, s in zip(scores, slots) if v > 0}


def test_mesh_kernel_body_matches_candidate(corpora):
    """The blockdense body (the segsum twin per shard) equals the
    candidate body (test_batch_body_matches_reference holds both to the
    reference's bodies)."""
    _jidx, pidx, _sidx = corpora
    plan, sp = _prepared_plan(pidx, "dog AND NOT cat")
    dev = pidx.dev
    args = (dev.postings_slot, dev.postings_ltf, dev.doc_len,
            dev.alive_mask, plan.q_start[:, None, :],
            plan.q_len[:, None, :], plan.q_idf[None], dev.adl,
            plan.prog_ops[None], plan.prog_args[None])
    kw = dict(mesh=dev.mesh, budget=plan.budget, k=16, algo=sp.algo,
              use_mask=plan.use_mask, depth=plan.depth)
    ref_s, ref_sl = psh.sharded_search_batch(*args, **kw)
    got_s, got_sl = psh.sharded_search_batch(*args, use_kernel=True, **kw)
    ref = _live(ref_s[0], ref_sl[0])
    assert ref and _live(got_s[0], got_sl[0]) == pytest.approx(ref,
                                                              abs=TOL)


def _zipf_docs(seed, n_docs, n_words, mean):
    rng = np.random.default_rng(seed)
    words = [f"t{i:02d}" for i in range(n_words)]
    probs = 1.0 / (np.arange(n_words) + 2.0)
    probs /= probs.sum()
    return [(i + 1, " ".join(rng.choice(
        words, size=max(3, int(rng.poisson(mean))), p=probs)))
        for i in range(n_docs)]


def _build(tmp_path, name, docs):
    writer = nxsearch_tpu.Nxs(str(tmp_path))
    writer.index_create(name).add_many(docs)
    writer.close()
    return open_trio(str(tmp_path), name)


def _check_trio(trio, queries, limit, algos=("BM25",)):
    jidx, pidx, sidx = trio
    for algo in algos:
        for q in queries:
            got = pidx.search(q, pparams(limit=limit, algo=algo))
            assert_same(jidx.search(q, jparams(limit=limit, algo=algo)),
                        got, (q, algo))
            assert_same_set(sidx.search(q, pparams(limit=limit,
                                                   algo=algo)), got, q)
    want = jidx.search_many(queries, jparams(limit=limit))
    for q, w, g in zip(queries, want, pidx.search_many(
            queries, pparams(limit=limit))):
        assert_same(w, g, q)


def test_mesh_windowed_planes(tmp_path, monkeypatch):
    """A window width of 4: every term splits into several columns per
    shard (ragged per-shard window counts padded with zero-length
    columns), masked and unmasked, sequential and batched, and after a
    removal."""
    monkeypatch.setattr(jsearch, "_WINDOW_T", 4)
    monkeypatch.setattr(psearch, "_WINDOW_T", 4)
    handles, trio = _build(tmp_path, "w", _zipf_docs(11, 120, 40, 12))
    queries = ["t00", "t00 t07", "t00 t05 t11", "t01 AND t03",
               "t00 AND NOT t04", "(t02 OR t06) AND t01"]
    try:
        psearch.EXEC_STATS.clear()
        _check_trio(trio, queries, 60, ("BM25", "TF-IDF"))
        assert psearch.EXEC_STATS.get("sharded_sliced", 0) > 0
        trio[1].remove(1)
        _check_trio(trio, ["t00", "t00 AND NOT t04"], 60)
    finally:
        close_all(handles)


def test_mesh_head_term(tmp_path, monkeypatch):
    """Lowered head thresholds: the heaviest term leaves each shard's
    sort plane (per-shard head ranges, shard-local merge)."""
    for mod in (jsearch, psearch):
        monkeypatch.setattr(mod, "_HEAD_MIN_DF", 16)
        monkeypatch.setattr(mod, "_HEAD_MIN_DF_PAIR", 16)
    handles, trio = _build(tmp_path, "h", _zipf_docs(5, 300, 50, 15))
    queries = ["t00 t30", "t00 t10 t20 t31", "t00 AND t12",
               "t25 AND NOT t00", "(t00 OR t33) AND t02"]
    try:
        _check_trio(trio, queries, 400, ("BM25", "TF-IDF"))
        plan, _sp = _prepared_plan(trio[1], "t00 t10 t20 t31", algo=1)
        assert plan.h_T > 0
    finally:
        close_all(handles)


def test_mesh_prefix_routing(corpora):
    """Pure-OR BM25 queries take the R = 0 impact-prefix body on every
    shard, one at a time and batched."""
    jidx, pidx, _sidx = corpora
    queries = ["dog", "fox dog cat", "textbook erlang python"]
    psearch.EXEC_STATS.clear()
    for q in queries:
        assert_same(jidx.search(q), pidx.search(q), q)
    assert psearch.EXEC_STATS.get("sharded_prefix", 0) == len(queries)
    psearch.EXEC_STATS.clear()
    for q, w, g in zip(queries, jidx.search_many(queries),
                       pidx.search_many(queries)):
        assert_same(w, g, q)
    assert psearch.EXEC_STATS.get("sharded_prefix", 0) == len(queries)


def _vocab(n):
    ranks = np.arange(n, dtype=np.float64)
    probs = 1.0 / (ranks + 10.0)
    return np.array([f"w{i:04d}" for i in range(n)]), probs / probs.sum()


def _sweep_queries(rng, words, probs, n):
    """Plain, AND, AND NOT and typo rows (the reference's mid-scale
    sweep mix)."""
    qp = probs ** 0.35
    qp /= qp.sum()
    out = []
    for j in range(n):
        toks = [str(words[i]) for i in rng.choice(
            len(words), size=int(rng.integers(2, 5)), p=qp)]
        r = j % 8
        if r == 5:
            out.append(f"{toks[0]} AND {' '.join(toks[1:])}")
        elif r == 6:
            out.append(f"{' '.join(toks[:-1])} AND NOT {toks[-1]}")
        elif r == 7:
            out.append("x" + toks[0][1:] + " " + toks[-1])
        else:
            out.append(" ".join(toks))
    return out


def test_mesh_small_scale_equivalence(tmp_path, monkeypatch):
    """The reference's mid-scale sweep at 2000 documents: a window width
    of 64 so mid-df terms split, plain, boolean and typo rows, through
    search_many and search."""
    monkeypatch.setattr(jsearch, "_WINDOW_T", 64)
    monkeypatch.setattr(psearch, "_WINDOW_T", 64)
    rng = np.random.default_rng(23)
    words, probs = _vocab(800)
    lens = rng.poisson(10, 2000).clip(3, None)
    ids = rng.choice(len(words), size=int(lens.sum()), p=probs)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    docs = [(i + 1, " ".join(words[ids[bounds[i]: bounds[i + 1]]]))
            for i in range(len(lens))]
    handles, (jidx, pidx, sidx) = _build(tmp_path, "mid", docs)
    queries = _sweep_queries(rng, words, probs, 64)
    try:
        psearch.EXEC_STATS.clear()
        got = pidx.search_many(queries, pparams(limit=20))
        assert psearch.EXEC_STATS.get("sharded_prefix", 0) > 0
        for q, w, g in zip(queries, jidx.search_many(
                queries, jparams(limit=20)), got):
            assert_same(w, g, q)
        for q, s, g in zip(queries, sidx.search_many(
                queries, pparams(limit=20)), got):
            assert_same_set(s, g, q)
        for q in queries[:8]:
            assert_same(jidx.search(q, jparams(limit=20)),
                        pidx.search(q, pparams(limit=20)), q)
    finally:
        close_all(handles)


def test_mesh_dense_rows(tmp_path, monkeypatch):
    """Heavy terms (global df over the threshold) get per-shard dense
    rows: pure-OR queries with them run the dense-row hybrid per shard,
    masked ones route away from it; batched and after removals."""
    monkeypatch.setattr(JDeviceIndex, "DENSE_DF_DIV", 1024)
    monkeypatch.setattr(PDeviceIndex, "DENSE_DF_DIV", 1024)
    handles, trio = _build(tmp_path, "d", _zipf_docs(17, 250, 30, 10))
    jidx, pidx, _sidx = trio
    queries = ["t00", "t00 t01 t19", "t00 t01", "t00 AND t05",
               "t07 AND NOT t00"]
    try:
        pidx.search("t00")
        assert pidx.dev.dense_row_of
        psearch.EXEC_STATS.clear()
        _check_trio(trio, queries, 300, ("BM25", "TF-IDF"))
        assert psearch.EXEC_STATS.get("sharded_sliced", 0) > 0
        for doc_id in range(5, 250, 13):
            pidx.remove(doc_id)
        _check_trio(trio, ["t00 t02", "t00 AND t03"], 300)
    finally:
        close_all(handles)


def test_mesh_plain_rows_pad_under_their_cap(tmp_path, monkeypatch):
    """A mesh's candidate and dense groups pad their rows no further than
    the group's row cap, as on one device (the fallback body serves
    every row here): with the blockdense cap at
    two shards' worth of slots (a cap of 2 rows, as a shard of 2**25
    slots has under the real cap) no call of the shard body gets more
    than 2 rows, where the grid's floor of 8 padded them to 4x the cap;
    the answers equal the reference's and the single device's."""
    handles, trio = _build(tmp_path, "p", _zipf_docs(19, 250, 40, 12))
    jidx, pidx, _sidx = trio
    words = [f"t{i:02d}" for i in range(40)]
    queries = ["t00 t03", "t05 AND t01", "t02 t07 AND NOT t00",
               "(" + " OR ".join(words[:36]) + ") AND NOT t39",
               "t11 t12 t13"]
    try:
        pidx.search("t00")
        cap = 2
        monkeypatch.setattr(psearch, "_BD_ELEMS_CAP",
                            cap * pidx.dev.slots_per_shard)
        for name in ("_prefix_mode_sharded", "_sharded_sliced",
                     "_sharded_kernel"):
            monkeypatch.setattr(psearch, name, lambda *a, **kw: False)
        rows, bodies = [], []
        batch = psh.sharded_search_batch

        def spy(*a, **kw):
            rows.append(a[4].shape[1])            # q_start [n_dev, N, Q]
            bodies.append(kw["use_dense"])
            return batch(*a, **kw)

        monkeypatch.setattr(psh, "sharded_search_batch", spy)
        psearch.EXEC_STATS.clear()
        got = pidx.search_many(queries, pparams(limit=20))
        assert routes(psearch.EXEC_STATS) == \
            {"sharded_fallback": len(queries)}
        assert True in bodies                     # the dense body
        assert rows and max(rows) <= cap, rows
        for q, g in zip(queries, got):
            assert_same(jidx.search(q, jparams(limit=20)), g, q)
    finally:
        close_all(handles)


# -- the shard bodies on the same inputs as their reference twins ------

@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """A 600-document Zipf index over 400 words whose 40-odd heaviest
    terms have dense rows, opened as a reference mesh, a port mesh and
    a port device; snapshots built."""
    basedir = tmp_path_factory.mktemp("units")
    saved = (JDeviceIndex.DENSE_DF_DIV, PDeviceIndex.DENSE_DF_DIV)
    JDeviceIndex.DENSE_DF_DIV = PDeviceIndex.DENSE_DF_DIV = 256
    try:
        handles, trio = _build(basedir, "u", _zipf_docs(3, 600, 400, 12))
        for idx in trio:
            idx.search("t00")
    finally:
        JDeviceIndex.DENSE_DF_DIV, PDeviceIndex.DENSE_DF_DIV = saved
    yield trio
    close_all(handles)


def _plans(idx, queries, algo):
    sp = psearch.get_search_params(algo, None)
    out = []
    for q in queries:
        query = prepare(parse_query(q), idx.pipeline, idx.host.term_lookup,
                        fuzzymatch=False)
        out.append(psearch._build_plan(idx.dev, query, sp))
    return out


def _rows_equal(j_out, p_out, n_rows):
    j_s, j_sl = (np.asarray(a) for a in j_out)
    p_s, p_sl = p_out[0].numpy(), p_out[1].numpy()
    assert p_s.shape == j_s.shape and p_sl.dtype == np.int32
    np.testing.assert_allclose(p_s, j_s, rtol=0, atol=TOL)
    for r in range(n_rows):
        live = j_s[r] > 0
        assert (p_s[r] > 0).tolist() == live.tolist()
        ids_j, ids_p, sc = j_sl[r][live], p_sl[r][live], j_s[r][live]
        for i in np.nonzero(ids_j != ids_p)[0]:
            # An adjacent swap of near-equal scores only.
            j = i + 1 if i + 1 < len(ids_j) and ids_p[i] == ids_j[i + 1] \
                else i - 1
            assert ids_p[i] == ids_j[j] and abs(sc[i] - sc[j]) <= TOL


def _groups(plans, dev) -> dict:
    """The plans by their dispatch group (search._group_key)."""
    out = {}
    for p in plans:
        out.setdefault(psearch._group_key(p, dev), []).append(p)
    return out


def test_prefix_body_matches_reference(units):
    jidx, pidx, _ = units
    jdev, pdev = jidx.dev, pidx.dev
    plans = _plans(pidx, ["t100 t120", "t103 t130 t141", "t105",
                          "t159 t158 t302", "t200 t201 t202 t203"], 0)
    groups = _groups(plans, pdev)
    assert all(key[0] == "spf" for key in groups)
    for (_, qs, T, _r, n_run), group in groups.items():
        n = len(group)
        st = np.zeros((pdev.n_dev, n, qs), np.int32)
        ln = np.zeros((pdev.n_dev, n, qs), np.int32)
        idf = np.zeros((n, qs), np.float32)
        for r, p in enumerate(group):
            st[:, r], ln[:, r], idf[r] = p.sl_start, p.sl_len, p.sl_idf
        kw = dict(T=T, k=16, algo=0, alive_all=True, n_run=n_run,
                  k_ret=10)
        want = jsh.sharded_search_prefix_batch(
            jdev.postings_pack, jdev.alive_mask, jnp.asarray(st),
            jnp.asarray(ln), jnp.asarray(idf), jnp.float32(jdev.adl),
            mesh=jdev.mesh, **kw)
        got = psh.sharded_search_prefix_batch(
            pdev.postings_pack, pdev.alive_mask, st, ln, idf, pdev.adl,
            mesh=pdev.mesh, **kw)
        _rows_equal(want, got, n)


@pytest.mark.parametrize("algo", [0, 1])
def test_sliced_body_matches_reference(units, algo):
    """Masked windowed plans, and pure-OR plans with dense-row terms
    (the hybrid), through sharded_search_sliced_batch, one call per
    dispatch group."""
    jidx, pidx, _ = units
    jdev, pdev = jidx.dev, pidx.dev
    heavy = pidx.host.term_values[min(pdev.dense_row_of) - 1]
    plans = _plans(pidx, ["t110 AND t120", "t111 AND NOT t121",
                          "(t112 OR t122) AND t103", f"{heavy} t114",
                          f"t115 {heavy} t125", f"t116 t117 {heavy}"], algo)
    groups = _groups(plans, pdev)
    assert all(key[0] == "ssl" for key in groups)
    assert any(key[4] for key in groups) and any(key[9] for key in groups)
    for key, group in groups.items():
        p0 = group[0]

        def stack(field):
            return np.stack([getattr(p, field) for p in group])

        st = np.stack([p.sl_start for p in group], axis=1)
        ln = np.stack([p.sl_len for p in group], axis=1)
        arrs = [stack(f) for f in ("sl_idf", "prog_ops", "prog_args")]
        kw = dict(T=p0.sl_T, k=16, algo=algo, use_mask=p0.use_mask,
                  single=p0.single, alive_all=pdev.alive_all,
                  depth=p0.depth, n_run=p0.n_run, T_head=0,
                  use_rows=p0.use_rows)
        p_kw = {}
        if p0.use_mask:
            p_kw["sl_rows"] = stack("sl_rows")
        if p0.use_rows:
            p_kw.update(d_row=stack("d_row"), d_idf=stack("d_idf"))
        j_kw = {k: jnp.asarray(v) for k, v in p_kw.items()}
        if p0.use_rows:
            p_kw["dense_rows"] = pdev.dense_rows
            j_kw["dense_rows"] = jdev.dense_rows
        want = jsh.sharded_search_sliced_batch(
            jdev.postings_pack, jdev.alive_mask, jdev.doc_len,
            jnp.asarray(st), jnp.asarray(ln), jnp.asarray(arrs[0]),
            jnp.float32(jdev.adl), jnp.asarray(arrs[1]),
            jnp.asarray(arrs[2]), mesh=jdev.mesh, **kw, **j_kw)
        got = psh.sharded_search_sliced_batch(
            pdev.postings_pack, pdev.alive_mask, pdev.doc_len, st, ln,
            arrs[0], pdev.adl, arrs[1], arrs[2], mesh=pdev.mesh, **kw,
            **p_kw)
        _rows_equal(want, got, len(group))


@pytest.mark.parametrize("body", ["kernel", "dense", "candidate"])
def test_batch_body_matches_reference(units, body):
    jidx, pidx, _ = units
    jdev, pdev = jidx.dev, pidx.dev
    queries = ["t10 AND t20", "t11 t140 AND NOT t21", "t00 AND t300",
               "(t12 OR t122) AND NOT t13"]
    plans = _plans(pidx, queries, 0)
    budget = max(p.budget for p in plans)
    q_pad = max(p.q_start.shape[-1] for p in plans)
    L = max(len(p.prog_ops) for p in plans)
    n = len(plans)
    st = np.zeros((pdev.n_dev, n, q_pad), np.int32)
    ln = np.zeros((pdev.n_dev, n, q_pad), np.int32)
    idf = np.zeros((n, q_pad), np.float32)
    ops = np.zeros((n, L), np.int32)
    args = np.zeros((n, L), np.int32)
    for r, p in enumerate(plans):
        w, lp = p.q_start.shape[-1], len(p.prog_ops)
        st[:, r, :w], ln[:, r, :w], idf[r, :w] = p.q_start, p.q_len, p.q_idf
        ops[r, :lp], args[r, :lp] = p.prog_ops, p.prog_args
    kw = dict(budget=budget, k=16, algo=0, use_mask=True, depth=8,
              use_kernel=body == "kernel", use_dense=body == "dense")
    want = jsh.sharded_search_batch(
        jdev.postings_slot, jdev.postings_ltf, jdev.doc_len,
        jdev.alive_mask, jnp.asarray(st), jnp.asarray(ln),
        jnp.asarray(idf), jnp.float32(jdev.adl), jnp.asarray(ops),
        jnp.asarray(args), mesh=jdev.mesh, interpret=True, **kw)
    got = psh.sharded_search_batch(
        pdev.postings_slot, pdev.postings_ltf, pdev.doc_len,
        pdev.alive_mask, st, ln, idf, pdev.adl, ops, args, mesh=pdev.mesh,
        **kw)
    _rows_equal(want, got, n)


def test_snapshot_arrays_equal_reference(units):
    jidx, pidx, _ = units
    jdev, pdev = jidx.dev, pidx.dev
    assert (pdev.n_slots, pdev.slots_per_shard, pdev.base_nterms) == \
        (jdev.n_slots, jdev.slots_per_shard, jdev.base_nterms)
    np.testing.assert_array_equal(pdev.shard_starts, jdev.shard_starts)
    assert pdev.dense_row_of == jdev.dense_row_of and pdev.dense_row_of
    np.testing.assert_array_equal(pdev.dense_row_lookup,
                                  jdev.dense_row_lookup)
    assert pdev.slice_t_cap == jdev.slice_t_cap
    for name in ("postings_slot", "postings_ltf", "postings_pack",
                 "doc_len", "alive_mask", "dense_rows"):
        want = np.asarray(getattr(jdev, name))
        got = np.stack([t.numpy() for t in getattr(pdev, name)])
        if name == "alive_mask":
            want = want.view(np.int32)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# -- counters, the merge, the entry points ----------------------------

@pytest.fixture(params=[False, True], ids=["cpu_router", "as_is"])
def router(request, monkeypatch):
    """The port's mesh router patched to the reference's CPU routing
    (no kernel body), or as it stands."""
    if not request.param:
        monkeypatch.setattr(psearch, "_sharded_kernel",
                            lambda *a, **kw: False)
    jsearch.EXEC_STATS.clear()
    psearch.EXEC_STATS.clear()
    return request.param


def _mixed_set(idx):
    """bench's mixed trace over the units vocabulary, boolean rows over a
    dense-row term and one > 32-term masked row."""
    words = np.array([f"t{i:02d}" for i in range(400)])
    probs = 1.0 / (np.arange(400) + 2.0)
    rng = np.random.default_rng(29)
    heavy = idx.host.term_values[min(idx.dev.dense_row_of) - 1]
    out = bench.make_mixed_queries(40, words, probs / probs.sum(), rng)
    out += [f"{heavy} AND t131", f"t132 {heavy}",
            f"t133 t134 AND NOT {heavy}",
            "(" + " ".join(words[100:140]) + ") AND NOT t59"]
    return out


def test_counters_equal_reference(units, router):
    jidx, pidx, _ = units
    queries = _mixed_set(pidx)
    batches = [queries[i: i + 16] for i in range(0, len(queries), 16)]
    for q, w, g in zip(queries, jidx.search_many(queries),
                       pidx.search_many(queries)):
        assert_same(w, g, q)
    want = jidx.search_pipelined(batches)
    got = pidx.search_pipelined(batches)
    for b_q, b_w, b_g in zip(batches, want, got):
        for q, w, g in zip(b_q, b_w, b_g):
            assert_same(w, g, q)
    j, p = dict(jsearch.EXEC_STATS), routes(psearch.EXEC_STATS)
    for key in ("sharded_prefix", "sharded_sliced", "sharded_fallback"):
        assert j.get(key, 0) > 0, (key, j)
    assert p == j


def test_merge_carries_global_slots_past_2_24():
    """Per-shard results whose global slots pass 2**24 come out of the
    merge exactly, ties in shard order, and survive the batch's f32
    fetch bit for bit."""
    ss = 1 << 23
    mesh = [CPU] * 4
    rng = np.random.default_rng(0)
    scores = rng.integers(1, 6, (4, 3, 5)).astype(np.float32)
    scores[2, 0, :] = 0.0                      # a dead shard row
    local = np.stack([np.sort(rng.choice(ss, 5, replace=False))
                      for _ in range(12)]).reshape(4, 3, 5)
    local[3, 1, 0] = ss - 1                    # the last slot of all
    parts = [(torch.from_numpy(scores[d]), torch.from_numpy(local[d]))
             for d in range(4)]
    m_s, m_sl = psh.merge_topk(parts, mesh, ss, 8)
    assert m_sl.dtype == torch.int32
    flat_s = np.concatenate(list(scores), axis=1)
    flat_sl = np.concatenate([local[d] + d * ss for d in range(4)], axis=1)
    for r in range(3):
        order = np.argsort(-flat_s[r], kind="stable")[:8]
        np.testing.assert_array_equal(m_s[r].numpy(), flat_s[r][order])
        np.testing.assert_array_equal(m_sl[r].numpy(), flat_sl[r][order])
    assert int(m_sl.max()) > (1 << 24) + 1
    fetched = psearch._fetch_finish(psearch._fetch_start(
        [psearch._pack_bits(m_s, m_sl)]))[0]
    got_s, got_sl = psearch.unpack_bits(fetched)
    np.testing.assert_array_equal(got_s, m_s.numpy())
    np.testing.assert_array_equal(got_sl, m_sl.numpy())


def test_reference_merge_past_2_24_matches_port():
    """sharded_search_batch of both packages on two shards of 2**24
    slots: postings near the end of shard 1 give global slots past
    2**24 + 2**23, equal in both and exact."""
    ss = 1 << 24
    n_post = 4096
    pslot = np.zeros((2, n_post), np.int32)
    pltf = np.zeros((2, n_post), np.float32)
    pslot[:, :6] = [[3, 9, 11, 12, 20, 31], [ss - 9, ss - 7, ss - 5,
                                             ss - 3, ss - 2, ss - 1]]
    pltf[:, :6] = np.log(np.arange(2, 8, dtype=np.float64))
    dlen = np.ones((2, ss), np.float32)
    alive = np.full((2, ss // 32), -1, np.int32)
    q_start = np.zeros((2, 1, 8), np.int32)
    q_len = np.zeros((2, 1, 8), np.int32)
    q_len[:, 0, 0] = 6
    idf = np.zeros((1, 8), np.float32)
    idf[0, 0] = 1.5
    ops = np.zeros((1, 1), np.int32)
    kw = dict(budget=1024, k=16, algo=0, use_mask=False, depth=4)
    jmesh = jmake_mesh(jax.devices()[:2])
    j_s, j_sl = jsh.sharded_search_batch(
        *(jnp.asarray(a) for a in (pslot, pltf, dlen, alive.view(np.uint32),
                                    q_start, q_len, idf)),
        jnp.float32(10.0), jnp.asarray(ops), jnp.asarray(ops), mesh=jmesh,
        **kw)
    cols = [tuple(torch.from_numpy(a[d]) for d in range(2))
            for a in (pslot, pltf, dlen, alive)]
    p_s, p_sl = psh.sharded_search_batch(*cols, q_start, q_len, idf, 10.0,
                                         ops, ops, mesh=[CPU] * 2, **kw)
    live = np.asarray(j_s[0]) > 0
    assert live.sum() == 12
    np.testing.assert_array_equal(p_sl[0].numpy()[live],
                                  np.asarray(j_sl[0])[live])
    np.testing.assert_allclose(p_s[0].numpy(), np.asarray(j_s[0]),
                               atol=TOL)
    assert set(p_sl[0].numpy()[live]) >= {ss + ss - 1, ss + ss - 9}


def test_dryrun_multichip():
    dryrun_multichip(8)


def test_make_mesh_and_device_checks(tmp_path, monkeypatch):
    assert make_mesh(["cpu", CPU]) == [CPU, CPU]
    with pytest.raises(ValueError, match="mesh's first device"):
        nxsearch_tpu_torch.Nxs(str(tmp_path), device="meta", mesh=[CPU])
    nxs = nxsearch_tpu_torch.Nxs(str(tmp_path), device="cpu", mesh=[CPU])
    assert nxs.device == CPU and nxs.mesh == [CPU]
    nxs.close()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_service_over_a_mesh(tmp_path):
    """SearchService(basedir, mesh=[cpu] * 4) answers a request sequence
    as the reference's service over a 4-device mesh."""
    from nxsearch_tpu.service.app import SearchService as JService
    from nxsearch_tpu_torch.service.app import SearchService as PService

    jsvc = JService(str(tmp_path / "j"), mesh=jmake_mesh(jax.devices()[:4]))
    psvc = PService(str(tmp_path / "p"), mesh=[CPU] * 4)
    try:
        steps = [("POST", "/m", b"")]
        steps += [("POST", f"/m/add/{d}", t.encode()) for d, t in DOCS]
        steps += [("POST", "/m/search", q.encode()) for q in QUERIES]
        steps += [("POST", "/m/search", b"dgo"),
                  ("POST", "/m/search_batch",
                   json.dumps(["fox", "dog AND cat"]).encode()),
                  ("DELETE", "/m/remove/4", b""),
                  ("POST", "/m/search", b"dog cat")]
        for method, path, body in steps:
            js, jb = jsvc.handle(method, path, {}, body)
            ps, pb = psvc.handle(method, path, {}, body)
            assert ps == js, (path, pb, jb)
            if isinstance(jb, dict) and "results" in jb:
                assert [r["doc_id"] for r in pb["results"]] == \
                    [r["doc_id"] for r in jb["results"]], path
                np.testing.assert_allclose(
                    [r["score"] for r in pb["results"]],
                    [r["score"] for r in jb["results"]], atol=TOL)
        assert psvc.nxs.mesh == [CPU] * 4
    finally:
        jsvc.close()
        psvc.close()
