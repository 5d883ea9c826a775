"""Candidate and dense executors: the port held to nxsearch_tpu.

Unit parity on inputs made from a numpy seed: ``flatten_ranges``,
``build_term_masks``, ``eval_program`` (random AND / OR / AND NOT
programs with empty leaves, stack depths 4-8), ``candidate_topk``
through ``device_search_batch`` / ``device_search`` and ``dense_topk``
through ``device_search_dense_batch`` / ``device_search_dense`` over a
synthetic slot-sorted CSR: BM25 and TF-IDF, the program on and off,
dead slots in the alive mask, zero-length ranges, a budget above the
postings total, and 33-64 terms on the dense executor.  Slots equal;
scores within 1e-4; an adjacent swap only where the reference's two
scores differ by <= 1e-4 (ltf and the sums are f32 on both sides).

Search parity on one basedir (the reference writes, the port reads on
the CPU): plain, mixed and > 32-term masked queries through
``search_many``, ``search`` and ``search_pipelined``.  With the port's
``_use_blockdense`` patched to False its router is the reference's CPU
router, so the ``candidate`` / ``dense`` counters must equal the
reference's; as it stands the port sends the bd-eligible plans to the
blockdense executor instead, and the > 32-term masked rows to dense.
"""


import numpy as np
import pytest
import torch

import bench
import large_slots_corpus
import nxsearch_tpu
import nxsearch_tpu.search as jsearch
import nxsearch_tpu_torch
from nxsearch_tpu.ops import boolean as jbool
from nxsearch_tpu.ops import executor as jexec
from nxsearch_tpu.ops import scoring as jscoring
from nxsearch_tpu_torch import search as psearch
from nxsearch_tpu_torch.ops import boolean as pbool
from nxsearch_tpu_torch.ops import executor as pexec
from nxsearch_tpu_torch.ops import scoring as pscoring

TOL = 1e-4
N_SLOTS = 4096
K = 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ranges(rng, n_rows, n_terms, lens_pool, starts_pool, p_zero=0.2):
    """[n_rows, n_terms] (start, len) picks from a CSR's terms, some
    columns zero-length."""
    pick = np.stack([rng.choice(len(lens_pool), n_terms, replace=False)
                     for _ in range(n_rows)])
    q_start = starts_pool[pick].astype(np.int32)
    q_len = lens_pool[pick].astype(np.int32)
    q_len[rng.random(q_len.shape) < p_zero] = 0
    return q_start, q_len


@pytest.mark.parametrize("seed", range(4))
def test_flatten_ranges_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n, q = 6, 8 + 8 * seed
    q_start = rng.integers(0, 5000, (n, q)).astype(np.int32)
    q_len = rng.integers(0, 40, (n, q)).astype(np.int32)
    q_len[rng.random((n, q)) < 0.3] = 0
    q_len[0] = 0                                   # an all-empty row
    q_len[1, :3] = 0                               # leading empty ranges
    budget = int(q_len.sum(axis=1).max()) + 64     # budget > every total
    src, qid, valid = pscoring.flatten_ranges(_t(q_start), _t(q_len),
                                              budget)
    for r in range(n):
        w_src, w_qid, w_valid = (np.asarray(a) for a in
                                 jscoring.flatten_ranges(
                                     q_start[r], q_len[r], budget))
        np.testing.assert_array_equal(valid[r].numpy(), w_valid)
        np.testing.assert_array_equal(qid[r].numpy(), w_qid)
        np.testing.assert_array_equal(src[r].numpy(), w_src)
    # One row without the batch axis.
    s1, q1, v1 = pscoring.flatten_ranges(_t(q_start[2]), _t(q_len[2]),
                                         budget)
    assert torch.equal(s1, src[2]) and torch.equal(q1, qid[2])


@pytest.mark.parametrize("n_terms", [8, 33, 64])
def test_build_term_masks_matches_reference(n_terms):
    rng = np.random.default_rng(n_terms)
    n, budget, n_words = 3, 512, N_SLOTS // 32
    slot = rng.integers(0, N_SLOTS, (n, budget)).astype(np.int32)
    qid = rng.integers(0, n_terms, (n, budget)).astype(np.int32)
    valid = rng.random((n, budget)) < 0.8
    # Distinct (term, slot) pairs, as in the postings; bit 31 included.
    for r in range(n):
        _, first = np.unique(qid[r].astype(np.int64) * N_SLOTS + slot[r],
                             return_index=True)
        dup = np.ones(budget, bool)
        dup[first] = False
        valid[r, dup] = False
    slot[0, 0], qid[0, 0], valid[0, 0] = 31, 0, True
    got = pbool.build_term_masks(_t(slot), _t(qid), _t(valid),
                                 n_terms=n_terms, n_words=n_words)
    for r in range(n):
        want = np.asarray(jbool.build_term_masks(
            slot[r], qid[r], valid[r], n_terms=n_terms, n_words=n_words))
        np.testing.assert_array_equal(got[r].numpy(), want.view(np.int32))
    assert (got[0, 0, 0] < 0).item()               # bit 31: the sign bit


def _random_program(rng, n_terms, empty, max_depth, length):
    """A random AND / OR / AND NOT tree over term rows (an empty leaf
    ``empty`` one time in eight) as a postfix program of at most
    ``length`` ops whose evaluation stack stays within ``max_depth``
    (right-leaning trees, so deep stacks occur)."""
    def tree(height):
        if height <= 1 or rng.random() < 0.15:
            leaf = empty if rng.random() < 0.125 else \
                int(rng.integers(0, n_terms))
            return [(pbool.OP_PUSH, leaf)]
        op = int(rng.choice([pbool.OP_AND, pbool.OP_OR, pbool.OP_ANDNOT]))
        left = tree(height - 1) if rng.random() < 0.3 else tree(1)
        return left + tree(height - 1) + [(op, 0)]

    while True:
        prog = tree(int(rng.integers(1, max_depth + 1)))
        depth = cur = 0
        for op, _ in prog:
            cur += 1 if op == pbool.OP_PUSH else -1
            depth = max(depth, cur)
        if depth <= max_depth and len(prog) <= length:
            return prog


def _programs(rng, n_rows, n_terms, empty, length, max_depth):
    ops = np.zeros((n_rows, length), np.int32)
    args = np.zeros((n_rows, length), np.int32)
    for r in range(n_rows):
        prog = _random_program(rng, n_terms, empty, max_depth, length)
        ops[r, : len(prog)] = [p[0] for p in prog]
        args[r, : len(prog)] = [p[1] for p in prog]
    return ops, args


@pytest.mark.parametrize("depth", [4, 8])
def test_eval_program_matches_reference(depth):
    rng = np.random.default_rng(depth)
    n, n_terms, n_words = 12, 16, 64
    masks = rng.integers(0, 1 << 32, (n, n_terms + 1, n_words),
                         dtype=np.uint64).astype(np.uint32)
    masks[:, n_terms] = 0                          # the empty row
    ops, args = _programs(rng, n, n_terms, n_terms, 32, depth)
    got = pbool.eval_program(_t(masks.view(np.int32)), _t(ops), _t(args),
                             depth=depth)
    for r in range(n):
        want = np.asarray(jbool.eval_program(masks[r], ops[r], args[r],
                                             depth=depth))
        np.testing.assert_array_equal(got[r].numpy(), want.view(np.int32))


def make_csr(seed, n_terms=96, dead=0.1):
    """A slot-sorted CSR over N_SLOTS padded slots (3500 real), postings
    padded to a multiple of 4096 with zero rows, as a snapshot is."""
    rng = np.random.default_rng(seed)
    n_real = 3500
    lens = rng.integers(1, 300, n_terms)
    lens[rng.random(n_terms) < 0.1] = 0
    lens[:3] = (0, 1, n_real)
    slots = [np.sort(rng.choice(n_real, size=int(x), replace=False))
             for x in lens]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    total = int(lens.sum())
    p_pad = -(-total // 4096) * 4096 + 4096
    ps = np.zeros(p_pad, np.int32)
    pl = np.zeros(p_pad, np.float32)
    ps[:total] = np.concatenate(slots)
    pl[:total] = np.log(rng.integers(1, 9, total) + 1.0).astype(np.float32)
    dl = np.ones(N_SLOTS, np.float32)
    dl[:n_real] = rng.integers(3, 90, n_real)
    alive = np.zeros(N_SLOTS, bool)
    alive[:n_real] = rng.random(n_real) >= dead
    bits = np.packbits(alive, bitorder="little").view(np.uint32)
    return {"slot": ps, "ltf": pl, "dl": dl, "alive": bits,
            "starts": starts, "lens": lens}


def _queries(rng, csr, n_rows, n_terms, use_mask, empty, bmax=None):
    q_start, q_len = _ranges(rng, n_rows, n_terms, csr["lens"],
                             csr["starts"])
    q_idf = rng.uniform(0.1, 5.0, (n_rows, n_terms)).astype(np.float32)
    if use_mask:
        ops, args = _programs(rng, n_rows, n_terms, empty, 32, 8)
    else:
        ops = np.zeros((n_rows, 1), np.int32)
        args = np.zeros((n_rows, 1), np.int32)
    total = int(q_len.sum(axis=1).max())
    budget = 1024
    while budget < total:
        budget *= 4
    return q_start, q_len, q_idf, ops, args, (bmax or budget)


def assert_same_topk(want_s, want_l, got_s, got_l, what=""):
    """Scores within TOL; slots equal, except an adjacent swap where the
    reference's two scores differ by <= TOL."""
    want_s, want_l = np.asarray(want_s), np.asarray(want_l)
    got_s, got_l = got_s.numpy(), got_l.numpy()
    assert want_s.shape == got_s.shape, what
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=TOL, err_msg=what)
    for r in range(want_s.shape[0]):
        i = 0
        while i < want_s.shape[1]:
            if got_l[r, i] != want_l[r, i]:
                assert (i + 1 < want_s.shape[1]
                        and got_l[r, i] == want_l[r, i + 1]
                        and got_l[r, i + 1] == want_l[r, i]
                        and abs(want_s[r, i] - want_s[r, i + 1]) <= TOL), \
                    (what, r, i, want_l[r], got_l[r])
                i += 1
            i += 1


def _snapshot(csr):
    j = [csr["slot"], csr["ltf"], csr["dl"], csr["alive"]]
    p = [_t(csr["slot"]), _t(csr["ltf"]), _t(csr["dl"]),
         _t(csr["alive"].view(np.int32))]
    return j, p


CANDIDATE = [
    # (algo, use_mask, n_terms, dead share, budget override)
    (0, False, 8, 0.0, None),
    (0, True, 8, 0.1, None),
    (1, True, 16, 0.1, None),
    (1, False, 16, 0.2, None),
    (0, True, 32, 0.1, None),          # bit 31 of the presence bits
    (0, True, 8, 0.1, 1 << 14),        # budget far above the postings
]


@pytest.mark.parametrize("algo,use_mask,n_terms,dead,bmax", CANDIDATE)
def test_candidate_matches_reference(algo, use_mask, n_terms, dead, bmax):
    rng = np.random.default_rng(100 + n_terms + 10 * algo + use_mask)
    csr = make_csr(n_terms + algo, dead=dead)
    j, p = _snapshot(csr)
    q_start, q_len, q_idf, ops, args, budget = _queries(
        rng, csr, 10, n_terms, use_mask, pbool.EMPTY_LEAF_BIT, bmax)
    adl = np.float32(37.0)
    kw = dict(budget=budget, k=K, algo=algo, use_mask=use_mask, depth=8)
    want_s, want_l = jexec.device_search_batch(
        *j, q_start, q_len, q_idf, adl, ops, args, **kw)
    got_s, got_l = pexec.device_search_batch(
        *p, _t(q_start), _t(q_len), _t(q_idf), torch.tensor(adl),
        _t(ops), _t(args), **kw)
    assert got_l.dtype == torch.int32
    assert_same_topk(want_s, want_l, got_s, got_l, "candidate batch")
    assert (np.asarray(want_s) > 0).any()
    # The single-query entry equals its batch row.
    s1, l1 = pexec.device_search(*p, _t(q_start[3]), _t(q_len[3]),
                                 _t(q_idf[3]), torch.tensor(adl),
                                 _t(ops[3]), _t(args[3]), **kw)
    assert torch.equal(s1, got_s[3]) and torch.equal(l1, got_l[3])


DENSE = [
    # (algo, use_mask, n_terms, dead share)
    (0, True, 33, 0.1),
    (0, True, 64, 0.0),
    (1, True, 48, 0.2),
    (0, False, 40, 0.1),
    (1, False, 8, 0.0),
]


@pytest.mark.parametrize("algo,use_mask,n_terms,dead", DENSE)
def test_dense_matches_reference(algo, use_mask, n_terms, dead):
    rng = np.random.default_rng(200 + n_terms + 10 * algo + use_mask)
    csr = make_csr(n_terms + 7 * algo, dead=dead)
    j, p = _snapshot(csr)
    q_start, q_len, q_idf, ops, args, budget = _queries(
        rng, csr, 6, n_terms, use_mask, n_terms)
    adl = np.float32(41.0)
    kw = dict(budget=budget, k=K, algo=algo, n_slots=N_SLOTS,
              use_mask=use_mask, depth=8)
    want_s, want_l = jexec.device_search_dense_batch(
        *j, q_start, q_len, q_idf, adl, ops, args, **kw)
    got_s, got_l = pexec.device_search_dense_batch(
        *p, _t(q_start), _t(q_len), _t(q_idf), torch.tensor(adl),
        _t(ops), _t(args), term_lens=q_len.max(axis=0).tolist(), **kw)
    assert got_l.dtype == torch.int32
    assert_same_topk(want_s, want_l, got_s, got_l, "dense batch")
    assert (np.asarray(want_s) > 0).any()
    s1, l1 = pexec.device_search_dense(
        *p, _t(q_start[2]), _t(q_len[2]), _t(q_idf[2]), torch.tensor(adl),
        _t(ops[2]) if use_mask else None,
        _t(args[2]) if use_mask else None, **kw)
    assert torch.equal(s1, got_s[2]) and torch.equal(l1, got_l[2])


def test_plain_routes_refused_from_2_24_slots():
    """The candidate / dense dispatch, which refused snapshots of 2**24
    slots or more until they read an exact int32 slot column, answers
    there now: its packed result carries odd slots past 2**24 (which f32
    by value rounds onto their neighbours) bit for bit through the
    batch fetch, on both executors."""
    slots = [7, (1 << 24) + 1, (1 << 24) + 3]
    assert int(np.float32(slots[1])) != slots[1]     # what f32 would do
    dev = large_slots_corpus.plain_dev(slots)
    sp = psearch.SearchParams(limit=10, algo=0, fuzzymatch=False)
    for use_dense in (False, True):
        plans = [large_slots_corpus.plain_plan(t, use_dense)
                 for t in range(3)]
        key = psearch._Plan.batch_key.fget(plans[0])
        packed = psearch._dispatch_plain(dev, key, plans, sp, K, 3)
        arr, = psearch._fetch_finish(psearch._fetch_start([packed]))
        scores, got = psearch.unpack_bits(arr)
        assert got[:, 0].tolist() == slots, use_dense
        assert (scores[:, 0] > 0).all() and (scores[:, 1:] == 0).all()


# -- search level --------------------------------------------------------

N_DOCS, VOCAB, MEAN_LEN = 3000, 6000, 20


def _vocab():
    probs = 1.0 / (np.arange(VOCAB, dtype=np.float64) + 10.0)
    probs /= probs.sum()
    return np.array([f"w{i:05d}" for i in range(VOCAB)]), probs


def wide_masked(rng, n, lo=33, hi=48):
    """Masked queries of lo-hi unique terms: an OR group AND NOT a word,
    or two OR groups ANDed."""
    words, probs = _vocab()
    qp = probs ** 0.35
    qp /= qp.sum()
    out = []
    for i in range(n):
        m = int(rng.integers(lo, hi + 1))
        ws = [str(w) for w in words[rng.choice(VOCAB, m, replace=False,
                                               p=qp)]]
        if i % 2:
            h = m // 2
            out.append(f"({' OR '.join(ws[:h])}) AND "
                       f"({' OR '.join(ws[h:])})")
        else:
            out.append(f"({' OR '.join(ws[:-1])}) AND NOT {ws[-1]}")
    return out


def search_queries(seed):
    """Plain and mixed traffic, boolean queries over the heaviest
    (dense-row) terms, and > 32-term masked queries (last 8)."""
    words, probs = _vocab()
    rng = np.random.default_rng(seed)
    heavy = []
    for _ in range(3):
        h = str(words[rng.integers(0, 12)])
        a, b = (str(w) for w in words[rng.choice(VOCAB, 2, p=probs)])
        heavy += [f"{h} AND {a}", f"{a} {b} AND NOT {h}",
                  f"({h} OR {a}) AND {b}"]
    return (bench.make_queries(16, words, probs, rng)
            + bench.make_mixed_queries(32, words, probs, rng)
            + heavy + wide_masked(rng, 8))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    basedir = str(tmp_path_factory.mktemp("fallback"))
    jnxs = nxsearch_tpu.Nxs(basedir)
    jidx = jnxs.index_create("f")
    jidx.add_many(bench.zipf_range(0, N_DOCS, VOCAB, MEAN_LEN))
    pnxs = nxsearch_tpu_torch.Nxs(basedir, device="cpu")
    pidx = pnxs.index_open("f")
    yield jidx, pidx
    pnxs.close()
    jnxs.close()


@pytest.fixture(params=[False, True], ids=["cpu_router", "as_is"])
def router(request, monkeypatch):
    """The port's router: patched to the reference's CPU routing (no
    blockdense executor), or as it stands.  The masked hybrid is off in
    both packages (NXS_MASKED_HYBRID=0), so masked rows with dense-row
    terms leave the sliced route: for the candidate executor on the
    reference's CPU routing."""
    if not request.param:
        monkeypatch.setattr(psearch, "_use_blockdense",
                            lambda *a, **kw: False)
    monkeypatch.setattr(jsearch, "_MASKED_HYBRID", False)
    monkeypatch.setattr(psearch, "_MASKED_HYBRID", False)
    jsearch.EXEC_STATS.clear()
    psearch.EXEC_STATS.clear()
    return request.param


def assert_same(ref, got, query=""):
    """Equal limits on both sides: ids equal in order, except an
    adjacent swap of reference scores within TOL; scores within TOL."""
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


def _check_counters(router):
    j, p = jsearch.EXEC_STATS, psearch.EXEC_STATS
    assert j.get("dense", 0) > 0, j
    if router:
        assert p.get("dense", 0) > 0, p
        assert (p.get("candidate", 0) + p.get("dense", 0)
                + p.get("blockdense", 0)
                == j.get("candidate", 0) + j.get("dense", 0)), (j, p)
    else:
        assert p.get("blockdense", 0) == 0, p
        for key in ("candidate", "dense"):
            assert p.get(key, 0) == j.get(key, 0), (key, j, p)


def test_search_many_matches_reference(pair, router):
    jidx, pidx = pair
    queries = search_queries(1)
    want = jidx.search_many(queries, nxsearch_tpu.Params().set_uint(
        "limit", 10))
    got = pidx.search_many(queries, nxsearch_tpu_torch.Params().set_uint(
        "limit", 10))
    for q, r, g in zip(queries, want, got):
        assert_same(r, g, q)
    assert sum(len(g.results) for g in got[-8:]) > 0
    _check_counters(router)
    if not router:
        assert jsearch.EXEC_STATS.get("candidate", 0) > 0


def test_search_tfidf_matches_reference(pair, router):
    jidx, pidx = pair
    queries = search_queries(1)
    want = jidx.search_many(queries, nxsearch_tpu.Params().set_uint(
        "limit", 10).set_str("algo", "TF-IDF"))
    got = pidx.search_many(queries, nxsearch_tpu_torch.Params().set_uint(
        "limit", 10).set_str("algo", "TF-IDF"))
    for q, r, g in zip(queries, want, got):
        assert_same(r, g, q)
    _check_counters(router)


def test_search_single_matches_reference(pair, router):
    jidx, pidx = pair
    queries = search_queries(1)
    for q in queries[::6] + queries[-4:]:
        assert_same(
            jidx.search(q, nxsearch_tpu.Params().set_uint("limit", 10)),
            pidx.search(q, nxsearch_tpu_torch.Params().set_uint(
                "limit", 10)), q)


def test_search_pipelined_matches_reference(pair, router):
    jidx, pidx = pair
    queries = search_queries(1)
    batches = [queries[i: i + 24] for i in range(0, len(queries), 24)]
    want = jidx.search_pipelined(batches, nxsearch_tpu.Params().set_uint(
        "limit", 10))
    got = pidx.search_pipelined(batches, nxsearch_tpu_torch.Params()
                                .set_uint("limit", 10))
    for b_q, b_r, b_g in zip(batches, want, got):
        for q, r, g in zip(b_q, b_r, b_g):
            assert_same(r, g, q)
    _check_counters(router)


ROUTES = ("prefix", "sliced", "blockdense", "candidate", "dense")


@pytest.mark.parametrize("entry", ["search", "search_many"])
@pytest.mark.parametrize("route", ROUTES)
def test_single_query_counts_its_route(pair, monkeypatch, route, entry):
    """Every route bumps exactly one route counter, once, whether the
    query comes through ``Index.search`` or alone through
    ``Index.search_many``, and answers as the reference does through the
    same entry point: a pure-OR BM25 query the prefix one, the same
    query in TF-IDF the sliced one, a masked query over a dense-row
    term with the masked hybrid off the blockdense one (the candidate
    one with ``_use_blockdense`` patched to False), and a > 32-term
    masked query the dense one."""
    jidx, pidx = pair
    words, _probs = _vocab()
    heavy = str(words[0])
    query, algo = {
        "prefix": ("w00100 w00200", "BM25"),
        "sliced": ("w00100 w00200", "TF-IDF"),
        "blockdense": (f"{heavy} AND w00100", "BM25"),
        "candidate": (f"{heavy} AND w00100", "BM25"),
        "dense": (wide_masked(np.random.default_rng(5), 1)[0], "BM25"),
    }[route]
    monkeypatch.setattr(jsearch, "_MASKED_HYBRID", False)
    monkeypatch.setattr(psearch, "_MASKED_HYBRID", False)
    if route == "candidate":
        monkeypatch.setattr(psearch, "_use_blockdense",
                            lambda *a, **kw: False)

    def run(idx, params):
        params = params.set_uint("limit", 10).set_str("algo", algo)
        if entry == "search":
            return idx.search(query, params)
        got, = idx.search_many([query], params)
        return got

    psearch.EXEC_STATS.clear()
    got = run(pidx, nxsearch_tpu_torch.Params())
    assert len(got.results) > 0
    assert {key: psearch.EXEC_STATS.get(key, 0) for key in ROUTES} == \
        {key: int(key == route) for key in ROUTES}
    assert_same(run(jidx, nxsearch_tpu.Params()), got, query)
