"""The port's REST service (nxsearch_tpu_torch/service) on the CPU.

Twins of tests/test_service.py against the port's SearchService
(``device="cpu"``), over a live ThreadingHTTPServer: the svc_test.sh
scenario, query-string params, store / fetch, remove, filter posting
and its gate, the docs, name validation before deletion, stats, and
concurrent clients -- whose every response must equal the sequential
answer exactly; the mutations run in a window of their own, between
two concurrent search windows.

Parity: one sequence of requests (create, adds with ``?store``, bad
adds, plain / typo / AND / NOT searches with ``?limit``,
``?algo=TF-IDF`` and ``?fetch``, ``search_batch``, ``stats``,
``remove``, bad names, an unknown endpoint, destroy) sent to the
reference service and to the port's, on two basedirs.  Status codes
are equal; bodies are equal, except that result lists follow the
score rule of tests/test_torch_slice.py: scores within 1e-4, ids equal
in order up to an adjacent swap of scores within 1e-4.
"""

import json
import os
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import pytest
import torch

import bench
from nxsearch_tpu.service.app import SearchService as JSearchService
from nxsearch_tpu.service.app import make_handler as j_make_handler
from nxsearch_tpu_torch import search as psearch
from nxsearch_tpu_torch.service import app as papp
from nxsearch_tpu_torch.service.app import SearchService, make_handler

TOL = 1e-4


def _serve(svc, handler_factory):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler_factory(svc))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, svc):
    httpd.shutdown()
    httpd.server_close()
    svc.close()


@pytest.fixture()
def server(tmp_path, monkeypatch):
    monkeypatch.setenv("NXS_ENABLE_PY_POST", "1")
    svc = SearchService(str(tmp_path), device="cpu")
    httpd, base = _serve(svc, make_handler)
    yield base
    _stop(httpd, svc)


def req(method, url, data=None):
    r = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(r, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_svc_end_to_end(server):
    """The svc_test.sh scenario verbatim."""
    index = "__test-index-svc-1"
    status, _ = req("POST", f"{server}/{index}")
    assert status == 201

    status, _ = req("POST", f"{server}/~")
    assert status == 400

    for doc_id, text in ((1, b"cat dog cow"), (2, b"dog cow"),
                         (3, b"cat cat cat")):
        status, _ = req("POST", f"{server}/{index}/add/{doc_id}", text)
        assert status == 201

    status, body = req("POST", f"{server}/{index}/search", b"cat")
    assert status == 200
    assert [r["doc_id"] for r in json.loads(body)["results"]] == [3, 1]

    status, _ = req("DELETE", f"{server}/{index}")
    assert status == 200
    status, body = req("POST", f"{server}/{index}/search", b"cat")
    assert status == 400
    assert "error" in json.loads(body)


def test_svc_query_string_params(server):
    req("POST", f"{server}/qs")
    req("POST", f"{server}/qs/add/1", b"dog cat")
    req("POST", f"{server}/qs/add/2", b"dog dog dog cat")
    status, body = req("POST", f"{server}/qs/search?limit=1&algo=TF-IDF",
                       b"dog")
    assert status == 200
    assert json.loads(body)["count"] == 1
    status, body = req("POST", f"{server}/qs/search?limit=bogus", b"dog")
    assert status == 400


def test_svc_store_and_fetch(server):
    req("POST", f"{server}/blobs")
    status, _ = req("POST", f"{server}/blobs/add/7?store", b"dogs and cats")
    assert status == 201
    status, body = req("POST", f"{server}/blobs/search?fetch", b"dogs")
    assert status == 200
    results = json.loads(body)
    assert results["results"][0]["doc_id"] == 7
    assert results["results"][0]["content"] == "dogs and cats"


def test_svc_remove(server):
    req("POST", f"{server}/rm")
    req("POST", f"{server}/rm/add/1", b"some dogs")
    req("POST", f"{server}/rm/add/2", b"other dogs")
    status, _ = req("DELETE", f"{server}/rm/remove/1")
    assert status == 200
    _, body = req("POST", f"{server}/rm/search", b"dogs")
    assert [r["doc_id"] for r in json.loads(body)["results"]] == [2]
    status, body = req("DELETE", f"{server}/rm/remove/1")
    assert status == 400
    assert json.loads(body)["error"]["code"] == 5


def test_svc_filter_post(server):
    code = b"def filter(ctx, value):\n    return None if 'x' in value else value\n"
    status, _ = req("POST", f"{server}/filters/dropx/py?store", code)
    assert status == 201
    status, _ = req("POST", f"{server}/filters/bad-name/py", code)
    assert status == 400
    params = json.dumps({
        "filters": ["normalizer", "dropx"], "lang": "en"}).encode()
    status, _ = req("POST", f"{server}/flt", params)
    assert status == 201
    req("POST", f"{server}/flt/add/1", b"fox dog")
    _, body = req("POST", f"{server}/flt/search", b"fox dog")
    assert json.loads(body)["count"] == 1  # "fox" was dropped


def test_svc_docs(server):
    status, body = req("GET", f"{server}/docs")
    assert status == 200 and b"openapi.json" in body
    status, body = req("GET", f"{server}/docs/openapi.json")
    assert status == 200
    spec = json.loads(body)
    assert spec["openapi"].startswith("3.")
    assert "/{index}/search" in spec["paths"]


def test_svc_filter_post_gated(tmp_path, monkeypatch):
    monkeypatch.delenv("NXS_ENABLE_PY_POST", raising=False)
    svc = SearchService(str(tmp_path), device="cpu")
    try:
        status, payload = svc.handle(
            "POST", "/filters/nope/py", {}, b"def filter(c, v): return v")
        assert status == 400
        assert payload["error"]["code"] == 2  # SYSTEM
    finally:
        svc.close()


def test_svc_destroy_validates_name_first(server, tmp_path):
    status, _ = req("POST", f"{server}/docs")
    assert status == 201
    status, _ = req("POST", f"{server}/docs/add/1", b"keep me around")
    assert status == 201
    for evil in (".", "..", "%2e%2e"):
        status, body = req("DELETE", f"{server}/{evil}")
        assert status == 400, (evil, body)
    assert os.path.isdir(os.path.join(str(tmp_path), "data", "docs"))
    status, body = req("POST", f"{server}/docs/search", b"keep")
    assert status == 200
    assert json.loads(body)["count"] == 1


def test_svc_stats(server):
    status, _ = req("POST", f"{server}/statidx")
    assert status == 201
    for doc_id, text in ((1, b"cat dog"), (2, b"dog cow bird")):
        req("POST", f"{server}/statidx/add/{doc_id}", text)
    status, body = req("GET", f"{server}/statidx/stats")
    assert status == 200
    stats = json.loads(body)
    assert stats["doc_count"] == 2
    assert stats["term_count"] == 4
    assert stats["token_count"] == 5
    assert stats["algo"] == "BM25"


def test_svc_concurrent_clients(server):
    """10 concurrent clients: every response equals the sequential
    answer exactly.  The mutations (transient adds and removes from
    several threads) run in a window of their own; the searches after
    it are held to answers taken sequentially after it."""
    req("POST", f"{server}/conc")
    docs = {
        1: b"the quick brown fox jumps over the lazy dog",
        2: b"dogs and cats living together",
        3: b"a cat a dog and a fox walk into a bar",
        4: b"nothing to see here",
        5: b"fox fox fox den",
    }
    for doc_id, text in docs.items():
        status, _ = req("POST", f"{server}/conc/add/{doc_id}", text)
        assert status == 201
    queries = [b"dog", b"fox", b"cat AND dog", b"fox AND NOT cat",
               b"dog cat fox", b"dgo fxo"]

    def sequential():
        out = {}
        for q in queries:
            status, body = req("POST", f"{server}/conc/search", q)
            assert status == 200
            out[q] = json.loads(body)
        return out

    def window(want):
        errors = []

        def worker(j):
            for it in range(6):
                q = queries[(j + it) % len(queries)]
                status, body = req("POST", f"{server}/conc/search", q)
                if status != 200 or json.loads(body) != want[q]:
                    errors.append((q, status, body))

        with ThreadPoolExecutor(max_workers=10) as ex:
            list(ex.map(worker, range(10)))
        assert not errors, errors[:3]

    window(sequential())

    def mutate(j):
        doc = 100 + j
        assert req("POST", f"{server}/conc/add/{doc}",
                   b"transient dog")[0] == 201
        assert req("DELETE", f"{server}/conc/remove/{doc}")[0] == 200

    with ThreadPoolExecutor(max_workers=4) as ex:
        list(ex.map(mutate, range(4)))
    want = sequential()
    assert all(r["doc_id"] < 100 for w in want.values()
               for r in w["results"])
    window(want)


def test_exec_stats_counts_survive_threads():
    """The route counters' read-modify-write under many threads and a
    short switch interval: no count is lost."""
    saved = sys.getswitchinterval()
    psearch.EXEC_STATS.pop("_stress", None)
    try:
        sys.setswitchinterval(1e-6)

        def bump():
            for _ in range(20_000):
                psearch._count("_stress")

        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert psearch.EXEC_STATS.pop("_stress") == 16 * 20_000


def test_blockdense_bounds_cache_survives_threads(tmp_path, monkeypatch):
    """Two request threads of blockdense queries (masked hybrid off)
    over far more distinct non-dense terms than a 4-row bounds cache
    holds: each answer equals the same query run alone.  A thread's
    cache rows must not be evicted and rewritten between its
    ``bounds_crows`` and the kernel that reads them; a sleep after each
    ``bounds_crows`` widens that window so the other thread runs in it
    whenever the rows are not protected."""
    import time

    from nxsearch_tpu_torch import Nxs
    from nxsearch_tpu_torch.index.device import DeviceIndex

    monkeypatch.setattr(DeviceIndex, "BOUNDS_CACHE_ROWS", 4)
    real_crows = DeviceIndex.bounds_crows

    def slow_crows(self, term_ids):
        out = real_crows(self, term_ids)
        time.sleep(0.001)
        return out

    monkeypatch.setattr(DeviceIndex, "bounds_crows", slow_crows)
    monkeypatch.setattr(psearch, "_MASKED_HYBRID", False)
    nxs = Nxs(str(tmp_path), device="cpu")
    idx = nxs.index_create("bd")
    idx.add_many(bench.zipf_range(0, 2000, 600, 20))
    idx.search("w00001")                      # builds the snapshot
    dev = idx.dev
    values = idx.host.term_values
    dense = [values[t - 1] for t in sorted(dev.dense_row_of)]
    sparse = [values[t - 1] for t in range(1, dev.base_nterms + 1)
              if t not in dev.dense_row_of and dev.term_range(t)[1] > 0]
    assert dense and len(sparse) > 200
    queries = [f"{dense[i % len(dense)]} AND {sparse[i]}" if i % 2 == 0
               else f"{sparse[i]} {sparse[i + 100]} AND NOT "
                    f"{dense[i % len(dense)]}" for i in range(100)]
    want = {q: idx.search(q).results for q in queries}
    assert sum(map(len, want.values())) > 0
    psearch.EXEC_STATS.clear()
    bad = []

    def run(order):
        for q in order:
            got = idx.search(q).results
            if got != want[q]:
                bad.append(q)

    saved = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=run, args=(order,)) for order in
                   (queries * 3, queries[::-1] * 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
        nxs.close()
    assert psearch.EXEC_STATS.get("blockdense", 0) == 6 * len(queries)
    assert not bad, f"{len(bad)} answers differ, e.g. {bad[0]!r}"


def test_service_defaults_to_the_card(tmp_path, monkeypatch):
    """SearchService and main take ``cuda`` unless told otherwise: with
    no card they raise, and never drop to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("NXS_MALLOC_TUNE", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchService(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        papp.main(["--basedir", str(tmp_path), "--port", "0"])


# -- parity with the reference service -----------------------------------

VOCAB = 60


def _sequence():
    """(method, path, body) of the parity run; bodies are bytes."""
    docs = bench.zipf_range(0, 48, VOCAB, 8)
    seq = [("POST", "/par", json.dumps({"algo": "BM25"}).encode())]
    for doc_id, text in docs:
        store = "?store" if doc_id % 3 == 0 else ""
        seq.append(("POST", f"/par/add/{doc_id}{store}", text.encode()))
    seq += [("POST", "/par/add/abc", b"bad id"),
            ("POST", "/par/add/5", b"already indexed"),
            ("POST", "/par/add/99", b""),
            ("POST", "/par/add/0", b"zero id")]
    searches = [
        "w00001", "w00001 w00005", "w00002 w00003 w00007",
        "w0001 w00004",                      # a typo (deletion)
        "x00003 w00010",                     # a typo (substitution)
        "w00001 AND w00003", "w00002 AND NOT w00004",
        "(w00001 OR w00006) AND w00002", "nosuchword",
    ]
    for q in searches:
        for qs in ("", "?limit=3", "?algo=TF-IDF", "?fetch",
                   "?limit=5&algo=TF-IDF"):
            seq.append(("POST", f"/par/search{qs}", q.encode()))
    seq += [("POST", "/par/search?limit=bogus", b"w00001"),
            ("POST", "/par/search", b""),
            ("POST", "/par/search_batch?limit=5",
             json.dumps({"queries": searches}).encode()),
            ("POST", "/par/search_batch", json.dumps(
                {"queries": searches[:4]}).encode()),
            ("POST", "/par/search_batch", b"{not json"),
            ("POST", "/par/search_batch", b'{"queries": [1, 2]}'),
            ("GET", "/par/stats", None),
            ("DELETE", "/par/remove/3", None),
            ("DELETE", "/par/remove/3", None),
            ("DELETE", "/par/remove/x", None),
            ("POST", "/par/search", b"w00001 w00005"),
            ("POST", "/par/search_batch?algo=TF-IDF",
             json.dumps({"queries": searches}).encode()),
            ("GET", "/par/stats", None),
            ("POST", "/~", None),
            ("DELETE", "/..", None),
            ("GET", "/nope/stats", None),
            ("POST", "/nope/search", b"w00001"),
            ("GET", "/par/unknown", None),
            ("POST", "/par", None),
            ("DELETE", "/par", None),
            ("POST", "/par/search", b"w00001")]
    return seq


def _same_results(ref, got, where):
    ids_r = [r["doc_id"] for r in ref]
    sc_r = [r["score"] for r in ref]
    ids_g = [r["doc_id"] for r in got]
    assert len(ids_g) == len(ids_r), where
    for a, b in zip(got, ref):
        assert abs(a["score"] - b["score"]) <= TOL, where
        if a["doc_id"] == b["doc_id"]:          # fetched content too
            assert dict(a, score=0) == dict(b, score=0), where
    i = 0
    while i < len(ids_g):
        if ids_g[i] != ids_r[i]:
            assert (i + 1 < len(ids_g) and ids_g[i] == ids_r[i + 1]
                    and ids_g[i + 1] == ids_r[i]
                    and abs(sc_r[i] - sc_r[i + 1]) <= TOL), \
                (where, ids_r, ids_g)
            i += 1
        i += 1


def _same_body(ref, got, where):
    """Equal JSON, except that a result list is held to the score
    rule."""
    if isinstance(ref, dict) and isinstance(got, dict):
        assert ref.keys() == got.keys(), where
        for key in ref:
            if key == "results":
                _same_results(ref[key], got[key], where)
            else:
                _same_body(ref[key], got[key], f"{where}.{key}")
    elif isinstance(ref, list) and isinstance(got, list):
        assert len(ref) == len(got), where
        for i, (a, b) in enumerate(zip(ref, got)):
            _same_body(a, b, f"{where}[{i}]")
    else:
        assert ref == got, where


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """(reference base URL, port base URL) on two basedirs."""
    jsvc = JSearchService(str(tmp_path_factory.mktemp("svc_ref")))
    psvc = SearchService(str(tmp_path_factory.mktemp("svc_port")),
                         device="cpu")
    jhttpd, jbase = _serve(jsvc, j_make_handler)
    phttpd, pbase = _serve(psvc, make_handler)
    yield jbase, pbase
    _stop(phttpd, psvc)
    _stop(jhttpd, jsvc)


def test_service_answers_as_the_reference(services):
    jbase, pbase = services
    n_results = 0
    for method, path, body in _sequence():
        j_status, j_body = req(method, jbase + path, body)
        p_status, p_body = req(method, pbase + path, body)
        where = f"{method} {path} {body!r}"
        assert p_status == j_status, (where, j_body, p_body)
        assert p_status < 500, where
        if j_body or p_body:
            ref, got = json.loads(j_body), json.loads(p_body)
            _same_body(ref, got, where)
            n_results += len(got.get("results", []))
    assert n_results > 0
