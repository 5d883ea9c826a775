"""Parallel ingest through the port (nxsearch_tpu_torch/ingest.py),
held to nxsearch_tpu's serial ingest.

One corpus (bench.py's Zipf generator, through a jax-free
``functools.partial`` so the spawned workers import no jax) is built
serially by the reference (``workers=1``) and by the port with three
striped workers.  The doc, term and token counts are equal, and the
two packages answer the same queries on their two basedirs: scores in
rank order within 1e-4, and ids equal except among documents whose
scores tie within 1e-4 (parallel ingest gives documents other slots,
and ties go to the lowest slot).  A worker's failure raises
RuntimeError; the serial branch and the worker body, run in this
process with CUDA initialisation made to raise, never touch CUDA.
"""

import functools
import queue

import numpy as np
import pytest
import torch

import bench
import nxsearch_tpu
import nxsearch_tpu_torch
from nxsearch_tpu.ingest import parallel_ingest as j_parallel_ingest
from nxsearch_tpu_torch import ingest as pingest

N_DOCS, VOCAB, MEAN_LEN = 600, 2000, 12
TOL = 1e-4
SOURCE = functools.partial(bench.zipf_range, vocab=VOCAB, mean_len=MEAN_LEN)


def _create(pkg, basedir, **kw):
    nxs = pkg.Nxs(basedir, **kw)
    nxs.index_create("c")
    nxs.close()


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(reference index over the serial build, port index over the
    parallel one)."""
    serial = str(tmp_path_factory.mktemp("serial"))
    par = str(tmp_path_factory.mktemp("parallel"))
    _create(nxsearch_tpu, serial)
    j_parallel_ingest(serial, "c", SOURCE, N_DOCS, workers=1)
    _create(nxsearch_tpu_torch, par, device="cpu")
    nxsearch_tpu_torch.parallel_ingest(par, "c", SOURCE, N_DOCS, workers=3,
                                       chunk=64, stripe=100)
    jnxs = nxsearch_tpu.Nxs(serial)
    pnxs = nxsearch_tpu_torch.Nxs(par, device="cpu")
    yield jnxs.index_open("c"), pnxs.index_open("c")
    pnxs.close()
    jnxs.close()


def test_parallel_counts_equal_serial(built):
    jidx, pidx = built
    want, got = jidx.stats(), pidx.stats()
    assert want["doc_count"] == N_DOCS
    for key in ("doc_count", "term_count", "token_count"):
        assert got[key] == want[key], key


def _queries():
    words = np.array([f"w{i:05d}" for i in range(VOCAB)])
    probs = 1.0 / (np.arange(VOCAB) + 10.0)
    probs /= probs.sum()
    rng = np.random.default_rng(3)
    return (bench.make_queries(24, words, probs, rng)
            + bench.make_mixed_queries(24, words, probs, rng)
            + bench.make_fuzzy_queries(8, words, probs, rng, "x")
            + ["w00001", "w00000 w00002"])


@pytest.mark.parametrize("algo", ["BM25", "TF-IDF"])
def test_parallel_answers_equal_serial(built, algo):
    """The port's top 10 on the parallel build against the reference's
    whole ranking on the serial one."""
    jidx, pidx = built
    queries = _queries()
    want = jidx.search_many(queries, nxsearch_tpu.Params().set_uint(
        "limit", N_DOCS).set_str("algo", algo))
    got = pidx.search_many(queries, nxsearch_tpu_torch.Params().set_uint(
        "limit", 10).set_str("algo", algo))
    n_hits = 0
    for q, w, g in zip(queries, want, got):
        ref = dict(w.results)
        assert len(g.results) == min(10, len(ref)), q
        np.testing.assert_allclose([s for _, s in g.results],
                                   [s for _, s in w.results[:10]],
                                   rtol=0, atol=TOL, err_msg=q)
        assert len({d for d, _ in g.results}) == len(g.results), q
        for doc_id, score in g.results:
            assert doc_id in ref and abs(ref[doc_id] - score) <= TOL, \
                (q, doc_id)
        n_hits += len(g.results)
    assert n_hits > 0


def test_parallel_ingest_worker_failure(tmp_path):
    """A worker whose range holds an indexed document fails; the
    parent raises with its traceback."""
    basedir = str(tmp_path)
    nxs = nxsearch_tpu_torch.Nxs(basedir, device="cpu")
    nxs.index_create("c").add(150, "already here")
    nxs.close()
    with pytest.raises(RuntimeError, match="(?s)parallel ingest failed.*"
                                           "already indexed"):
        nxsearch_tpu_torch.parallel_ingest(basedir, "c", SOURCE, 300,
                                           workers=2, chunk=50, stripe=100)


def test_ingest_never_touches_cuda(tmp_path, monkeypatch):
    """The serial branch and the worker body open the index on the CPU:
    with CUDA initialisation made to raise, both finish."""
    def no_cuda():
        raise AssertionError("ingest initialised CUDA")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setenv("NXS_MALLOC_TUNE", "0")
    basedir = str(tmp_path)
    _create(nxsearch_tpu_torch, basedir, device="cpu")
    pingest.parallel_ingest(basedir, "c", SOURCE, 40, workers=1, chunk=16)
    errq = queue.Queue()
    pingest._worker(basedir, "c", SOURCE, [(40, 70), (100, 110)], 16, errq)
    assert errq.empty()
    nxs = nxsearch_tpu_torch.Nxs(basedir, device="cpu")
    assert nxs.index_open("c").stats()["doc_count"] == 80
    nxs.close()
    assert not torch.cuda.is_initialized()
