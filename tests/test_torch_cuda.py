"""Tests that need a CUDA card: the hand-written kernels against their
plain twins, and the port on the card against the port on the CPU.

This file imports neither jax nor nxsearch_tpu, so it also runs on a
machine without jax (the repository's conftest.py imports jax):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Each test decides inside itself whether a card is present and skips
with a reason where there is none.
"""

import numpy as np
import pytest
import torch

from nxsearch_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _myers_inputs(seed, n_terms, n_queries, alphabet=b"abcdefgh"):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, dtype=np.uint8)

    def rows(n):
        lens = rng.integers(1, 33, size=n).astype(np.int32)
        r = alpha[rng.integers(0, len(alpha), size=(n, 32))]
        r[np.arange(32)[None, :] >= lens[:, None]] = 0
        return r.astype(np.uint8), lens

    vb, vl = rows(n_terms)
    qb, ql = rows(n_queries)
    ql[0] = 32
    ql[-1] = 0
    qb[-1] = 0
    vl[:2] = 0
    vb[:2] = 0
    return [torch.from_numpy(a).cuda() for a in (vb, vl, qb, ql)]


@pytest.mark.parametrize("n_terms,n_queries",
                         [(200_000, 64), (1000, 1), (4099, 70)])
def test_myers_kernel_matches_twin(n_terms, n_queries):
    """Exact equality at the main path's shape, at M = 1, and at a ragged
    W with more queries than one shared-memory group holds."""
    _need_card()
    args = _myers_inputs(n_terms + n_queries, n_terms, n_queries)
    before = kernels.MYERS.launches
    got = kernels.myers_distances(*args)
    want = kernels.myers_distances_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kernels.MYERS.launches == before + 1


def test_myers_kernel_full_byte_range():
    _need_card()
    args = _myers_inputs(9, 5000, 40, alphabet=bytes(range(1, 256)))
    assert torch.equal(kernels.myers_distances(*args),
                       kernels.myers_distances_ref(*args))


def test_myers_wrapper_rejects_bad_inputs():
    _need_card()
    vb, vl, qb, ql = _myers_inputs(1, 64, 4)
    with pytest.raises(ValueError, match="vocab_len"):
        kernels.myers_distances(vb, vl.long(), qb, ql)
    with pytest.raises(ValueError, match="q_bytes"):
        kernels.myers_distances(vb, vl, qb.cpu(), ql)


def _assert_same(want, got, query):
    """Ids identical in order, except an adjacent swap where the CPU
    scores differ by <= 1e-4 (``want`` answers one result deeper, so a
    swap across the last rank is checked too); scores within 1e-4."""
    ids_w = [d for d, _ in want.results]
    sc_w = [s for _, s in want.results]
    ids_g = [d for d, _ in got.results]
    n = len(ids_g)
    assert n == min(len(ids_w), 10), query
    np.testing.assert_allclose([s for _, s in got.results], sc_w[:n],
                               rtol=0, atol=1e-4, err_msg=query)
    i = 0
    while i < n:
        if ids_g[i] != ids_w[i]:
            assert (i + 1 < len(ids_w) and ids_g[i] == ids_w[i + 1]
                    and (i + 1 == n or ids_g[i + 1] == ids_w[i])
                    and abs(sc_w[i] - sc_w[i + 1]) <= 1e-4), \
                (query, i, ids_w, ids_g)
            i += 1
        i += 1


def test_port_on_card_matches_port_on_cpu(tmp_path):
    """One basedir searched by the port on the card and on the CPU,
    fuzzy queries included."""
    _need_card()
    import bench
    from nxsearch_tpu_torch import Nxs, Params

    vocab = 6000
    cpu = Nxs(str(tmp_path), device="cpu")
    idx_c = cpu.index_create("t")
    idx_c.add_many(bench.zipf_range(0, 3000, vocab, 20))
    gpu = Nxs(str(tmp_path), device="cuda")
    idx_g = gpu.index_open("t")
    words = np.array([f"w{i:05d}" for i in range(vocab)])
    probs = 1.0 / (np.arange(vocab) + 10.0)
    probs /= probs.sum()
    rng = np.random.default_rng(0)
    queries = (bench.make_queries(200, words, probs, rng)
               + bench.make_fuzzy_queries(50, words, probs, rng, "x"))
    before = kernels.MYERS.launches
    got = idx_g.search_many(queries, Params().set_uint("limit", 10))
    want = idx_c.search_many(queries, Params().set_uint("limit", 11))
    assert kernels.MYERS.launches > before
    for q, w, g in zip(queries, want, got):
        _assert_same(w, g, q)
    gpu.close()
    cpu.close()
