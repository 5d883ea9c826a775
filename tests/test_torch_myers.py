"""Myers edit distance: the port's plain twin and fuzzy selection held to
nxsearch_tpu's Pallas kernel (interpret mode on the CPU) and jnp sweep.

Inputs are made with numpy from a seed and handed to both packages.
Distances are integers: every comparison is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nxsearch_tpu.ops import levenshtein as ref_lev
from nxsearch_tpu.ops.pallas.fuzzy import myers_distances_pallas_batch
from nxsearch_tpu_torch.ops import kernels
from nxsearch_tpu_torch.ops import levenshtein as port_lev

W = 32


def _rows(rng, n, lo, hi, alphabet):
    """n zero-padded byte rows with lengths in [lo, hi]."""
    lens = rng.integers(lo, hi + 1, size=n).astype(np.int32)
    rows = alphabet[rng.integers(0, len(alphabet), size=(n, W))]
    rows[np.arange(W)[None, :] >= lens[:, None]] = 0
    return rows.astype(np.uint8), lens


def _inputs(seed, n_terms=512, n_queries=16, alphabet=b"abcde"):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, dtype=np.uint8)
    vb, vl = _rows(rng, n_terms, 1, W, alpha)
    qb, ql = _rows(rng, n_queries, 1, W, alpha)
    ql[0] = W                              # full-width query
    qb[0] = alpha[rng.integers(0, len(alpha), size=W)]
    ql[-1] = 0                             # zero-length pad row
    qb[-1] = 0
    return vb, vl, qb, ql


def _port(vb, vl, qb, ql):
    return kernels.myers_distances_ref(
        torch.from_numpy(vb), torch.from_numpy(vl),
        torch.from_numpy(qb), torch.from_numpy(ql)).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ref_matches_pallas_interpret(seed):
    vb, vl, qb, ql = _inputs(seed)
    want = np.asarray(myers_distances_pallas_batch(
        jnp.asarray(np.ascontiguousarray(vb.T)), jnp.asarray(vl[None, :]),
        jnp.asarray(qb.astype(np.int32)), jnp.asarray(ql[:, None]),
        interpret=True))
    got = _port(vb, vl, qb, ql)
    real = ql > 0
    np.testing.assert_array_equal(got[real], want[real])


@pytest.mark.parametrize("seed", [3, 4])
def test_ref_matches_jnp_every_row(seed):
    """Against the jnp sweep, row for row -- the q_len == 0 pad row and
    the 32-byte query included -- over the full byte range."""
    vb, vl, qb, ql = _inputs(seed, n_terms=300, n_queries=10,
                             alphabet=bytes(range(1, 256)))
    got = _port(vb, vl, qb, ql)
    for i in range(len(ql)):
        want = np.asarray(ref_lev.myers_distances(
            jnp.asarray(vb), jnp.asarray(vl), jnp.asarray(qb[i]),
            jnp.int32(ql[i])))
        np.testing.assert_array_equal(got[i], want)


def test_zero_length_terms_and_queries():
    """vocab_len == 0 rows give len(q); q_len == 0 rows give len(t)."""
    vb, vl, qb, ql = _inputs(5, n_terms=64, n_queries=4)
    vl[:3] = 0
    vb[:3] = 0
    got = _port(vb, vl, qb, ql)
    np.testing.assert_array_equal(got[:, :3], np.repeat(ql[:, None], 3, 1))
    np.testing.assert_array_equal(got[-1], vl)


def test_wrapper_takes_twin_for_cpu_tensors():
    vb, vl, qb, ql = _inputs(6, n_terms=128, n_queries=5)
    before = kernels.MYERS.launches
    got = port_lev.myers_distances(
        torch.from_numpy(vb), torch.from_numpy(vl), torch.from_numpy(qb),
        torch.from_numpy(ql)).numpy()
    np.testing.assert_array_equal(got, _port(vb, vl, qb, ql))
    assert kernels.MYERS.launches == before   # the twin is no launch


def _region_inputs(seed, n=700):
    """A length-sorted region as fuzzy.py lays it out: rows ascend by
    length, original ids permuted, totals full of ties."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abc", dtype=np.uint8)
    vb, vl = _rows(rng, n, 1, 9, alpha)
    order = np.argsort(vl, kind="stable")
    vb, vl = vb[order], vl[order]
    ids = rng.permutation(n).astype(np.int32)
    totals = rng.integers(0, 4, size=n).astype(np.int64)
    totals[::7] = 0
    pad = 1024 - n
    vb = np.concatenate([vb, np.zeros((pad, W), np.uint8)])
    vl = np.concatenate([vl, np.zeros(pad, np.int32)])
    ids = np.concatenate([ids, np.full(pad, 0x7FFFFFFF, np.int32)])
    totals = np.concatenate([totals, np.zeros(pad, np.int64)])
    qb, ql = _rows(rng, 12, 1, 9, alpha)
    return vb, vl, totals, ids, qb, ql


@pytest.mark.parametrize("seed,lo,w", [(0, 0, 1024), (1, 100, 512),
                                       (2, 500, 256)])
def test_fuzzy_best_region_matches_reference(seed, lo, w):
    """Same winning original ids as the reference's jnp region sweep
    (ties on the total go to the lowest original id); the start is
    clamped the same way."""
    vb, vl, totals, ids, qb, ql = _region_inputs(seed)
    want = np.asarray(ref_lev.fuzzy_best_region(
        jnp.asarray(vb), jnp.asarray(vl),
        jnp.asarray(totals.astype(np.uint32)), jnp.asarray(ids),
        jnp.asarray(qb), jnp.asarray(ql), jnp.int32(lo), jnp.int32(2),
        W=w, mode="jnp"))
    got = port_lev.fuzzy_best_region(
        torch.from_numpy(vb), torch.from_numpy(vl),
        torch.from_numpy(totals), torch.from_numpy(ids),
        torch.from_numpy(qb), torch.from_numpy(ql), lo, 2, W=w,
        mode="fwd").numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any()


def test_select_best_ids_tie_goes_to_lowest_original_id():
    dist = torch.tensor([[1, 0, 2, 1]], dtype=torch.int32)
    vl = torch.tensor([3, 3, 3, 3], dtype=torch.int32)
    totals = torch.tensor([5, 5, 9, 5], dtype=torch.int64)
    ids = torch.tensor([30, 20, 10, 5], dtype=torch.int32)
    assert port_lev.select_best_ids(dist, vl, totals, ids, 1).tolist() \
        == [5]
    assert port_lev.select_best_ids(dist, vl, totals, ids, 2).tolist() \
        == [10]
    assert port_lev.select_best_ids(dist, vl, totals * 0, ids, 2) \
        .tolist() == [-1]



class _Host:
    """The part of a HostIndex the fuzzy matchers read."""

    def __init__(self, values, totals):
        self.term_values = list(values)
        self.totals = np.asarray(totals, dtype=np.int64)
        self.generation = 1

    @property
    def term_total(self):
        return type("Totals", (), {"view": lambda _: self.totals})()

    def grow(self, values, totals):
        self.term_values += values
        self.totals = np.concatenate([self.totals, totals])
        self.generation += 1


def _matcher_queries(rng, values, alpha):
    """Typos of dictionary terms, short tokens whose band holds no term,
    and tokens at the 31-34-byte edge of the device snapshot."""
    out = []
    for v in rng.choice(values, 40):
        b = list(v)
        at = int(rng.integers(0, len(b)))
        op = int(rng.integers(0, 3))
        ch = chr(alpha[rng.integers(0, len(alpha))])
        if op == 0:
            b[at] = ch
        elif op == 1:
            b.insert(at, ch)
        else:
            del b[at]
        out.append("".join(b))
    out += ["a", "ab", "abc", "abcab"]
    out += ["".join(chr(c) for c in alpha[rng.integers(0, len(alpha), n)])
            for n in (31, 32, 33, 34)]
    return list(dict.fromkeys(out))


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzzy_matcher_matches_reference(seed):
    """The port's FuzzyMatcher (exact length-band regions, snapshot of
    exactly n rows) resolves the same term ids as the reference's
    (pow2-padded regions), through prefetch and lookup, before and
    after the dictionary grows."""
    from nxsearch_tpu.fuzzy import FuzzyMatcher as RefMatcher
    from nxsearch_tpu_torch.fuzzy import _DEVICE_THRESHOLD
    from nxsearch_tpu_torch.fuzzy import FuzzyMatcher as PortMatcher

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abc", dtype=np.uint8)

    def words(n):
        lens = rng.integers(5, 41, size=n)
        return ["".join(chr(c) for c in alpha[rng.integers(0, 3, k)])
                for k in lens]

    values = list(dict.fromkeys(words(_DEVICE_THRESHOLD + 300)))
    host = _Host(values, rng.integers(0, 4, size=len(values)))
    ref, port = RefMatcher(host), PortMatcher(host, "cpu")
    for _ in range(2):
        queries = _matcher_queries(rng, host.term_values, alpha)
        want = [ref.lookup(q) for q in queries]
        port.prefetch(queries)
        assert [port.lookup(q) for q in queries] == want
        fresh = PortMatcher(host, "cpu")
        assert [fresh.lookup(q) for q in queries] == want
        assert any(w is not None for w in want)
        assert want[queries.index("ab")] is None
        added = [w for w in dict.fromkeys(words(500))
                 if w not in set(host.term_values)]
        host.grow(added, rng.integers(1, 4, size=len(added)))
