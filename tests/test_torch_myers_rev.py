"""Transposed Myers, the single-query sweep and the rest of
ops/levenshtein: the port's plain twins, entry points and rev-mode
matcher held to nxsearch_tpu's Pallas kernels (interpret mode on the
CPU) and jnp sweep.

Inputs are made with numpy from a seed and handed to both packages.
Distances are integers: every comparison is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nxsearch_tpu.ops import levenshtein as ref_lev
from nxsearch_tpu.ops.pallas.fuzzy import (myers_distances_pallas,
                                           myers_rev_distances_pallas_batch)
from nxsearch_tpu_torch import fuzzy as port_fuzzy
from nxsearch_tpu_torch.ops import kernels
from nxsearch_tpu_torch.ops import levenshtein as port_lev
from test_torch_myers import (W, _Host, _matcher_queries, _region_inputs,
                              _rows)


def _inputs(seed, n_terms=512, n_queries=8, alphabet=b"abcde"):
    """Terms with lengths 1..32 (some exactly 32) and 4 pad lanes of
    length 0 at the end; queries with a 32-byte row and a q_len 0 row."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, dtype=np.uint8)
    vb, vl = _rows(rng, n_terms, 1, W, alpha)
    vl[:6] = W
    vb[:6] = alpha[rng.integers(0, len(alpha), size=(6, W))]
    vb[-4:], vl[-4:] = 0, 0
    qb, ql = _rows(rng, n_queries, 1, W, alpha)
    ql[0] = W
    qb[0] = alpha[rng.integers(0, len(alpha), size=W)]
    qb[-1], ql[-1] = 0, 0
    return vb, vl, qb, ql


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rev(vb, vl, qb, ql):
    return kernels.myers_rev_distances_ref(*_t(vb, vl, qb, ql)).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_rev_ref_matches_pallas_interpret(seed):
    """Against the TPU kernel, whose table also holds the zero padding's
    bits: equal on every live lane (the pad lanes' n == 0 differs)."""
    vb, vl, qb, ql = _inputs(seed)
    want = np.asarray(myers_rev_distances_pallas_batch(
        jnp.asarray(np.ascontiguousarray(vb.T)), jnp.asarray(vl[None, :]),
        jnp.asarray(qb.astype(np.int32)), jnp.asarray(ql[:, None]),
        interpret=True, block=256))
    got = _rev(vb, vl, qb, ql)
    live = vl > 0
    np.testing.assert_array_equal(got[:, live], want[:, live])


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_rev_ref_matches_forward_twin(seed):
    """Edit distance is symmetric: the transposed sweep equals the
    forward twin on every lane, pad lanes and the q_len 0 row included."""
    vb, vl, qb, ql = _inputs(seed, n_terms=700, n_queries=12)
    want = kernels.myers_distances_ref(*_t(vb, vl, qb, ql)).numpy()
    np.testing.assert_array_equal(_rev(vb, vl, qb, ql), want)


@pytest.mark.parametrize("seed", [5, 6])
def test_rev_ref_matches_jnp_every_lane(seed):
    """Against the jnp sweep over the full byte range 1..255, on every
    lane and row."""
    vb, vl, qb, ql = _inputs(seed, n_terms=300, n_queries=10,
                             alphabet=bytes(range(1, 256)))
    got = _rev(vb, vl, qb, ql)
    for i in range(len(ql)):
        want = np.asarray(ref_lev.myers_distances(
            jnp.asarray(vb), jnp.asarray(vl), jnp.asarray(qb[i]),
            jnp.int32(ql[i])))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("seed", [7, 8])
def test_one_query_ref_matches_jnp_and_pallas(seed):
    """The single-query plain sweep against the jnp sweep it ports (every
    lane, q_len 0 included) and the single-query Pallas kernel."""
    vb, vl, qb, ql = _inputs(seed, n_terms=512, n_queries=5)
    vb_t = jnp.asarray(np.ascontiguousarray(vb.T))
    for i in range(len(ql)):
        got = kernels.myers_distances_one_ref(
            *_t(vb, vl, qb[i]), int(ql[i])).numpy()
        want = np.asarray(ref_lev.myers_distances(
            jnp.asarray(vb), jnp.asarray(vl), jnp.asarray(qb[i]),
            jnp.int32(ql[i])))
        np.testing.assert_array_equal(got, want)
        if ql[i]:
            pallas = np.asarray(myers_distances_pallas(
                vb_t, jnp.asarray(vl[None, :]),
                jnp.asarray(qb[i].astype(np.int32)[None, :]),
                jnp.asarray([[ql[i]]], np.int32), interpret=True))[0]
            np.testing.assert_array_equal(got, pallas)


def _selection_inputs(seed, n_terms=512, n_queries=6):
    """Vocabulary rows (row 0 live), popularity totals full of ties and
    zeros, and queries near some terms, one without any term in reach."""
    rng = np.random.default_rng(seed)
    vb, vl, qb, ql = _inputs(seed, n_terms, n_queries, alphabet=b"abc")
    vl[:40] = rng.integers(2, 6, 40)
    vb[:40] = np.frombuffer(b"abc", np.uint8)[rng.integers(0, 3, (40, W))]
    vb[:40][np.arange(W)[None, :] >= vl[:40, None]] = 0
    qb[1:4], ql[1:4] = vb[[3, 9, 17]], vl[[3, 9, 17]]
    totals = rng.integers(0, 3, n_terms).astype(np.int64)
    return vb, vl, totals, qb, ql


@pytest.mark.parametrize("seed", [0, 1])
def test_select_best_matches_reference(seed):
    """Winner row and its distance, for every row of a distance matrix
    and for one row alone, the no-winner case included."""
    vb, vl, totals, qb, ql = _selection_inputs(seed)
    dist = kernels.myers_distances_ref(*_t(vb, vl, qb, ql))
    got_i, got_d = port_lev.select_best(dist, torch.from_numpy(vl),
                                        torch.from_numpy(totals), 2)
    for i in range(len(ql)):
        want_i, want_d = ref_lev.select_best(
            jnp.asarray(dist[i].numpy()), jnp.asarray(vl),
            jnp.asarray(totals.astype(np.uint32)), 2)
        one_i, one_d = port_lev.select_best(dist[i], torch.from_numpy(vl),
                                            torch.from_numpy(totals), 2)
        assert (int(got_i[i]), int(got_d[i])) == (int(want_i), int(want_d))
        assert (int(one_i), int(one_d)) == (int(want_i), int(want_d))
    assert (got_i >= 0).any() and (got_i == -1).any()


def _ref_args(vb, vl, totals, qb, ql, position_major):
    vocab = np.ascontiguousarray(vb.T) if position_major else vb
    return [jnp.asarray(vocab), jnp.asarray(vl),
            jnp.asarray(totals.astype(np.uint32)), jnp.asarray(qb),
            jnp.asarray(ql)]


@pytest.mark.parametrize("seed", [2, 3])
def test_fuzzy_best_matches_reference(seed):
    """fuzzy_best (one query) and fuzzy_best_batch against the
    reference's jnp functions."""
    vb, vl, totals, qb, ql = _selection_inputs(seed)
    port = _t(vb, vl, totals)
    want = ref_lev.fuzzy_best_batch(
        *_ref_args(vb, vl, totals, qb, ql, False), jnp.int32(2))
    got = port_lev.fuzzy_best_batch(*port, *_t(qb, ql), 2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for i in range(len(ql)):
        want = ref_lev.fuzzy_best(
            *_ref_args(vb, vl, totals, qb[i], ql[i], False), jnp.int32(2))
        got = port_lev.fuzzy_best(*port, torch.from_numpy(qb[i]),
                                  int(ql[i]), 2)
        assert [int(x) for x in got] == [int(x) for x in want]


@pytest.mark.parametrize("seed", [4])
def test_kernel_entries_match_reference_pallas(seed):
    """fuzzy_best_kernel, fuzzy_best_kernel_batch and
    fuzzy_best_kernel_batch_rev against fuzzy_best_pallas,
    fuzzy_best_pallas_batch and fuzzy_best_pallas_batch_rev, the TPU
    kernels in interpret mode."""
    vb, vl, totals, qb, ql = _selection_inputs(seed)
    port = _t(vb, vl, totals)
    tol = jnp.int32(2)
    with pltpu.force_tpu_interpret_mode():
        for ref_fn, port_fn in (
                (ref_lev.fuzzy_best_pallas_batch,
                 port_lev.fuzzy_best_kernel_batch),
                (ref_lev.fuzzy_best_pallas_batch_rev,
                 port_lev.fuzzy_best_kernel_batch_rev)):
            want = ref_fn(*_ref_args(vb, vl, totals, qb, ql, True), tol)
            got = port_fn(*port, *_t(qb, ql), 2)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for i in range(1, 4):
            want = ref_lev.fuzzy_best_pallas(
                *_ref_args(vb, vl, totals, qb[i], ql[i], True), tol)
            got = port_lev.fuzzy_best_kernel(
                *port, torch.from_numpy(qb[i]), int(ql[i]), 2)
            assert [int(x) for x in got] == [int(x) for x in want]
            assert int(got[0]) >= 0


@pytest.mark.parametrize("mode", ["rev", "fwd"])
@pytest.mark.parametrize("seed,lo,w", [(0, 0, 1024), (1, 100, 512),
                                       (3, 500, 256)])
def test_fuzzy_best_region_modes_match_reference(seed, lo, w, mode):
    """Both sweep modes give the winning original ids of the reference's
    jnp region sweep."""
    vb, vl, totals, ids, qb, ql = _region_inputs(seed)
    want = np.asarray(ref_lev.fuzzy_best_region(
        jnp.asarray(vb), jnp.asarray(vl),
        jnp.asarray(totals.astype(np.uint32)), jnp.asarray(ids),
        jnp.asarray(qb), jnp.asarray(ql), jnp.int32(lo), jnp.int32(2),
        W=w, mode="jnp"))
    got = port_lev.fuzzy_best_region(
        *_t(vb, vl, totals, ids, qb, ql), lo, 2, W=w, mode=mode).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any()


def test_fuzzy_best_region_rejects_unknown_mode():
    vb, vl, totals, ids, qb, ql = _region_inputs(0)
    with pytest.raises(ValueError, match="unknown mode 'jnp'"):
        port_lev.fuzzy_best_region(*_t(vb, vl, totals, ids, qb, ql), 0, 2,
                                   W=256, mode="jnp")


@pytest.fixture
def twin_runs(monkeypatch):
    """Count the runs of each Myers twin (the CPU's stand-ins for the
    kernels)."""
    runs = {"fwd": 0, "one": 0, "rev": 0}
    for key, name in (("fwd", "myers_distances_ref"),
                      ("one", "myers_distances_one_ref"),
                      ("rev", "myers_rev_distances_ref")):
        def counted(*a, _fn=getattr(kernels, name), _key=key, **kw):
            runs[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(kernels, name, counted)
    return runs


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzzy_matcher_rev_matches_reference(seed, monkeypatch, twin_runs):
    """With NXS_FUZZY_REV's flag on, the port's matcher resolves the
    reference matcher's term ids through prefetch and lookup, before
    and after the dictionary grows, and never runs a forward sweep."""
    from nxsearch_tpu.fuzzy import FuzzyMatcher as RefMatcher

    monkeypatch.setattr(port_fuzzy, "_USE_REV_KERNEL", True)
    rng = np.random.default_rng(seed + 10)
    alpha = np.frombuffer(b"abc", dtype=np.uint8)

    def words(n):
        lens = rng.integers(5, 41, size=n)
        return ["".join(chr(c) for c in alpha[rng.integers(0, 3, k)])
                for k in lens]

    values = list(dict.fromkeys(words(port_fuzzy._DEVICE_THRESHOLD + 300)))
    host = _Host(values, rng.integers(0, 4, size=len(values)))
    ref = RefMatcher(host)
    port = port_fuzzy.FuzzyMatcher(host, "cpu")
    assert port._mode == "rev"
    for _ in range(2):
        queries = _matcher_queries(rng, host.term_values, alpha)
        want = [ref.lookup(q) for q in queries]
        port.prefetch(queries)
        assert [port.lookup(q) for q in queries] == want
        fresh = port_fuzzy.FuzzyMatcher(host, "cpu")
        assert [fresh.lookup(q) for q in queries] == want
        assert any(w is not None for w in want)
        added = [w for w in dict.fromkeys(words(500))
                 if w not in set(host.term_values)]
        host.grow(added, rng.integers(1, 4, size=len(added)))
    assert twin_runs["rev"] > 0
    assert twin_runs["fwd"] == twin_runs["one"] == 0


def test_lookup_takes_single_query_sweep(twin_runs):
    """In the default mode a lookup's one-row sweep is the single-query
    one; prefetch's chunks of several rows take the batched sweep."""
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"abcd", dtype=np.uint8)
    values = list(dict.fromkeys(
        "".join(chr(c) for c in alpha[rng.integers(0, 4, k)])
        for k in rng.integers(7, 12, port_fuzzy._DEVICE_THRESHOLD + 500)))
    assert len(values) >= port_fuzzy._DEVICE_THRESHOLD
    host = _Host(values, rng.integers(1, 4, size=len(values)))
    matcher = port_fuzzy.FuzzyMatcher(host, "cpu")
    assert matcher._mode == "fwd"
    matcher.lookup(values[7] + "a")
    assert twin_runs == {"fwd": 0, "one": 1, "rev": 0}
    # Five misses of one length: one region, one chunk of five rows.
    matcher.prefetch([v + "b" for v in values if len(v) == 9][:5])
    assert twin_runs == {"fwd": 1, "one": 1, "rev": 0}


def test_wrappers_raise_for_non_cpu_tensors():
    """No silent fallback: on a tensor that is not on the CPU, the rev
    wrapper and the single-query route launch a kernel or raise."""
    t = torch.zeros((4, W), dtype=torch.uint8, device="meta")
    n = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        kernels.myers_rev_distances(t, n, t, n)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        kernels.myers_distances(t, n, t[:1], n[:1])


def test_wrappers_take_twins_for_cpu_tensors():
    """CPU tensors run the twins and count no launch; M == 1 takes the
    single-query twin."""
    vb, vl, qb, ql = _t(*_inputs(9, n_terms=200, n_queries=6))
    before = (kernels.MYERS.launches, kernels.MYERS_ONE.launches,
              kernels.MYERS_REV.launches)
    assert torch.equal(kernels.myers_rev_distances(vb, vl, qb, ql),
                       kernels.myers_rev_distances_ref(vb, vl, qb, ql))
    one = kernels.myers_distances(vb, vl, qb[:1], ql[:1])
    assert one.shape == (1, 200)
    assert torch.equal(one[0], kernels.myers_distances_one_ref(
        vb, vl, qb[0], ql[:1]))
    assert torch.equal(one, kernels.myers_distances_ref(vb, vl, qb[:1],
                                                        ql[:1]))
    assert (kernels.MYERS.launches, kernels.MYERS_ONE.launches,
            kernels.MYERS_REV.launches) == before
