"""The transposed Myers kernel's query grouping: its plain mirror
(ops/kernels.py:rev_query_groups_ref), and distances computed through
the grouped tables it gives, as the kernel computes them, held to
nxsearch_tpu's Pallas kernel (interpret mode on the CPU), to the
forward twin and to the transposed twin's 256-row table.

Each launch is made with numpy from a seed so that the bytes its query
steps read span exactly ``sigma`` distinct values (0 and 255 among them
from two values up), with a 32-byte query, a q_len 0 row, terms of
length 0 and 32, term bytes no query holds, nonzero bytes past each
q_len (which no step reads), more queries than one chunk and a W that
is not a multiple of the kernel's 256-term block.  Distances are
integers: every comparison is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nxsearch_tpu.ops.pallas.fuzzy import myers_rev_distances_pallas_batch
from nxsearch_tpu_torch.ops import kernels

W = 32
SIGMAS = [1, 32, 33, 64, 65, 256]


def _launch(sigma, n_terms=300, n_queries=40):
    rng = np.random.default_rng(sigma)
    alphabet = np.array([255] if sigma == 1 else [0, 255] + [
        int(c) for c in rng.permutation(np.arange(1, 255))[: sigma - 2]],
        dtype=np.uint8)
    ql = rng.integers(1, W + 1, n_queries).astype(np.int32)
    ql[0], ql[-1] = W, 0
    qb = rng.integers(0, 256, (n_queries, W)).astype(np.uint8)
    read = np.arange(W)[None, :] < ql[:, None]
    qb[read] = alphabet[rng.integers(0, sigma, int(read.sum()))]
    rows, cols = np.nonzero(read)
    qb[rows[:sigma], cols[:sigma]] = rng.permutation(alphabet)
    vl = rng.integers(0, W + 1, n_terms).astype(np.int32)
    vl[:3], vl[3:6] = 0, W
    vb = np.where(rng.random((n_terms, W)) < 0.7,
                  alphabet[rng.integers(0, sigma, (n_terms, W))],
                  rng.integers(0, 256, (n_terms, W))).astype(np.uint8)
    vb[np.arange(W)[None, :] >= vl[:, None]] = 0
    assert len(np.unique(qb[read])) == sigma
    return vb, vl, qb, ql


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _groups(sigma):
    vb, vl, qb, ql = _launch(sigma)
    group, alphabets, rank = kernels.rev_query_groups_ref(*_t(qb, ql))
    sets = [set(qb[q, : max(ql[q], 0)].tolist()) for q in range(len(ql))]
    return qb, ql, group.numpy(), [a.numpy() for a in alphabets], \
        rank.numpy(), sets


def _grouped_rev_distances(vb, vl, qb, ql):
    """int32[M, W] by transposed Myers through rev_query_groups_ref's
    groups: per group a char table over its alphabet alone (row a, bit
    j of column t set where term_t[j] is the group's a-th byte and
    j < n_t), each of its queries stepping through its ranks' rows."""
    vb, vl, qb, ql = _t(vb, vl, qb, ql)
    n_q, n_t = qb.shape[0], vb.shape[0]
    group, alphabets, rank = kernels.rev_query_groups_ref(qb, ql)
    pos = torch.arange(W, dtype=torch.int64)
    live = pos[None, :] < vl.to(torch.int64)[:, None]
    lane = torch.arange(n_t)[:, None].expand(n_t, W)
    bits = (1 << pos).expand(n_t, W)
    mask_n, high_bit = (x[None, :] for x in kernels._masks(vl))
    score = vl[None, :].expand(n_q, n_t).clone()
    for g, alphabet in enumerate(alphabets):
        rows = (group == g).nonzero()[:, 0]
        lut = torch.full((256,), -1, dtype=torch.int64)
        lut[alphabet] = torch.arange(len(alphabet))
        a = lut[vb.to(torch.int64)]
        hit = live & (a >= 0)
        table = torch.zeros((max(len(alphabet), 1), n_t), dtype=torch.int64)
        table.index_put_((a[hit], lane[hit]), bits[hit], accumulate=True)
        pv = mask_n.expand(len(rows), n_t).clone()
        mv = torch.zeros((len(rows), n_t), dtype=torch.int64)
        sc = score[rows]
        r = rank[rows].clamp(min=0)
        for i in range(W):
            pv, mv, sc = kernels._myers_step(
                table[r[:, i]], pv, mv, sc, (i < ql[rows])[:, None], mask_n,
                high_bit)
        score[rows] = sc
    return score.numpy()


@pytest.mark.parametrize("sigma", SIGMAS)
def test_each_query_in_one_group_of_its_chunk(sigma):
    """Groups partition the queries into runs that never cross a chunk
    of REV_CHUNK, numbered in order with none empty."""
    _qb, ql, group, alphabets, _rank, _sets = _groups(sigma)
    assert group.shape == (len(ql),)
    assert group[0] == 0 and np.all(np.diff(group) >= 0)
    assert np.all(np.diff(group) <= 1)
    assert sorted(set(group.tolist())) == list(range(len(alphabets)))
    for g in range(len(alphabets)):
        members = np.nonzero(group == g)[0]
        assert len({q // kernels.REV_CHUNK for q in members}) == 1
    starts = np.arange(0, len(ql), kernels.REV_CHUNK)
    assert np.all(np.diff(group)[starts[1:] - 1] == 1)


@pytest.mark.parametrize("sigma", SIGMAS)
def test_group_alphabet_is_the_union_and_fits_the_table(sigma):
    """Each group's alphabet is the ascending union of its queries'
    read bytes and holds at most REV_SIGMA; a group ends only where its
    next query in the chunk would overflow it (greedy)."""
    _qb, ql, group, alphabets, _rank, sets = _groups(sigma)
    covered = set()
    for g, alphabet in enumerate(alphabets):
        members = np.nonzero(group == g)[0]
        union = set().union(*(sets[q] for q in members))
        assert alphabet.tolist() == sorted(union)
        assert len(alphabet) <= kernels.REV_SIGMA
        nxt = members[-1] + 1
        if nxt < len(ql) and nxt % kernels.REV_CHUNK:
            assert len(union | sets[nxt]) > kernels.REV_SIGMA
        covered |= union
    assert len(covered) == sigma
    if sigma <= kernels.REV_SIGMA:
        assert len(alphabets) == -(-len(ql) // kernels.REV_CHUNK)


@pytest.mark.parametrize("sigma", SIGMAS)
def test_ranks_index_their_own_group_alphabet(sigma):
    qb, ql, group, alphabets, rank, _sets = _groups(sigma)
    read = np.arange(W)[None, :] < ql[:, None]
    assert np.all(rank[~read] == -1)
    for q, i in zip(*np.nonzero(read)):
        assert alphabets[group[q]][rank[q, i]] == qb[q, i]


@pytest.mark.parametrize("sigma", SIGMAS)
def test_grouped_twin_matches_pallas_interpret(sigma):
    """Against the TPU kernel, whose 256-row table also holds the zero
    padding's bits: equal on every live lane (n == 0 lanes differ)."""
    vb, vl, qb, ql = _launch(sigma)
    want = np.asarray(myers_rev_distances_pallas_batch(
        jnp.asarray(np.ascontiguousarray(vb.T)), jnp.asarray(vl[None, :]),
        jnp.asarray(qb.astype(np.int32)), jnp.asarray(ql[:, None]),
        interpret=True, block=len(vl)))
    got = _grouped_rev_distances(vb, vl, qb, ql)
    live = vl > 0
    np.testing.assert_array_equal(got[:, live], want[:, live])


@pytest.mark.parametrize("sigma", SIGMAS)
def test_grouped_twin_matches_forward_twin(sigma):
    """Every lane and row, n == 0 terms and the q_len 0 row included."""
    launch = _launch(sigma)
    np.testing.assert_array_equal(
        _grouped_rev_distances(*launch),
        kernels.myers_distances_ref(*_t(*launch)).numpy())


@pytest.mark.parametrize("sigma", SIGMAS)
def test_grouped_tables_match_the_full_table_twin(sigma):
    """The rows a group's table leaves out are never read: the grouped
    sweep equals myers_rev_distances_ref's 256-row table everywhere."""
    launch = _launch(sigma)
    np.testing.assert_array_equal(
        _grouped_rev_distances(*launch),
        kernels.myers_rev_distances_ref(*_t(*launch)).numpy())
