"""Blockdense parity: the port's segsum twin, block bounds, bounds cache
and blockdense executor held to nxsearch_tpu's on identical inputs.

The reference's Pallas kernel runs in interpret mode on the CPU (as its
own tests run it); the port runs its kernel's plain twin
(ops/kernels.py:blockdense_scores_ref), as every CPU tensor does.
Inputs are random slot-sorted CSR postings made with numpy: empty
terms, terms whose postings straddle 1024-slot block boundaries, an
all-zero (dense-handled) bounds row, a term in bit 31's place.
Tolerances: bounds rows, cache rows and presence bits exact; scores
within 1e-6 relative (the same f32 operations in the same order, so
in practice equal); top-k slots identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from nxsearch_tpu import Nxs as JNxs
from nxsearch_tpu.index.device import DeviceIndex as JDeviceIndex
from nxsearch_tpu.ops import executor as jexec
from nxsearch_tpu.ops.pallas import segsum as jsegsum
from nxsearch_tpu_torch.index.device import DeviceIndex as PDeviceIndex
from nxsearch_tpu_torch.ops import executor as pexec
from nxsearch_tpu_torch.ops import kernels
from nxsearch_tpu_torch.ops.boolean import EMPTY_LEAF_BIT, compile_program

from test_torch_boolean import random_tree
from test_torch_executor import export_arrays

S = 4096                 # 4 blocks of 1024 slots
G = S // 1024
RTOL = 1e-6
C1 = np.float32(1.2 * 0.25)


def make_csr(seed, lens, n_slots=S, slots=None):
    """Slot-sorted CSR postings of len(lens) terms over n_slots slots
    (random ones, or term i's ``slots[i]``), plus doc lengths and an
    alive bitmap with a few dead slots."""
    rng = np.random.default_rng(seed)
    starts, slot, ltf = [], [], []
    pos = 0
    for i, n in enumerate(lens):
        starts.append(pos)
        slot.append(np.sort(rng.choice(n_slots, size=n, replace=False))
                    if slots is None else np.sort(slots[i]))
        ltf.append(np.log(rng.integers(1, 6, n) + 1.0))
        pos += n
    # Zero padding rows past the CSR, to a multiple of 1024 as in every
    # snapshot: the Pallas kernel's aligned 1024-posting chunk reads
    # assume it (near the end of a shorter array it reads one chunk
    # twice).
    p_pad = -(-(pos + 64) // 1024) * 1024
    ps = np.zeros(p_pad, np.int32)
    pf = np.zeros(p_pad, np.float32)
    ps[:pos] = np.concatenate(slot)
    pf[:pos] = np.concatenate(ltf)
    dlen = rng.integers(5, 60, n_slots).astype(np.float32)
    alive = rng.random(n_slots) > 0.02
    amask = np.packbits(alive, bitorder="little").view(np.uint32)
    return (ps, pf, dlen, amask, np.asarray(starts, np.int32),
            np.asarray(lens, np.int32))


# Per term: empty, sparse, block-straddling, dense, one posting.
LENS = [0, 7, 900, 1500, 3000, 1, 260, 2048, 40, 700, 5]


def ref_bounds(ps, starts, lens, n_blocks=G):
    return np.asarray(jsegsum.csr_block_bounds(
        jnp.asarray(ps), jnp.asarray(starts), jnp.asarray(lens),
        n_blocks=n_blocks))


def test_csr_block_bounds_matches_reference():
    ps, _pf, _dl, _am, starts, lens = make_csr(1, LENS)
    want = ref_bounds(ps, starts, lens)
    got = pexec.csr_block_bounds(torch.from_numpy(ps),
                                 torch.from_numpy(starts),
                                 torch.from_numpy(lens), n_blocks=G)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 1:] > want[:, :-1]).any()       # real block splits


def _bounds_for(ps, starts, lens, rows, n_blocks=G):
    """[N, Q, G+1] bounds: row r of query n is term rows[n][q] (-1: the
    all-zero row of padding and dense-handled terms)."""
    b = ref_bounds(ps, starts, lens, n_blocks)
    out = np.zeros((len(rows), len(rows[0]), n_blocks + 1), np.int32)
    for n, terms in enumerate(rows):
        for q, t in enumerate(terms):
            if t >= 0:
                out[n, q] = b[t]
    return out


def _twin_case(case):
    """(csr, bounds rows) of a twin-vs-Pallas case.  "mixed": terms of
    LENS in two rows.  "rows_apart": every term's postings lie in one
    block, and rows 0-3 hold terms of blocks 0-3 only (row 1 two terms of
    block 1), so each row is empty in all but one block and row 4 in
    all.  "full_block": term 0 holds all 1024 slots of block 2, term 1
    500 random slots, in both rows."""
    if case == "mixed":
        return make_csr(2, LENS), [[1, 2, 3, 0, -1, 4, 5, 6],
                                   [7, 8, 9, 10, 2, 3, -1, -1]]
    rng = np.random.default_rng(5)
    if case == "rows_apart":
        slots = [1024 * b + rng.choice(1024, size=n, replace=False)
                 for b, n in ((0, 300), (1, 5), (2, 1000), (3, 64),
                              (1, 700))]
        rows = [[0, -1, -1, -1, -1, -1, -1, -1],
                [-1, 1, 4, -1, -1, -1, -1, -1],
                [2, -1, -1, -1, -1, -1, -1, -1],
                [-1, -1, -1, 3, -1, -1, -1, -1],
                [-1] * 8]
    else:
        slots = [np.arange(2048, 3072), rng.choice(S, size=500,
                                                   replace=False)]
        rows = [[0, 1, -1, -1, -1, -1, -1, -1],
                [1, -1, 0, -1, -1, -1, -1, -1]]
    return make_csr(6, [len(x) for x in slots], slots=slots), rows


@pytest.mark.parametrize("algo,use_mask,case", [
    pytest.param(0, False, "mixed", id="0-False"),
    pytest.param(0, True, "mixed", id="0-True"),
    pytest.param(1, False, "mixed", id="1-False"),
    pytest.param(1, True, "mixed", id="1-True"),
    pytest.param(0, True, "rows_apart", id="rows-apart-0-True"),
    pytest.param(1, False, "rows_apart", id="rows-apart-1-False"),
    pytest.param(0, True, "full_block", id="full-block-0-True"),
    pytest.param(1, True, "full_block", id="full-block-1-True"),
])
def test_blockdense_scores_twin_matches_pallas(algo, use_mask, case):
    (ps, pf, dl, am, starts, lens), rows = _twin_case(case)
    bounds = _bounds_for(ps, starts, lens, rows)
    rng = np.random.default_rng(3)
    n_rows = len(rows)
    coef = np.zeros((n_rows, 8, 4), np.float32)
    coef[..., 0] = rng.uniform(0.2, 3.0, (n_rows, 8))
    coef[..., 1] = C1
    coef[..., 2] = np.float32(1.2 * 0.75) / np.float32(31.0)
    want_s, want_b = jsegsum.blockdense_scores(
        jnp.asarray(ps), jnp.asarray(pf), jnp.asarray(dl), jnp.asarray(am),
        jnp.asarray(bounds), jnp.asarray(coef), n_slots=S, algo=algo,
        use_mask=use_mask, interpret=True)
    alive_f = pexec.alive_factors(torch.from_numpy(am.view(np.int32)))
    got_s, got_b = kernels.blockdense_scores(
        torch.from_numpy(ps), torch.from_numpy(pf), torch.from_numpy(dl),
        alive_f, torch.from_numpy(bounds), torch.from_numpy(coef),
        algo=algo, use_mask=use_mask)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=RTOL, atol=0)
    np.testing.assert_array_equal(got_b.numpy().view(np.uint32),
                                  np.asarray(want_b))
    want_s = np.asarray(want_s)
    assert (want_s > 0).sum() > 1000
    if case == "rows_apart":
        for r, blk in enumerate((0, 1, 2, 3)):
            outside = np.ones(S, bool)
            outside[1024 * blk: 1024 * (blk + 1)] = False
            assert (want_s[r, ~outside] > 0).any()
            assert not want_s[r, outside].any()
        assert not want_s[4].any() and not got_b[4].any()
    if case == "full_block" and use_mask:
        assert (np.asarray(want_b)[0, 2048:3072] & 1).all()


def test_blockdense_scores_twin_sets_bit_31():
    """A 32-term group puts term 31's presence in the sign bit of the
    int32 word; the u32 view equals the reference's bits (one block,
    to keep the 32-term interpret-mode kernel short)."""
    lens = [30 + i for i in range(32)]
    ps, pf, dl, am, starts, lens = make_csr(4, lens, n_slots=1024)
    bounds = _bounds_for(ps, starts, lens, [list(range(32))], n_blocks=1)
    coef = np.zeros((1, 32, 4), np.float32)
    coef[..., 0], coef[..., 1], coef[..., 2] = 1.5, C1, 0.03
    want_s, want_b = jsegsum.blockdense_scores(
        jnp.asarray(ps), jnp.asarray(pf), jnp.asarray(dl), jnp.asarray(am),
        jnp.asarray(bounds), jnp.asarray(coef), n_slots=1024, algo=0,
        use_mask=True, interpret=True)
    got_s, got_b = kernels.blockdense_scores_ref(
        torch.from_numpy(ps), torch.from_numpy(pf), torch.from_numpy(dl),
        pexec.alive_factors(torch.from_numpy(am.view(np.int32))),
        torch.from_numpy(bounds), torch.from_numpy(coef), algo=0,
        use_mask=True)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=RTOL, atol=0)
    got_u = got_b.numpy().view(np.uint32)
    np.testing.assert_array_equal(got_u, np.asarray(want_b))
    assert (got_u >> 31).any()


def _program_rows(seed, n_rows, n_terms, prog_len=16):
    rng = np.random.default_rng(seed)
    ops = np.zeros((n_rows, prog_len), np.int32)
    args = np.zeros((n_rows, prog_len), np.int32)
    for r in range(n_rows):
        while True:
            o, a, depth = compile_program(
                random_tree(rng, int(rng.integers(2, 6)), n_terms),
                lambda t: EMPTY_LEAF_BIT if t is None else t)
            if depth <= 8 and len(o) <= prog_len:
                break
        ops[r, :len(o)], args[r, :len(a)] = o, a
    return ops, args


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("algo", [0, 1])
def test_blockdense_topk_bounds_matches_reference(algo, use_mask):
    """Dense-row terms, a 10-term query (two kernel groups, bits of the
    second shifted by 8), padded rows and the program gate."""
    ps, pf, dl, am, starts, lens = make_csr(5, LENS)
    n_rows, q = 3, 16
    terms = [[3, 2, 1, 6, 8, 9, 10, 5, 7, 4],
             [4, 6, 2, 9],
             [7, 3, 1]]
    # Terms 3 and 4 (the widest) have dense rows (row 0 / row 1).
    dense_of = {3: 0, 4: 1}
    dense_rows = np.zeros((2, S), np.float32)
    for t, r in dense_of.items():
        s = starts[t]
        dense_rows[r, ps[s: s + lens[t]]] = pf[s: s + lens[t]]
    d_qpos = np.full((n_rows, 4), -1, np.int32)
    d_row = np.full((n_rows, 4), -1, np.int32)
    rows = np.full((n_rows, q), -1, np.int64)
    q_idf = np.zeros((n_rows, q), np.float32)
    rng = np.random.default_rng(6)
    for n, ts in enumerate(terms):
        j = 0
        for i, t in enumerate(ts):
            q_idf[n, i] = rng.uniform(0.2, 3.0)
            if t in dense_of:
                d_qpos[n, j], d_row[n, j] = i, dense_of[t]
                j += 1
            else:
                rows[n, i] = t
    bounds = _bounds_for(ps, starts, lens, rows.tolist())
    prog_ops, prog_args = _program_rows(7, n_rows, len(terms[0]))
    adl = np.float32(31.0)
    k = 64
    want_s, want_i = jexec.blockdense_topk_bounds(
        jnp.asarray(ps), jnp.asarray(pf), jnp.asarray(dl), jnp.asarray(am),
        jnp.asarray(bounds), jnp.asarray(q_idf), jnp.float32(adl),
        jnp.asarray(prog_ops), jnp.asarray(prog_args),
        jnp.asarray(dense_rows), jnp.asarray(d_qpos), jnp.asarray(d_row),
        k=k, algo=algo, n_slots=S, use_mask=use_mask, depth=8,
        interpret=True, use_rows=True)
    t = torch.from_numpy
    got_s, got_i = pexec.blockdense_topk_bounds(
        t(ps), t(pf), t(dl), t(am.view(np.int32)), t(bounds), t(q_idf),
        torch.tensor(adl), t(prog_ops), t(prog_args), t(dense_rows),
        t(d_qpos), t(d_row), k=k, algo=algo, n_slots=S,
        use_mask=use_mask, depth=8, use_rows=True)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=RTOL, atol=0)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert (np.asarray(want_s) > 0).sum() > n_rows


def test_blockdense_ranges_entry_matches_bounds_entry():
    """blockdense_topk (bounds from the CSR ranges, dense-handled rows
    collapsed) equals blockdense_topk_bounds on precomputed rows, and
    the single-query entry unpacks the same answer."""
    ps, pf, dl, am, starts, lens = make_csr(8, LENS)
    ts = [2, 3, 6, 9]
    q_start = np.zeros((1, 8), np.int32)
    q_len = np.zeros((1, 8), np.int32)
    q_start[0, :4], q_len[0, :4] = starts[ts], lens[ts]
    q_idf = np.zeros((1, 8), np.float32)
    q_idf[0, :4] = [0.5, 1.5, 2.0, 0.7]
    d_qpos = np.asarray([[1, -1, -1, -1]], np.int32)
    d_row = np.asarray([[0, -1, -1, -1]], np.int32)
    dense_rows = np.zeros((1, S), np.float32)
    s, n = starts[3], lens[3]
    dense_rows[0, ps[s: s + n]] = pf[s: s + n]
    ops = np.asarray([[1, 1, 2, 1, 4, 0, 0, 0]], np.int32)   # (0 AND 1) NOT 2
    args = np.asarray([[0, 1, 0, 2, 0, 0, 0, 0]], np.int32)
    t = torch.from_numpy
    common = (t(ps), t(pf), t(dl), t(am.view(np.int32)))
    kw = dict(k=32, algo=0, n_slots=S, use_mask=True, depth=4,
              use_rows=True)
    adl = torch.tensor(np.float32(31.0))
    want = pexec.blockdense_topk_bounds(
        *common, t(_bounds_for(ps, starts, lens, [[2, -1, 6, 9, -1, -1,
                                                   -1, -1]])),
        t(q_idf), adl, t(ops), t(args), t(dense_rows), t(d_qpos), t(d_row),
        **kw)
    got = pexec.blockdense_topk(
        *common, t(q_start), t(q_len), t(q_idf), adl, t(ops), t(args),
        t(dense_rows), t(d_qpos), t(d_row), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    scores, slots = pexec.device_search_blockdense(
        *common, t(q_start[0]), t(q_len[0]), t(q_idf[0]), adl, t(ops[0]),
        t(args[0]), t(dense_rows), t(d_qpos[0]), t(d_row[0]), **kw)
    np.testing.assert_array_equal(scores, want[0][0].numpy())
    np.testing.assert_array_equal(slots, want[1][0].numpy())
    assert (scores > 0).any()


# -- the per-term bounds cache against the reference's ------------------

N_DOCS, VOCAB = 2500, 3000


@pytest.fixture(scope="module")
def small_index(tmp_path_factory):
    nxs = JNxs(str(tmp_path_factory.mktemp("bounds")))
    idx = nxs.index_create("t")
    idx.add_many(bench.zipf_range(0, N_DOCS, VOCAB, 20))
    idx._read_synced()
    idx._rw.read_release()
    yield idx
    nxs.close()


def _assert_same_cache(jdev, pdev):
    assert list(pdev._bounds_map.items()) == list(jdev._bounds_map.items())
    np.testing.assert_array_equal(pdev._bounds_cache.numpy(),
                                  np.asarray(jdev._bounds_cache))


def test_bounds_crows_and_lru_match_reference(small_index, monkeypatch):
    """Hits, misses, terms without base postings (row 0), duplicate
    terms in one call and LRU eviction under a 6-row cache; then a
    snapshot carried across with its cache (from_arrays) continues in
    step."""
    for cls in (JDeviceIndex, PDeviceIndex):
        monkeypatch.setattr(cls, "BOUNDS_CACHE_ROWS", 6)
    jdev = small_index.dev
    monkeypatch.setattr(jdev, "_bounds_cache", None)
    monkeypatch.setattr(jdev, "_bounds_map", None)
    pdev = PDeviceIndex.from_arrays(small_index.host, export_arrays(jdev),
                                    "cpu")
    absent = jdev.base_nterms + 5          # no base postings: row 0
    calls = [[1, 2, 3], [2, 4, absent, 4], [5, 6], [7, 1], [8, 9, 10],
             [3, 11, 2], [1, 1, 12, 13]]
    for i, tids in enumerate(calls):
        assert pdev.bounds_crows(tids) == jdev.bounds_crows(tids), tids
        _assert_same_cache(jdev, pdev)
        if i == 3:
            carried = PDeviceIndex.from_arrays(
                small_index.host,
                dict(export_arrays(jdev),
                     bounds_cache=np.asarray(jdev._bounds_cache),
                     bounds_map=jdev._bounds_map), "cpu")
    assert len(jdev._bounds_map) == 5      # evictions happened
    for tids in calls[4:]:
        carried.bounds_crows(tids)
    _assert_same_cache(jdev, carried)


def test_bounds_cache_resets_on_rebuild(tmp_path):
    """A full rebuild drops the cache and the derived columns."""
    from nxsearch_tpu_torch import Nxs
    nxs = Nxs(str(tmp_path), device="cpu")
    idx = nxs.index_create("t")
    idx.add_many(bench.zipf_range(0, 300, 200, 10))
    idx.search("w00001 AND w00002")
    dev = idx.dev
    dev.bounds_crows([1, 2])
    assert dev._bounds_map and dev.postings_slot is not None
    dev.generation = -2                     # force a rebuild
    dev._full_rebuild()
    assert dev._bounds_cache is None and dev._bounds_map is None
    assert dev._slot_dev is None
    nxs.close()


def test_legacy_columns_derive_from_the_pack(small_index):
    pdev = PDeviceIndex.from_arrays(small_index.host,
                                    export_arrays(small_index.dev), "cpu")
    jdev = small_index.dev
    np.testing.assert_array_equal(pdev.postings_slot.numpy(),
                                  np.asarray(jdev.postings_slot))
    np.testing.assert_array_equal(pdev.postings_ltf.numpy(),
                                  np.asarray(jdev.postings_ltf))
    assert pdev.postings_ltf.is_contiguous()


def test_segsum_wrapper_raises_for_non_cpu_tensors():
    z = torch.zeros(1024, device="meta")
    b = torch.zeros((1, 1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        kernels.blockdense_scores(z.int(), z, z, z, b, z.reshape(1, 1, -1),
                                  algo=0, use_mask=True)

