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

from nxsearch_tpu_torch import search as _search
from nxsearch_tpu_torch.ops import executor, kernels

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
    """Exact equality at the main path's shape, at M = 1 (the
    single-query kernel), and at a ragged W with more queries than one
    shared-memory group holds."""
    _need_card()
    args = _myers_inputs(n_terms + n_queries, n_terms, n_queries)
    kernel = kernels.MYERS_ONE if n_queries == 1 else kernels.MYERS
    before = kernel.launches
    got = kernels.myers_distances(*args)
    want = kernels.myers_distances_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kernel.launches == before + 1


# 1,000,003 terms: more blocks than one wave holds, and no multiple of
# the 256-term block.
@pytest.mark.parametrize("n_terms", [200_000, 1000, 1, 33, 257, 1_000_003])
def test_single_query_kernel_matches_plain_version(n_terms):
    """The single-query entry (the wrapper at M = 1) against the plain
    single-query sweep, for each query of a set that holds a 32-byte and
    a q_len 0 row; W = 1 and 33 leave most of a block's threads dead,
    257 one term in a second block."""
    _need_card()
    vb, vl, qb, ql = _myers_inputs(n_terms, n_terms, 5)
    for i in range(5):
        before = (kernels.MYERS.launches, kernels.MYERS_ONE.launches)
        got = kernels.myers_distances(vb, vl, qb[i: i + 1], ql[i: i + 1])
        want = kernels.myers_distances_one_ref(vb, vl, qb[i], ql[i])
        torch.cuda.synchronize()
        assert torch.equal(got[0], want)
        assert (kernels.MYERS.launches, kernels.MYERS_ONE.launches) == \
            (before[0], before[1] + 1)


@pytest.mark.parametrize("n_terms,n_queries", [
    (200_000, 64),     # the main path's chunk
    (4099, 70),        # W not a multiple of the block, M > one group
    (65, 129),         # two full query groups and one more row
    (1000, 1),         # a lookup in rev mode
    (1, 3),            # one live thread in the only block
])
def test_myers_rev_kernel_matches_twin_and_forward(n_terms, n_queries):
    """The transposed kernel equals its twin on every lane (n = 0 and
    n = 32 terms, q_len 0 and 32-byte rows included) and equals the
    forward kernel."""
    _need_card()
    args = _myers_inputs(n_terms * 7 + n_queries, n_terms, n_queries)
    args[1][-1:] = 32                      # a 32-byte term (bytes: any)
    before = kernels.MYERS_REV.launches
    got = kernels.myers_rev_distances(*args)
    want = kernels.myers_rev_distances_ref(*args)
    fwd = kernels.myers_distances(*args)
    torch.cuda.synchronize()
    assert kernels.MYERS_REV.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, fwd)


def test_single_query_kernel_full_byte_range():
    _need_card()
    vb, vl, qb, ql = _myers_inputs(11, 4099, 5, alphabet=bytes(range(256)))
    for i in range(5):
        got = kernels.myers_distances(vb, vl, qb[i: i + 1], ql[i: i + 1])
        assert torch.equal(got[0], kernels.myers_distances_one_ref(
            vb, vl, qb[i], ql[i]))


@pytest.mark.parametrize("n_terms,n_queries", [
    (200_000, 64), (33, 64), (1, 64), (200_000, 1), (33, 1), (1, 1)])
def test_myers_rev_kernel_groups_full_byte_range(n_terms, n_queries):
    """Queries of 1-32 bytes over all 256 values hold more distinct
    bytes than the kernel's 32-row table: at M = 64 they take several
    groups per chunk.  Equal to the twin and to the forward kernel on
    every lane, at the main path's W, at one term and at a W of one
    block and a term, and at M = 1."""
    _need_card()
    args = _myers_inputs(n_terms + 3 * n_queries, n_terms, n_queries,
                         alphabet=bytes(range(256)))
    args[1][-1:] = 32                      # a 32-byte term
    before = kernels.MYERS_REV.launches
    got = kernels.myers_rev_distances(*args)
    want = kernels.myers_rev_distances_ref(*args)
    fwd = kernels.myers_distances(*args)
    torch.cuda.synchronize()
    assert kernels.MYERS_REV.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, fwd)
    if n_queries > kernels.REV_CHUNK:
        group, _alphabets, _rank = kernels.rev_query_groups_ref(
            *(a.cpu() for a in args[2:]))
        assert int(group[kernels.REV_CHUNK - 1]) > 0


def test_myers_rev_kernel_full_byte_range():
    _need_card()
    args = _myers_inputs(10, 5000, 40, alphabet=bytes(range(1, 256)))
    got = kernels.myers_rev_distances(*args)
    assert torch.equal(got, kernels.myers_rev_distances_ref(*args))
    assert torch.equal(got, kernels.myers_distances(*args))


def test_myers_rev_wrapper_rejects_bad_inputs():
    _need_card()
    vb, vl, qb, ql = _myers_inputs(2, 64, 4)
    with pytest.raises(ValueError, match="vocab_len"):
        kernels.myers_rev_distances(vb, vl.long(), qb, ql)
    with pytest.raises(ValueError, match="q_bytes"):
        kernels.myers_rev_distances(vb, vl, qb.cpu(), ql)
    with pytest.raises(ValueError, match="q_len"):
        kernels.myers_rev_distances(vb, vl, qb, ql[:3])
    with pytest.raises(ValueError, match="vocab_bytes"):
        kernels.myers_rev_distances(vb[:, :16], vl, qb, ql)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(64 * 32 + 8, dtype=torch.uint8, device="cuda")
        kernels.myers_rev_distances(flat[8:].view(64, 32), vl, qb, ql)


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


def test_fuzzy_rev_on_card_matches_cpu(tmp_path, monkeypatch):
    """With the rev flag on, fuzzy search_many and search on the card
    (the transposed kernel; at M = 1 as well) answer as the port on the
    CPU, and no forward kernel launches."""
    _need_card()
    import bench
    from nxsearch_tpu_torch import Nxs, Params
    from nxsearch_tpu_torch import fuzzy as pfuzzy

    monkeypatch.setattr(pfuzzy, "_USE_REV_KERNEL", True)
    vocab = 6000
    cpu = Nxs(str(tmp_path), device="cpu")
    idx_c = cpu.index_create("t")
    idx_c.add_many(bench.zipf_range(0, 3000, vocab, 20))
    gpu = Nxs(str(tmp_path), device="cuda")
    idx_g = gpu.index_open("t")
    words = np.array([f"w{i:05d}" for i in range(vocab)])
    probs = 1.0 / (np.arange(vocab) + 10.0)
    probs /= probs.sum()
    rng = np.random.default_rng(2)
    many = (bench.make_queries(60, words, probs, rng)
            + bench.make_fuzzy_queries(90, words, probs, rng, "r"))
    single = bench.make_fuzzy_queries(12, words, probs, rng, "s")
    fwd = (kernels.MYERS.launches, kernels.MYERS_ONE.launches)
    rev = kernels.MYERS_REV.launches
    got = idx_g.search_many(many, Params().set_uint("limit", 10))
    got += [idx_g.search(q, Params().set_uint("limit", 10))
            for q in single]
    assert kernels.MYERS_REV.launches > rev
    assert (kernels.MYERS.launches, kernels.MYERS_ONE.launches) == fwd
    want = idx_c.search_many(many, Params().set_uint("limit", 11))
    want += [idx_c.search(q, Params().set_uint("limit", 11))
             for q in single]
    for q, w, g in zip(many + single, want, got):
        _assert_same(w, g, q)
    gpu.close()
    cpu.close()


def _segsum_inputs(seed, n_queries, n_terms, n_slots):
    """Random slot-sorted CSR postings (some terms empty), the bounds
    rows of n_queries x n_terms query terms (about one in six the
    all-zero row of padding / dense-handled terms) and BM25 coef."""
    rng = np.random.default_rng(seed)
    n_csr = 2 * n_terms
    lens = rng.integers(0, n_slots // 3, n_csr)
    lens[:2] = 0
    lens[-1] = n_slots // 4             # every query's first term
    slot = [np.sort(rng.choice(n_slots, size=int(n), replace=False))
            for n in lens]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    total = int(lens.sum())
    p_pad = -(-(total + 1) // 1024) * 1024
    ps = np.zeros(p_pad, np.int32)
    pf = np.zeros(p_pad, np.float32)
    ps[:total] = np.concatenate(slot)
    pf[:total] = np.log(rng.integers(1, 9, total) + 1.0)
    dl = rng.integers(3, 90, n_slots).astype(np.float32)
    alive = (rng.random(n_slots) > 0.05).astype(np.float32)
    n_blocks = n_slots // kernels.BLOCK_SLOTS
    bounds_all = executor.csr_block_bounds(
        torch.from_numpy(ps), torch.from_numpy(starts),
        torch.from_numpy(lens.astype(np.int32)), n_blocks=n_blocks).numpy()
    pick = rng.integers(-1, n_csr, (n_queries, n_terms))
    pick[rng.random(pick.shape) < 0.1] = -1
    pick[:, 0] = n_csr - 1
    bounds = np.where(pick[..., None] >= 0,
                      bounds_all[np.maximum(pick, 0)], 0).astype(np.int32)
    coef = np.zeros((n_queries, n_terms, 4), np.float32)
    coef[..., 0] = rng.uniform(0.1, 6.0, (n_queries, n_terms))
    coef[..., 1] = np.float32(1.2 * 0.25)
    coef[..., 2] = np.float32(0.9) / np.float32(37.0)
    return [torch.from_numpy(a).cuda()
            for a in (ps, pf, dl, alive, bounds, coef)]


def _full_block_inputs(args, n_slots):
    """``args`` with one more term whose 1024 postings fill block 1,
    held by term 0 of row 0 alone; every other range empty."""
    ps, pf, dl, alive, bounds, coef = args
    start = ps.shape[0]
    ps = torch.cat([ps, torch.arange(1024, 2048, dtype=torch.int32,
                                     device=ps.device),
                    torch.zeros(1024, dtype=torch.int32, device=ps.device)])
    pf = torch.cat([pf, torch.linspace(0.5, 2.0, 1024, device=pf.device),
                    torch.zeros(1024, device=pf.device)])
    bounds = torch.zeros_like(bounds)
    edges = torch.arange(n_slots // 1024 + 1, device=ps.device)
    bounds[0, 0] = torch.where(edges <= 1, start, start + 1024)
    return ps, pf, dl, alive, bounds, coef


@pytest.mark.parametrize("n_queries,n_terms,n_slots,algo,use_mask,case", [
    pytest.param(64, 8, 1 << 16, 0, True, "random",
                 id="64-8-65536-0-True"),    # a bd chunk, narrower index
    pytest.param(3, 8, 4096, 1, True, "random",
                 id="3-8-4096-1-True"),      # TF-IDF
    pytest.param(5, 8, 8192, 0, False, "random",
                 id="5-8-8192-0-False"),     # no presence bits
    pytest.param(2, 32, 2048, 0, True, "random",
                 id="2-32-2048-0-True"),     # bit 31: the int32 sign
    pytest.param(1, 1, 1024, 0, True, "random",
                 id="1-1-1024-0-True"),      # one term, one block
    # Fewer blocks than the persistent grid's CTAs, and rows past one
    # tile's 64 (a second, partial row chunk).
    pytest.param(70, 8, 5 << 10, 0, True, "random", id="small-grid"),
    # A block count that no grid size divides: CTAs walk unequal tiles.
    pytest.param(7, 8, 1031 << 10, 0, True, "random", id="ragged-tiles"),
    pytest.param(64, 8, 1 << 20, 0, True, "random",
                 id="1m-launch"),            # the 1M tier's launch
    pytest.param(7, 8, 9216 << 10, 0, True, "random",
                 id="tier-launch"),          # the north-star tier's
    pytest.param(4, 8, 8192, 0, True, "empty", id="all-empty"),
    pytest.param(3, 8, 4096, 0, True, "full_block", id="full-block"),
    # 32 terms: more than one posting round holds, 16-row tiles.
    pytest.param(64, 32, 1 << 16, 0, True, "random", id="q32-chunks"),
    pytest.param(6, 8, 8192, 0, True, "dead", id="alive-zero"),
    pytest.param(64, 8, 1 << 20, 1, False, "random",
                 id="1m-tfidf-no-mask"),
])
def test_segsum_kernel_matches_twin(n_queries, n_terms, n_slots, algo,
                                    use_mask, case):
    """Bit-for-bit equality of scores and presence bits, empty and
    zeroed ranges included; ``case``: random ranges, every range empty,
    one row's full 1024-posting block beside empty rows, or alive 0 at
    half the slots where postings land."""
    _need_card()
    args = _segsum_inputs(n_queries + n_terms, n_queries, n_terms, n_slots)
    if case == "empty":
        args[4].zero_()
    elif case == "full_block":
        args = _full_block_inputs(args, n_slots)
    elif case == "dead":
        args[3][args[0][::2].long()] = 0.0
    before = kernels.SEGSUM.launches
    got_s, got_b = kernels.blockdense_scores(*args, algo=algo,
                                             use_mask=use_mask)
    want_s, want_b = kernels.blockdense_scores_ref(*args, algo=algo,
                                                   use_mask=use_mask)
    torch.cuda.synchronize()
    assert kernels.SEGSUM.launches == before + 1
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_b, want_b)
    if case == "empty":
        assert not want_s.any() and not want_b.any()
        return
    assert (want_s > 0).any()
    if case == "full_block":
        assert bool((want_b[0, 1024:2048] == 1).all())
        assert not want_b[0, :1024].any() and not want_b[1:].any()
    if case == "dead":
        assert bool(((want_s == 0) & (want_b != 0)).any())
    if n_terms == 32:
        assert (want_b < 0).any()          # bit 31 set somewhere


def test_blockdense_two_groups_on_card_matches_cpu():
    """A 9-term masked query runs the kernel twice (terms 0-7, then term
    8 with its bits shifted by 8); the card's top-k equals the CPU's."""
    _need_card()
    ps, pf, dl, _alive, bounds, coef = _segsum_inputs(7, 4, 16, 8192)
    alive_mask = torch.full((8192 // 32,), -1, dtype=torch.int32,
                            device="cuda")
    alive_mask[3] = 0x0F0F0F0F
    bounds[:, 9:] = 0                   # 9 live terms per query
    q_idf = coef[..., 0].contiguous()
    # (t0 AND t8) OR (t1 AND NOT t5), NOP-padded.
    ops = torch.tensor([[1, 1, 2, 1, 1, 4, 3, 0]] * 4, dtype=torch.int32)
    args = torch.tensor([[0, 8, 0, 1, 5, 0, 0, 0]] * 4, dtype=torch.int32)
    adl = torch.tensor(37.0)
    kw = dict(k=128, algo=0, n_slots=8192, use_mask=True, depth=4)
    before = kernels.SEGSUM.launches
    got = executor.blockdense_topk_bounds(
        ps, pf, dl, alive_mask, bounds, q_idf, adl.cuda(), ops.cuda(),
        args.cuda(), **kw)
    want = executor.blockdense_topk_bounds(
        ps.cpu(), pf.cpu(), dl.cpu(), alive_mask.cpu(), bounds.cpu(),
        q_idf.cpu(), adl, ops, args, **kw)
    assert kernels.SEGSUM.launches == before + 2
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert (want[0] > 0).any()


def test_segsum_wrapper_rejects_bad_inputs():
    _need_card()
    ps, pf, dl, alive, bounds, coef = _segsum_inputs(1, 2, 8, 2048)
    with pytest.raises(ValueError, match="bounds"):
        kernels.blockdense_scores(ps, pf, dl, alive, bounds.long(), coef,
                                  algo=0, use_mask=True)
    with pytest.raises(ValueError, match="multiple of 1024"):
        kernels.blockdense_scores(ps, pf, dl[:1000], alive[:1000], bounds,
                                  coef, algo=0, use_mask=True)
    # cp.async stages doc lengths and alive factors 16 bytes at a time;
    # coef is read as float4.
    off = torch.zeros(2048 + 1, device="cuda")[1:]
    with pytest.raises(ValueError, match="doc_len must be 16-byte"):
        kernels.blockdense_scores(ps, pf, off, alive, bounds, coef,
                                  algo=0, use_mask=True)
    with pytest.raises(ValueError, match="at most 512"):
        wide = torch.zeros((1, 513, 3), dtype=torch.int32, device="cuda")
        kernels.blockdense_scores(ps, pf, dl, alive, wide,
                                  torch.zeros((1, 513, 4), device="cuda"),
                                  algo=0, use_mask=True)


def _zipf_pair(tmp_path, vocab=6000):
    """(CPU index, card index) over one basedir of 3000 Zipf documents,
    and the vocabulary with its probabilities."""
    import bench
    from nxsearch_tpu_torch import Nxs

    cpu = Nxs(str(tmp_path), device="cpu")
    idx_c = cpu.index_create("t")
    idx_c.add_many(bench.zipf_range(0, 3000, vocab, 20))
    gpu = Nxs(str(tmp_path), device="cuda")
    idx_g = gpu.index_open("t")
    words = np.array([f"w{i:05d}" for i in range(vocab)])
    probs = 1.0 / (np.arange(vocab) + 10.0)
    return cpu, idx_c, gpu, idx_g, words, probs / probs.sum()


def _wide_masked(words, rng, n):
    """Masked queries of 33-48 unique terms (the dense executor)."""
    out = []
    for i in range(n):
        ws = [str(w) for w in words[rng.choice(
            len(words) // 4, int(rng.integers(33, 49)), replace=False)]]
        out.append(f"({' OR '.join(ws[:-1])}) AND NOT {ws[-1]}" if i % 2
                   else f"({' OR '.join(ws[:20])}) AND "
                        f"({' OR '.join(ws[20:])})")
    return out


def _same_bits(a, b):
    """Two passes' responses identical: ids and scores bit for bit."""
    assert [r.results for r in a] == [r.results for r in b]


def test_dense_route_on_card_matches_cpu(tmp_path):
    """> 32-term masked queries take the dense executor on the card (the
    packed bitmaps, the program, the dense per-slot row); two passes
    agree bit for bit, and the answers match the CPU's."""
    _need_card()
    from nxsearch_tpu_torch import Params
    from nxsearch_tpu_torch import search as psearch

    cpu, idx_c, gpu, idx_g, words, _probs = _zipf_pair(tmp_path)
    queries = _wide_masked(words, np.random.default_rng(3), 24)
    psearch.EXEC_STATS.clear()
    got = idx_g.search_many(queries, Params().set_uint("limit", 10))
    assert psearch.EXEC_STATS.get("dense", 0) == len(queries)
    _same_bits(got, idx_g.search_many(queries,
                                      Params().set_uint("limit", 10)))
    want = idx_c.search_many(queries, Params().set_uint("limit", 11))
    for q, w, g in zip(queries, want, got):
        _assert_same(w, g, q)
    assert sum(len(g.results) for g in got) > 0
    for q in queries[:4]:
        _assert_same(idx_c.search(q, Params().set_uint("limit", 11)),
                     idx_g.search(q, Params().set_uint("limit", 10)), q)
    gpu.close()
    cpu.close()


def test_candidate_route_on_card_matches_cpu(tmp_path, monkeypatch):
    """With the blockdense route and the masked hybrid off, the plans
    the prefix and sliced routes refuse take the candidate executor on
    the card; two passes agree bit for bit, the answers match the
    CPU's."""
    _need_card()
    import bench
    from nxsearch_tpu_torch import Params
    from nxsearch_tpu_torch import search as psearch

    monkeypatch.setattr(psearch, "_use_blockdense", lambda *a, **kw: False)
    monkeypatch.setattr(psearch, "_MASKED_HYBRID", False)
    cpu, idx_c, gpu, idx_g, words, probs = _zipf_pair(tmp_path)
    rng = np.random.default_rng(4)
    queries = bench.make_mixed_queries(200, words, probs, rng)
    for i in range(24):
        h, a, b = words[i % 10], words[40 + i], words[90 + 2 * i]
        queries += [f"{h} AND {a}", f"{a} {b} AND NOT {h}"]
    psearch.EXEC_STATS.clear()
    got = idx_g.search_many(queries, Params().set_uint("limit", 10))
    assert psearch.EXEC_STATS.get("candidate", 0) > 0
    _same_bits(got, idx_g.search_many(queries,
                                      Params().set_uint("limit", 10)))
    want = idx_c.search_many(queries, Params().set_uint("limit", 11))
    for q, w, g in zip(queries, want, got):
        _assert_same(w, g, q)
    gpu.close()
    cpu.close()


def test_prefix_wide_on_card_matches_cpu(tmp_path, monkeypatch):
    """Impact-prefix plans with wide terms (R > 0) on the card: the
    region is built at the snapshot, uncertified rows re-run classically
    (fallback sub-batch, speculative twin, deferred pipelined
    fallback), and every answer matches the CPU's."""
    _need_card()
    import bench
    from nxsearch_tpu_torch import Params
    from nxsearch_tpu_torch import search as psearch
    from nxsearch_tpu_torch.index.device import DeviceIndex

    monkeypatch.setattr(DeviceIndex, "PREFIX_CAP", 64)
    monkeypatch.setattr(DeviceIndex, "WIDE_MIN_DF", 64)
    monkeypatch.setattr(psearch, "_PREFIX_MAX_WIDE", 4)
    cpu, idx_c, gpu, idx_g, words, probs = _zipf_pair(tmp_path)
    queries = bench.make_queries(240, words, probs,
                                 np.random.default_rng(5))
    psearch.EXEC_STATS.clear()
    sp10 = Params().set_uint("limit", 10)
    got = idx_g.search_many(queries, sp10)
    got += [r for b in idx_g.search_pipelined(
        [queries[i: i + 60] for i in range(0, 240, 60)], sp10) for r in b]
    got += [idx_g.search(q, sp10) for q in queries[:12]]
    stats = psearch.EXEC_STATS
    assert idx_g.dev.prefix_stats["wide_terms"] > 0
    assert stats.get("prefix_fallback", 0) > 0, stats
    assert stats.get("prefix_spec_used", 0) > 0, stats
    sp11 = Params().set_uint("limit", 11)
    want = idx_c.search_many(queries, sp11)
    want += [r for b in idx_c.search_pipelined(
        [queries[i: i + 60] for i in range(0, 240, 60)], sp11) for r in b]
    want += [idx_c.search(q, sp11) for q in queries[:12]]
    for q, w, g in zip(queries + queries + queries[:12], want, got):
        _assert_same(w, g, q)
    gpu.close()
    cpu.close()


@pytest.mark.parametrize("hybrid", [True, False])
def test_masked_search_on_card_matches_cpu(tmp_path, monkeypatch, hybrid):
    """bench's mixed trace plus boolean queries over the dense-row terms,
    on the card and on the CPU: masked sliced rows with the hybrid on,
    the blockdense route (segsum kernel) with it off."""
    _need_card()
    import bench
    from nxsearch_tpu_torch import Nxs, Params
    from nxsearch_tpu_torch import search as psearch

    monkeypatch.setattr(psearch, "_MASKED_HYBRID", hybrid)
    vocab = 6000
    cpu = Nxs(str(tmp_path), device="cpu")
    idx_c = cpu.index_create("t")
    idx_c.add_many(bench.zipf_range(0, 3000, vocab, 20))
    gpu = Nxs(str(tmp_path), device="cuda")
    idx_g = gpu.index_open("t")
    words = np.array([f"w{i:05d}" for i in range(vocab)])
    probs = 1.0 / (np.arange(vocab) + 10.0)
    probs /= probs.sum()
    rng = np.random.default_rng(1)
    queries = bench.make_mixed_queries(300, words, probs, rng)
    for i in range(24):
        h, a, b = words[i % 10], words[40 + i], words[90 + 2 * i]
        queries += [f"{h} AND {a}", f"{a} {b} AND NOT {h}",
                    f"({h} OR {a}) AND {b}"]
    psearch.EXEC_STATS.clear()
    before = kernels.SEGSUM.launches
    got = idx_g.search_many(queries, Params().set_uint("limit", 10))
    if not hybrid:
        assert kernels.SEGSUM.launches > before
        assert psearch.EXEC_STATS.get("blockdense", 0) > 0
    want = idx_c.search_many(queries, Params().set_uint("limit", 11))
    for q, w, g in zip(queries, want, got):
        _assert_same(w, g, q)
    gpu.close()
    cpu.close()


def test_kernels_launch_from_a_fresh_thread():
    """Each kernel launched from a new thread (as a service request
    thread launches it) equals its twin, and counts one launch."""
    _need_card()
    import threading

    vb, vl, qb, ql = _myers_inputs(12, 5000, 40)
    seg = _segsum_inputs(13, 4, 8, 8192)
    calls = [
        (kernels.MYERS, lambda: (kernels.myers_distances(vb, vl, qb, ql),),
         lambda: (kernels.myers_distances_ref(vb, vl, qb, ql),)),
        (kernels.MYERS_ONE,
         lambda: (kernels.myers_distances(vb, vl, qb[:1], ql[:1])[0],),
         lambda: (kernels.myers_distances_one_ref(vb, vl, qb[0], ql[0]),)),
        (kernels.MYERS_REV,
         lambda: (kernels.myers_rev_distances(vb, vl, qb, ql),),
         lambda: (kernels.myers_rev_distances_ref(vb, vl, qb, ql),)),
        (kernels.SEGSUM,
         lambda: kernels.blockdense_scores(*seg, algo=0, use_mask=True),
         lambda: kernels.blockdense_scores_ref(*seg, algo=0,
                                               use_mask=True)),
    ]
    for kernel, launch, twin in calls:
        out = {}
        before = kernel.launches

        def run():
            out["got"] = launch()
            torch.cuda.synchronize(out["got"][0].device)

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive(), kernel.symbol
        assert kernel.launches == before + 1, kernel.symbol
        for got, want in zip(out["got"], twin()):
            assert torch.equal(got, want), kernel.symbol


def _up_to_ties(want, got, query):
    """``got`` against ``want`` (one result deeper, from an index whose
    slots order ties differently): scores in rank order within 1e-4, and
    each id one that ``want`` holds with its score within 1e-4 -- or,
    past ``want``'s end, one that ties its last score."""
    sc_w = [s for _, s in want.results]
    deep = dict(want.results)
    n = len(got.results)
    assert n == min(len(sc_w), 10), query
    for (d, s), w in zip(got.results, sc_w):
        assert abs(s - w) <= 1e-4, (query, got.results, want.results)
        assert ((d in deep and abs(deep[d] - s) <= 1e-4)
                or (len(sc_w) == 11 and abs(s - sc_w[-1]) <= 1e-4)), \
            (query, d, got.results, want.results)


def test_mesh_on_card_matches_the_card(tmp_path):
    """A mesh of two shards of one card against the port on the card
    over one basedir: plain (the R = 0 prefix body), masked with
    dense-row terms (the blockdense body: segsum launches), > 32-term
    masked (the dense body) and typo queries, batched and one at a
    time."""
    _need_card()
    from nxsearch_tpu_torch import Nxs, Params
    from nxsearch_tpu_torch import search as psearch

    import bench

    _cpu, _idx_c, gpu, idx_g, words, probs = _zipf_pair(tmp_path)
    _cpu.close()
    card = torch.device("cuda", 0)
    mesh = Nxs(str(tmp_path), mesh=[card] * 2)
    idx_m = mesh.index_open("t")
    idx_m.search("w00001")                    # builds the shards
    rng = np.random.default_rng(7)
    heavy = [idx_g.host.term_values[t - 1]
             for t in sorted(idx_m.dev.dense_row_of)[:4]]
    queries = (bench.make_queries(120, words, probs, rng)
               + bench.make_mixed_queries(120, words, probs, rng)
               + [f"{h} AND {words[100 + i]}" for i, h in enumerate(heavy)]
               + [f"{words[200 + i]} {words[300 + i]} AND NOT {h}"
                  for i, h in enumerate(heavy)]
               + _wide_masked(words, rng, 6)
               + bench.make_fuzzy_queries(40, words, probs, rng, "x"))
    assert idx_m.dev.dense_row_of and idx_m.dev.postings_pack[0].is_cuda
    psearch.EXEC_STATS.clear()
    before = kernels.SEGSUM.launches
    got = idx_m.search_many(queries, Params().set_uint("limit", 10))
    stats = dict(psearch.EXEC_STATS)
    assert kernels.SEGSUM.launches >= before + 2, stats
    for key in ("sharded_prefix", "sharded_sliced", "sharded_fallback"):
        assert stats.get(key, 0) > 0, stats
    want = idx_g.search_many(queries, Params().set_uint("limit", 11))
    for q, w, g in zip(queries, want, got):
        _up_to_ties(w, g, q)
    assert sum(len(g.results) for g in got) > 0
    for q in queries[::25]:
        _up_to_ties(idx_g.search(q, Params().set_uint("limit", 11)),
                    idx_m.search(q, Params().set_uint("limit", 10)), q)
    mesh.close()
    gpu.close()


def test_mesh_kernel_body_matches_candidate_on_card(tmp_path):
    """The blockdense shard body (the segsum kernel) against the
    candidate body on two shards of the card."""
    _need_card()
    from nxsearch_tpu_torch import Nxs
    from nxsearch_tpu_torch import search as psearch
    from nxsearch_tpu_torch.parallel import sharded as psh
    from nxsearch_tpu_torch.query.parser import parse_query
    from nxsearch_tpu_torch.query.prepare import prepare

    import bench

    nxs = Nxs(str(tmp_path), mesh=[torch.device("cuda", 0)] * 2)
    idx = nxs.index_create("t")
    idx.add_many(bench.zipf_range(0, 3000, 2000, 20))
    idx.search("w00001")
    dev = idx.dev
    sp = psearch.get_search_params(0, None)
    for text in ("w00003 AND NOT w00010", "w00020 w00030 AND w00001",
                 "(w00005 OR w00050) AND NOT w00002"):
        plan = psearch._build_plan(dev, prepare(
            parse_query(text), idx.pipeline, idx.host.term_lookup,
            fuzzymatch=False), sp)
        args = (dev.postings_slot, dev.postings_ltf, dev.doc_len,
                dev.alive_mask, plan.q_start[:, None, :],
                plan.q_len[:, None, :], plan.q_idf[None], dev.adl,
                plan.prog_ops[None], plan.prog_args[None])
        kw = dict(mesh=dev.mesh, budget=plan.budget, k=64, algo=0,
                  use_mask=True, depth=plan.depth)
        before = kernels.SEGSUM.launches
        got = psh.sharded_search_batch(*args, use_kernel=True, **kw)
        assert kernels.SEGSUM.launches == before + 2
        want = psh.sharded_search_batch(*args, **kw)
        live = {int(s): float(v) for v, s in zip(*(t[0].cpu().numpy()
                                                  for t in want)) if v > 0}
        assert live, text
        assert {int(s): float(v) for v, s in zip(
            *(t[0].cpu().numpy() for t in got)) if v > 0} == \
            pytest.approx(live, abs=1e-4), text
    nxs.close()


def test_large_snapshot_on_card_matches_cpu(tmp_path):
    """A snapshot of 17,825,792 device slots on the card
    (``large_slots_corpus``: documents in odd and even device slots
    past 2**24): every answer of search_many, search_pipelined and
    search, BM25 and TF-IDF, the dense executor's query included,
    equals the port's on the CPU over the same basedir, and every row
    takes the candidate or dense executor."""
    _need_card()
    import large_slots_corpus as corpus
    from nxsearch_tpu_torch import Nxs, Params
    from nxsearch_tpu_torch import search as psearch

    cpu = Nxs(str(tmp_path), device="cpu")
    idx_c = cpu.index_create("big")
    corpus.add_corpus(idx_c.host)
    gpu = Nxs(str(tmp_path), device="cuda")
    idx_g = gpu.index_open("big")
    queries = corpus.QUERIES + [corpus.WIDE]
    half = len(queries) // 2
    try:
        for algo in ("BM25", "TF-IDF"):
            sp = Params().set_uint("limit", 30).set_str("algo", algo)
            want = idx_c.search_many(queries, sp)
            psearch.EXEC_STATS.clear()
            runs = [idx_g.search_many(queries, sp),
                    [r for b in idx_g.search_pipelined(
                        [queries[:half], queries[half:]], sp) for r in b],
                    [idx_g.search(q, sp) for q in queries]]
            stats = psearch.EXEC_STATS
            assert not any(stats.get(k, 0) for k in
                           ("prefix", "sliced", "blockdense")), stats
            assert stats["candidate"] + stats["dense"] == 3 * len(queries)
            for got in runs:
                for q, w, g in zip(queries, want, got):
                    assert [d for d, _ in g.results] == \
                        [d for d, _ in w.results], (algo, q)
                    np.testing.assert_allclose(
                        [s for _, s in g.results], [s for _, s in w.results],
                        rtol=0, atol=1e-4, err_msg=q)
        dev = idx_g.dev
        assert dev.n_slots == 17_825_792 and dev.postings_slot.is_cuda
        assert dev.postings_slot is dev._slot_exact
    finally:
        gpu.close()
        cpu.close()


# -- the impact-prefix executor's CUDA graphs (ops/graphs.py) ------------------

def _graph_index(tmp_path):
    """A card index of 3000 Zipf documents, the vocabulary and its
    probabilities."""
    import bench
    from nxsearch_tpu_torch import Nxs

    nxs = Nxs(str(tmp_path), device="cuda")
    idx = nxs.index_create("t")
    idx.add_many(bench.zipf_range(0, 3000, 6000, 20))
    words = np.array([f"w{i:05d}" for i in range(6000)])
    probs = 1.0 / (np.arange(6000) + 10.0)
    return nxs, idx, words, probs / probs.sum()


def _graphs(monkeypatch, on: bool):
    """Prefix groups replay their CUDA graphs (on), or all run the eager
    chain (off)."""
    from nxsearch_tpu_torch import search as psearch
    monkeypatch.setattr(psearch, "_prefix_graphs",
                        _PREFIX_GRAPHS if on else lambda dev, r: None)


def _graph_counts():
    from nxsearch_tpu_torch import search as psearch
    from nxsearch_tpu_torch.utils.trace import GRAPH_COUNTERS
    return {k: psearch.EXEC_STATS.get(k, 0) for k in GRAPH_COUNTERS}




_PREFIX_GRAPHS = _search._prefix_graphs


def _results(responses):
    return [r.results for r in responses]


def test_prefix_graphs_replay_the_eager_chain(tmp_path, monkeypatch):
    """search_many, one signature chunked many times into one batch, and
    single searches: the first pass runs each signature eagerly, the
    second captures it, the third replays every group, and every pass
    answers bit for bit as the eager chain."""
    _need_card()
    from nxsearch_tpu_torch import Params
    from nxsearch_tpu_torch import search as psearch

    nxs, idx, words, probs = _graph_index(tmp_path)
    sp = Params().set_uint("limit", 10)
    import bench
    queries = bench.make_queries(300, words, probs,
                                 np.random.default_rng(21))
    _graphs(monkeypatch, False)
    want = _results(idx.search_many(queries, sp))
    _graphs(monkeypatch, True)
    passes = []
    for _ in range(3):
        psearch.EXEC_STATS.clear()
        assert _results(idx.search_many(queries, sp)) == want
        passes.append(_graph_counts())
    groups = sum(passes[0].values())
    assert groups > 1 and passes[0]["prefix.graph_eager"] > 0
    assert passes[2] == {"prefix.graph_replay": groups,
                         "prefix.graph_capture": 0,
                         "prefix.graph_eager": 0}, passes
    assert len(idx.dev.prefix_graphs.graphs) > 0

    # Groups chunked to 8 rows: one signature many times in a batch.
    monkeypatch.setattr(psearch, "_group_rows_cap", lambda dev, key: 8)
    _graphs(monkeypatch, False)
    want8 = _results(idx.search_many(queries, sp))
    _graphs(monkeypatch, True)
    psearch.EXEC_STATS.clear()
    for _ in range(3):
        assert _results(idx.search_many(queries, sp)) == want8
    assert psearch.EXEC_STATS["prefix.graph_replay"] > 2 * len(
        idx.dev.prefix_graphs.graphs)
    monkeypatch.undo()

    single = queries[:12]
    _graphs(monkeypatch, False)
    want1 = [idx.search(q, sp).results for q in single]
    _graphs(monkeypatch, True)
    psearch.EXEC_STATS.clear()
    for _ in range(3):
        assert [idx.search(q, sp).results for q in single] == want1
    assert psearch.EXEC_STATS["prefix.graph_replay"] > 0
    nxs.close()


def test_prefix_graphs_pipelined_batches(tmp_path, monkeypatch):
    """Pipelined batches, whose groups replay while the previous batch's
    are still on the device, answer as the eager chain."""
    _need_card()
    import bench
    from nxsearch_tpu_torch import Params
    from nxsearch_tpu_torch import search as psearch

    nxs, idx, words, probs = _graph_index(tmp_path)
    sp = Params().set_uint("limit", 10)
    queries = bench.make_queries(480, words, probs,
                                 np.random.default_rng(22))
    batches = [queries[i: i + 120] for i in range(0, 480, 120)]
    _graphs(monkeypatch, False)
    want = [r.results for b in idx.search_pipelined(batches, sp) for r in b]
    _graphs(monkeypatch, True)
    psearch.EXEC_STATS.clear()
    for _ in range(3):
        got = idx.search_pipelined(batches, sp)
        assert [r.results for b in got for r in b] == want
    assert psearch.EXEC_STATS["prefix.graph_replay"] > 0
    nxs.close()


def test_prefix_graphs_after_a_bulk_add(tmp_path, monkeypatch):
    """Graphs captured, then a bulk add: the search after it runs on a
    new snapshot with a new cache and answers as the eager chain on that
    snapshot."""
    _need_card()
    import bench
    from nxsearch_tpu_torch import Params
    from nxsearch_tpu_torch import search as psearch

    nxs, idx, words, probs = _graph_index(tmp_path)
    sp = Params().set_uint("limit", 10)
    queries = bench.make_queries(200, words, probs,
                                 np.random.default_rng(23))
    for _ in range(3):
        idx.search_many(queries, sp)
    old = idx.dev.prefix_graphs
    assert old.graphs
    idx.add_many(bench.zipf_range(3000, 9000, 6000, 20))
    psearch.EXEC_STATS.clear()
    got = [_results(idx.search_many(queries, sp)) for _ in range(3)]
    assert idx.dev.prefix_graphs is not old
    assert psearch.EXEC_STATS["prefix.graph_replay"] > 0
    _graphs(monkeypatch, False)
    want = _results(idx.search_many(queries, sp))
    assert got == [want] * 3
    assert any(d > 3000 for r in want for d, _s in r)
    nxs.close()


def test_prefix_graphs_two_threads(tmp_path, monkeypatch):
    """Two threads dispatch the same signatures at once, with captures
    among them: each gets its own answers, those of the eager chain."""
    _need_card()
    import threading

    import bench
    from nxsearch_tpu_torch import Params
    from nxsearch_tpu_torch import search as psearch

    nxs, idx, words, probs = _graph_index(tmp_path)
    sp = Params().set_uint("limit", 10)
    rng = np.random.default_rng(24)
    sets = [bench.make_queries(128, words, probs, rng) for _ in range(2)]
    _graphs(monkeypatch, False)
    wants = [_results(idx.search_many(q, sp)) for q in sets]
    _graphs(monkeypatch, True)
    psearch.EXEC_STATS.clear()
    start = threading.Barrier(2)
    errors = []

    def worker(queries, want):
        try:
            start.wait()
            for _ in range(8):
                assert _results(idx.search_many(queries, sp)) == want
        except BaseException as e:          # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(q, w))
               for q, w in zip(sets, wants)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    counts = _graph_counts()
    assert counts["prefix.graph_replay"] > 0, counts
    assert counts["prefix.graph_capture"] > 0, counts
    nxs.close()
