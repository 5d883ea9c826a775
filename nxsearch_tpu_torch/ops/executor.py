"""Device search executors (torch).

Port of nxsearch_tpu/ops/executor.py:

- ``prefix_topk``: R = 0, the complete-plane impact-prefix path (the
  dominant serving signature), and R > 0, wide terms windowed over
  their impact prefix, the top-M candidates by upper bound rescored by
  binary search over the wide terms' full postings, and the result
  certified (or not) against the bounds;
- ``sliced_topk`` (single-term plane, windowed ``n_run`` planes, the
  dense-row hybrid ``use_rows``, the head-term merge ``T_head`` and the
  masked branches: presence bits per candidate, the program evaluated
  per document, the masked dense-row hybrid);
- ``blockdense_topk`` / ``blockdense_topk_bounds``: every slot scored
  by the segsum kernel (ops/kernels.py) in 8-term groups, dense-row
  terms swept elementwise, the program evaluated per slot;
- ``candidate_topk`` (``device_search`` / ``device_search_batch``):
  the query terms' CSR ranges flattened into one [N, budget] gather
  plane over the slot / ltf columns, sorted by slot, summed per
  document, the program evaluated on per-candidate presence bits;
- ``dense_topk`` (``device_search_dense`` / ``_batch``): the same
  plane scattered into a dense per-slot score row, the program
  evaluated over packed per-term bitmaps (any number of terms).

The windowed executors read the snapshot's interleaved (slot, ltf, dl)
pack through contiguous per-(query, window) row windows, score BM25 /
TF-IDF elementwise, sort each query's plane by slot, sum every
document's run with the reference's fixed shifted passes and take the
top k.  These are plain tensor operations in the reference too (no
Pallas), so here they are torch ops; the block-dense scores are the
one hand kernel on these routes.  The candidate and dense executors
are plain tensor operations as well, over int64 slots: they read the
snapshot's int32 slot column (derived from the f32 pack below 2**24
slots, the exact uploaded one from 2**24), so they serve snapshots of
any size, as the reference's router sends them every query from 2**24
slots.

Exactness rules kept from the reference:
- ties in every top-k resolve toward the lowest plane index, i.e. the
  lowest device slot (``lax.top_k`` semantics): a stable descending
  sort replaces ``torch.topk``, which promises no tie order;
- the slot sort is stable (``lax.sort`` is), and the run sums add in
  the same shifted-pass order, so CPU results match to ~1 ulp;
- bitmaps stay int32 and every shift is masked with ``& 1``; presence
  bits (u32 in the reference) ride in int64 masked to 32 bits, so bit
  31 is not a sign bit;
- per-document sums never use float atomics: the candidate plane adds
  each run's lanes in order from its first lane, and the dense row
  adds one term at a time (each (term, slot) pair occurs once), both
  the reference's sequential scatter-add order, so two runs on the
  card agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .boolean import build_term_masks, eval_program, eval_program_bits
from .kernels import BLOCK_SLOTS, MAX_KERNEL_TERMS, blockdense_scores
from .scoring import ALGO_BM25, BM25_B, BM25_K1, bm25, flatten_ranges, tf_idf

_U32 = 0xFFFFFFFF

_INF = float("inf")


def _sliced_fetch(postings_pack, q_start, *, T: int):
    """[N, Qs] window starts -> [N, Qs, T, 3] (slot, ltf, dl) rows.

    Starts clamp like ``lax.dynamic_slice`` (the pack's guard rows make
    the clamp a no-op for every real window)."""
    start = q_start.to(torch.int64).clamp(0, postings_pack.shape[0] - T)
    rows = start[..., None] + torch.arange(T, device=start.device)
    return postings_pack[rows]


def alive_factors(alive_mask):
    """Packed int32 alive bitmap -> per-slot 0/1 f32 factors."""
    shifts = torch.arange(32, dtype=torch.int32, device=alive_mask.device)
    return (((alive_mask[:, None] >> shifts[None, :]) & 1)
            .to(torch.float32).reshape(-1))


def _alive_at(alive_mask, slot_i):
    """Alive bit of each int slot (bitmap words are int32: the shift is
    arithmetic, so the bit is masked after it)."""
    word = torch.clamp(slot_i >> 5, max=alive_mask.shape[0] - 1)
    return ((alive_mask[word.to(torch.int64)] >> (slot_i & 31)) & 1) \
        .to(torch.bool)


def _topk(x, k: int):
    """``lax.top_k`` over the last axis: descending, equal values in
    ascending index order."""
    vals, ix = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ix[..., :k]


def _slot_sort(key, *others):
    """Stable ascending sort of ``key`` along axis 1, companions
    gathered in the same order (``lax.sort(..., num_keys=1)``)."""
    key_s, order = torch.sort(key, dim=1, stable=True)
    return (key_s,) + tuple(o.gather(1, order) for o in others)


def _run_sums(key_s, contrib_s, n_logical: int, bits_s=None):
    """Within-document run sums by shifted passes: a document's run is
    at most ``n_logical`` lanes, so adding each lane's neighbours at
    offsets 1..n_logical-1 whose key matches is an exact segment sum.
    Same passes and order as the reference.  Presence bits, when given,
    OR over the same runs.  Returns (run, run_bits or None)."""
    n_batch, flat = key_s.shape
    run = contrib_s
    run_bits = bits_s
    for off in range(1, n_logical):
        if off >= flat:
            break
        key_prev = torch.nn.functional.pad(key_s[:, :-off], (off, 0),
                                           value=-_INF)
        eq = key_prev == key_s
        c_prev = torch.nn.functional.pad(contrib_s[:, :-off], (off, 0),
                                         value=0.0)
        run = run + torch.where(eq, c_prev, 0.0)
        if bits_s is not None:
            b_prev = torch.nn.functional.pad(bits_s[:, :-off], (off, 0))
            run_bits = run_bits | torch.where(eq, b_prev, 0)
    return run, run_bits


def _last_of_run(key_s):
    ones = torch.ones((key_s.shape[0], 1), dtype=torch.bool,
                      device=key_s.device)
    return torch.cat([key_s[:, 1:] != key_s[:, :-1], ones], dim=1)


def sliced_topk(
    postings_pack,   # f32[P_pad + guard, 3]: (slot, ltf, dl) rows
    alive_mask,      # int32[S_pad/32]
    doc_len,         # f32[S_pad] (hybrid dense-row scoring only)
    q_start,         # int32[N, Qs]: window starts
    q_len,           # int32[N, Qs]
    q_idf,           # float32[N, Qs]
    adl,             # f32 scalar tensor
    prog_ops=None,   # int32[N, L] (use_mask)
    prog_args=None,  # int32[N, L]
    dense_rows=None,  # f32[H, S_pad]: heavy-term ltf rows
    d_row=None,       # int32[N, D]: dense_rows row index, -1 pad
    d_idf=None,       # float32[N, D]
    h_start=None,     # int32[N]: head term CSR start (T_head > 0)
    h_len=None,       # int32[N]
    h_idf=None,       # float32[N]
    h_row=None,       # int32[N]: head token row (mask bit position)
    h_pass=None,      # bool[N]: program({head}) -- head-only docs pass
    sl_rows=None,     # int32[N, Qs]: token row per column (windowed
                      # masked plans split one term over several columns)
    d_bit=None,       # int32[N, D]: dense term's token row (masked
                      # hybrid; -1 pad)
    d_pass=None,      # bool[N, 2**D]: program verdict for every
                      # dense-only presence pattern (masked hybrid)
    *, T: int, k: int, algo: int, n_slots: int, use_mask: bool,
    single: bool, alive_all: bool, use_rows: bool, depth: int = 8,
    T_head: int = 0, n_run: int = 0,
):
    """Sliced exact top-k; returns packed f32[N, 2, k'] (scores, slots
    by value -- exact below 2**24 slots, which the router gates on).
    See nxsearch_tpu's sliced_topk for the derivation of each branch.

    Masked queries carry per-lane presence bits (bit = the column's
    token row), OR them over each document's run and keep a document
    only where its row's program passes.  The masked hybrid also
    gathers each dense row at the candidate slots (non-zero ltf ==
    present), gates documents no CSR term matched by the host-made
    verdict table ``d_pass``, and lets candidate documents override
    their slot with the full, program-gated total."""
    assert not (use_rows and use_mask) or d_pass is not None, \
        "masked dense-row hybrid requires the d_bit/d_pass inputs"
    assert not (use_rows and T_head), \
        "dense-row and head-term hybrids are mutually exclusive (router)"
    n_batch, n_terms = q_start.shape
    n_logical = n_run if n_run > 0 else n_terms
    win = _sliced_fetch(postings_pack, q_start, T=T)   # [N, Qs, T, 3]
    slot_f = win[..., 0]
    ltf = win[..., 1]
    dl = win[..., 2]
    pos = torch.arange(T, dtype=torch.int32, device=q_len.device)
    valid = pos[None, None, :] < q_len[:, :, None]
    idf = q_idf[:, :, None]
    contrib = bm25(ltf, dl, idf, adl) if algo == ALGO_BM25 \
        else tf_idf(ltf, idf)
    valid_score = valid
    if not alive_all:
        valid_score = valid & _alive_at(alive_mask,
                                        slot_f.to(torch.int32))
    contrib = torch.where(valid_score, contrib, 0.0)

    dsum = None
    d_rows = []
    if use_rows:
        # Dense-row sweep: per-slot exact sums of the heavy terms'
        # contributions, elementwise over [N, S].
        c1 = torch.tensor(BM25_K1 * (1.0 - BM25_B), dtype=torch.float32,
                          device=adl.device)
        c2 = (torch.tensor(BM25_K1 * BM25_B, dtype=torch.float32,
                           device=adl.device)
              / torch.clamp(adl, min=1e-9))
        dsum = torch.zeros((n_batch, n_slots), dtype=torch.float32,
                           device=postings_pack.device)
        for j in range(d_row.shape[1]):
            row = dense_rows[torch.clamp(d_row[:, j], min=0).to(
                torch.int64)]                                 # [N, S]
            if use_mask:
                d_rows.append(row)
            part = row / (row + c1 + c2 * doc_len[None, :]) \
                if algo == ALGO_BM25 else row
            part = part * d_idf[:, j: j + 1]
            dsum = dsum + torch.where((d_row[:, j] >= 0)[:, None], part,
                                      0.0)
        if not alive_all:
            dsum = dsum * alive_factors(alive_mask)[None, :]

    if single and not use_mask and not use_rows:
        scores, ix = _topk(contrib[:, 0, :], min(k, T))
        slots = slot_f[:, 0, :].gather(1, ix)
        slots = torch.where(scores > 0.0, slots, 0.0)
        return torch.stack([scores, slots], dim=1)

    if T_head > 0:
        # Head-term slice: one contiguous window per query, kept out of
        # the sort; invalid tail positions key to +inf so the plane
        # stays ascending for the binary-search merge.
        hwin = _sliced_fetch(postings_pack, h_start[:, None],
                             T=T_head)[:, 0]                  # [N, T_h, 3]
        h_valid = (torch.arange(T_head, dtype=torch.int32,
                                device=h_len.device)[None, :]
                   < h_len[:, None])
        hc = bm25(hwin[..., 1], hwin[..., 2], h_idf[:, None], adl) \
            if algo == ALGO_BM25 else tf_idf(hwin[..., 1], h_idf[:, None])
        h_key = torch.where(h_valid, hwin[..., 0], _INF)
        if not alive_all:
            h_valid = h_valid & _alive_at(
                alive_mask, torch.where(h_valid, hwin[..., 0],
                                        0.0).to(torch.int32))
        hc = torch.where(h_valid, hc, 0.0)

    flat = n_terms * T
    key = torch.where(valid, slot_f, _INF).reshape(n_batch, flat)
    contrib_f = contrib.reshape(n_batch, flat)
    bits = None
    if use_mask:
        if sl_rows is not None:
            rows = sl_rows.to(torch.int64)
        else:
            # Column c's bit is its token row: columns keep token
            # order, skipping the head's row (columns at or past it
            # shift up by one).
            rows = torch.arange(n_terms, device=q_start.device)[None, :]
            if T_head > 0:
                rows = rows + (rows >= h_row[:, None]).to(torch.int64)
        bit = (1 << rows.clamp(max=31))[:, :, None]
        bits = torch.where(valid, bit, 0).reshape(n_batch, flat)
        if use_rows:
            # Masked hybrid: a candidate's bits include the dense
            # terms present at its slot.
            slot_l = slot_f.to(torch.int64).clamp(0, n_slots - 1) \
                .reshape(n_batch, flat)
            valid_f = valid.reshape(n_batch, flat)
            for j, row in enumerate(d_rows):
                dbit = 1 << d_bit[:, j].to(torch.int64).clamp(0, 31)
                on = (valid_f & (row.gather(1, slot_l) > 0.0)
                      & (d_row[:, j] >= 0)[:, None])
                bits = bits | torch.where(on, dbit[:, None], 0)
    if n_logical == 1:
        # One CSR term: its windows are already slot-ascending (invalid
        # tail lanes keyed +inf) and each document occurs once.
        key_s, contrib_s, bits_s = key, contrib_f, bits
    elif use_mask:
        key_s, contrib_s, bits_s = _slot_sort(key, contrib_f, bits)
    else:
        key_s, contrib_s = _slot_sort(key, contrib_f)
        bits_s = None
    run, run_bits = _run_sums(key_s, contrib_s, n_logical, bits_s)

    h_add = None
    if T_head > 0:
        # Batched binary search of the candidate slots into the sorted
        # head slice: matched candidates absorb the head contribution
        # (and its presence bit).
        find = torch.searchsorted(h_key.contiguous(), key_s.contiguous(),
                                  side="left")
        find_c = torch.clamp(find, max=T_head - 1)
        matched = ((h_key.gather(1, find_c) == key_s)
                   & torch.isfinite(key_s))
        h_add = torch.where(matched, hc.gather(1, find_c), 0.0)
        if use_mask:
            hbit = 1 << h_row.to(torch.int64).clamp(max=31)
            run_bits = run_bits | torch.where(matched, hbit[:, None], 0)

    is_doc = _last_of_run(key_s) & torch.isfinite(key_s)
    if use_mask:
        is_doc_kept = is_doc & eval_program_bits(run_bits, prog_ops,
                                                 prog_args, depth=depth)
    else:
        is_doc_kept = is_doc
    total = run if h_add is None else run + h_add
    segsum = torch.where(is_doc_kept, total, 0.0)

    if use_rows:
        slot_idx = torch.where(is_doc, key_s, float(n_slots)).to(
            torch.int64)
        dense_at = dsum.gather(1, torch.clamp(slot_idx, max=n_slots - 1))
        if use_mask:
            # Documents no CSR term matched pass by the verdict of their
            # dense-only presence pattern; candidate documents override
            # their slot with the full, program-gated total (0 when the
            # program fails -- never the dense-only partial).
            pattern = torch.zeros((n_batch, n_slots), dtype=torch.int64,
                                  device=dsum.device)
            for j, row in enumerate(d_rows):
                on = (row > 0.0) & (d_row[:, j] >= 0)[:, None]
                pattern = pattern | torch.where(on, 1 << j, 0)
            verdict = d_pass.to(torch.float32).gather(1, pattern)
            merged = torch.nn.functional.pad(dsum * verdict, (0, 1))
            cand_val = torch.where(is_doc_kept, segsum + dense_at, 0.0)
            merged.scatter_(1, slot_idx, cand_val)
        else:
            # Pure-OR merge: scatter-max is exact because contributions
            # are non-negative (a candidate total dominates its
            # dense-only partial sum).  Padding lanes scatter into a
            # spill column.
            cand_final = torch.where(segsum > 0.0, segsum + dense_at, 0.0)
            merged = torch.nn.functional.pad(dsum, (0, 1))
            merged.scatter_reduce_(1, slot_idx, cand_final, reduce="amax",
                                   include_self=True)
        scores, slots_i = _topk(merged[:, :n_slots], min(k, n_slots))
        slots = torch.where(scores > 0.0, slots_i.to(torch.float32), 0.0)
        return torch.stack([scores, slots], dim=1)

    if T_head > 0:
        # Head-only documents: drop head postings a tail candidate
        # consumed, gate the rest on the host-evaluated head-only
        # verdict, then top-k over both planes at once.
        drop_ix = torch.where(is_doc & matched, find_c, T_head)
        hplane = torch.nn.functional.pad(hc, (0, 1))
        hplane.scatter_(1, drop_ix, 0.0)
        hplane = hplane[:, :T_head]
        if use_mask:
            hplane = torch.where(h_pass[:, None], hplane, 0.0)
        scores_all = torch.cat([segsum, hplane], dim=1)
        slots_all = torch.cat([key_s, h_key], dim=1)
        scores, ix = _topk(scores_all, min(k, flat + T_head))
        slots = slots_all.gather(1, ix)
        slots = torch.where(scores > 0.0, slots, 0.0)
        return torch.stack([scores, slots], dim=1)

    scores, ix = _topk(segsum, min(k, flat))
    slots = key_s.gather(1, ix)
    slots = torch.where(scores > 0.0, slots, 0.0)
    return torch.stack([scores, slots], dim=1)


def prefix_topk(
    postings_pack,   # f32[P_pad + prefix + guard, 3]: (slot, ltf, dl)
    alive_mask,      # int32[S_pad/32]
    q_start,         # int32[N, Qs]: window starts (wide terms point at
                     # their impact-prefix region)
    q_len,           # int32[N, Qs]
    q_idf,           # float32[N, Qs]
    adl,             # f32 scalar tensor
    col_bit=None,    # int32[N, Qs]: 1 << j for windows of wide term j,
                     # 0 for complete terms' windows (R > 0 only)
    w_tail=None,     # float32[N, R]: idf * tail impact bound per wide
                     # term (0 on padding)
    w_start=None,    # int32[N, R]: FULL CSR start of each wide term
    w_len=None,      # int32[N, R]: FULL base df (0 on padding)
    w_idf=None,      # float32[N, R]
    *, T: int, k: int, M: int = 32, algo: int, n_slots: int,
    alive_all: bool, n_run: int, k_ret: int = 0,
):
    """Impact-prefix exact top-k; returns packed f32[N, 3, k'] (scores,
    slots by value, exact flag).

    R = 0 (no wide term in the group): every term's windows cover its
    full CSR range, so the result is exact by construction.  R > 0:
    the plane also carries each lane's wide-term bit; a document's
    upper bound is its plane sum plus the tails of the wide terms it
    lacks; the top-M documents by bound are rescored exactly (binary
    search of each absent wide term's full slot-sorted postings),
    re-sorted by slot so ties go to the lowest slot, and the row is
    certified exact when the k_ret-th score strictly beats both the
    best unselected bound and the all-tails bound (ulp-inflated, f32
    constants).  Uncertified rows re-run on the classic routes.  The
    operations and their order are the reference's."""
    assert algo == ALGO_BM25, "impact prefixes are built for BM25"
    assert n_slots < (1 << 24), "slot indexes must stay exact in f32"
    n_batch, n_terms = q_start.shape
    R = 0 if w_tail is None else w_tail.shape[1]
    n_logical = n_run if n_run > 0 else n_terms

    win = _sliced_fetch(postings_pack, q_start, T=T)   # [N, Qs, T, 3]
    slot_f = win[..., 0]
    pos = torch.arange(T, dtype=torch.int32, device=q_len.device)
    valid = pos[None, None, :] < q_len[:, :, None]
    contrib = bm25(win[..., 1], win[..., 2], q_idf[:, :, None], adl)
    if not alive_all:
        valid_score = valid & _alive_at(alive_mask,
                                        slot_f.to(torch.int32))
        contrib = torch.where(valid_score, contrib, 0.0)
    else:
        contrib = torch.where(valid, contrib, 0.0)

    flat = n_terms * T
    key = torch.where(valid, slot_f, _INF).reshape(n_batch, flat)
    contrib_f = contrib.reshape(n_batch, flat)
    bits_f = None
    if R > 0:
        bits_f = torch.where(valid, col_bit.to(torch.int64)[:, :, None],
                             0).reshape(n_batch, flat)
    if n_logical == 1:
        key_s, contrib_s, bits_s = key, contrib_f, bits_f
    elif R > 0:
        key_s, contrib_s, bits_s = _slot_sort(key, contrib_f, bits_f)
    else:
        key_s, contrib_s = _slot_sort(key, contrib_f)
        bits_s = None
    run, run_bits = _run_sums(key_s, contrib_s, n_logical, bits_s)
    is_doc = _last_of_run(key_s) & torch.isfinite(key_s)
    if R == 0:
        segsum = torch.where(is_doc, run, 0.0)
        scores, ix = _topk(segsum, min(k, flat))
        slots = key_s.gather(1, ix)
        slots = torch.where(scores > 0.0, slots, 0.0)
        return torch.stack([scores, slots, torch.ones_like(scores)], dim=1)

    # Upper bound per document: its plane sum plus the tails of the
    # wide terms absent from its run.
    total_tail = torch.zeros(n_batch, dtype=torch.float32,
                             device=w_tail.device)
    for j in range(R):
        total_tail = total_tail + w_tail[:, j]
    have = torch.zeros_like(run)
    for j in range(R):
        have = have + w_tail[:, j: j + 1] * ((run_bits >> j) & 1).to(
            torch.float32)
    u = run + (total_tail[:, None] - have)
    u_lane = torch.where(is_doc, u, -_INF)

    m1 = min(M + 1, flat)
    m_sel = min(M, flat)
    topu, ix = _topk(u_lane, m1)
    u_out = topu[:, m_sel] if m1 > m_sel else torch.full(
        (n_batch,), -_INF, dtype=torch.float32, device=topu.device)
    sel = ix[:, :m_sel]
    cand_slot = key_s.gather(1, sel)                          # f32
    cand_s = torch.where(is_doc, run, 0.0).gather(1, sel)
    cand_bits = run_bits.gather(1, sel)
    cand_ok = torch.isfinite(u_lane.gather(1, sel))

    # Exact rescore: a lower-bound search of each candidate in every
    # absent wide term's full postings (the reference's iterations,
    # including its unguarded updates once lo meets hi).
    pack0 = postings_pack[:, 0]
    pack_last = postings_pack.shape[0] - 1
    iters = max(int(n_slots).bit_length(), 1)
    s_ex = cand_s
    for j in range(R):
        start = w_start[:, j: j + 1].to(torch.int64)
        hi0 = start + w_len[:, j: j + 1].to(torch.int64)
        lo = start.expand(n_batch, m_sel)
        hi = hi0.expand(n_batch, m_sel)
        for _ in range(iters):
            mid = (lo + hi) >> 1
            go_right = pack0[mid.clamp(max=pack_last)] < cand_slot
            lo = torch.where(go_right, mid + 1, lo)
            hi = torch.where(go_right, hi, mid)
        lo_c = lo.clamp(max=pack_last)
        found = ((pack0[lo_c] == cand_slot) & (lo < hi0)
                 & (w_len[:, j: j + 1] > 0))
        c = bm25(postings_pack[lo_c, 1], postings_pack[lo_c, 2],
                 w_idf[:, j: j + 1], adl)
        absent = ((cand_bits >> j) & 1) == 0
        s_ex = s_ex + torch.where(found & absent & cand_ok, c, 0.0)

    if not alive_all:
        # A dead document's lanes scored 0, but the rescore must not
        # resurrect it.
        cslot_i = torch.where(cand_ok, cand_slot, 0.0).to(torch.int32)
        s_ex = s_ex * _alive_at(alive_mask, cslot_i).to(torch.float32)
    s_ex = torch.where(cand_ok, s_ex, 0.0)

    # Slot order first, so the final top-k breaks ties toward the
    # lowest slot like the classic executors.
    slot_sorted, s_sorted = _slot_sort(
        torch.where(cand_ok, cand_slot, _INF), s_ex)
    k_eff = min(k, m_sel)
    scores, ixf = _topk(s_sorted, k_eff)
    slots = slot_sorted.gather(1, ixf)
    slots = torch.where(scores > 0.0, slots, 0.0)

    # Certify at the requested depth: the k_ret-th exact score must
    # strictly beat the best unselected bound and the all-tails bound;
    # a zero total tail means the plane was complete.
    kth = scores[:, min(k_ret or k_eff, k_eff) - 1]
    grow = torch.tensor(1.0 + 1e-5, dtype=torch.float32,
                        device=kth.device).double()
    eps = torch.tensor(1e-10, dtype=torch.float32, device=kth.device).double()

    def inflate(x):
        # x * grow + eps rounded once, as the reference's compiler fuses
        # it (the f32 product is exact in f64).
        return torch.where(x > 0.0, (x.double() * grow + eps).float(), x)

    exact = ((total_tail == 0.0)
             | ((kth > inflate(u_out)) & (kth > inflate(total_tail)))
             ).to(torch.float32)
    return torch.stack([scores, slots, exact[:, None].expand_as(scores)],
                       dim=1)


def _take(buf, off: int, n: int, m: int, shape: tuple, f32: bool):
    seg = buf[off: off + m * n].reshape((n,) + shape)
    return seg.view(torch.float32) if f32 else seg


def prefix_topk_packed(postings_pack, alive_mask, buf, adl, *, qs: int,
                       R: int, T: int, k: int, M: int = 32, algo: int,
                       n_slots: int, alive_all: bool, n_run: int,
                       k_ret: int = 0):
    """One-buffer front end for prefix_topk (one host->device copy per
    dispatch group).  Layout (row-major [n, ...] per field):
    sl_start[n,qs] sl_len[n,qs] sl_idf[n,qs] col_bit[n,qs] and, for
    R > 0, w_tail w_start w_len w_idf [n,R] each."""
    n = buf.shape[0] // (4 * qs + 4 * R)
    off = 0

    def take(m, f32=False):
        nonlocal off
        seg = _take(buf, off, n, m, (m,), f32)
        off += m * n
        return seg

    q_start, q_len, q_idf, col_bit = take(qs), take(qs), take(qs, True), \
        take(qs)
    wide = {}
    if R > 0:
        wide = dict(col_bit=col_bit, w_tail=take(R, True),
                    w_start=take(R), w_len=take(R), w_idf=take(R, True))
    return prefix_topk(postings_pack, alive_mask, q_start, q_len, q_idf,
                       adl, T=T, k=k, M=M, algo=algo, n_slots=n_slots,
                       alive_all=alive_all, n_run=n_run, k_ret=k_ret,
                       **wide)


def _i32(p) -> np.ndarray:
    p = np.ascontiguousarray(p)
    if p.dtype == np.float32:
        return p.view(np.int32).ravel()
    return p.astype(np.int32, copy=False).ravel()


def pack_prefix_group(sl_start, sl_len, sl_idf, col_bit, w_tail,
                      w_start, w_len, w_idf) -> np.ndarray:
    """Host-side packer matching prefix_topk_packed's layout (same
    layout as the reference's)."""
    return np.concatenate([_i32(p) for p in (
        sl_start, sl_len, sl_idf, col_bit, w_tail, w_start, w_len,
        w_idf)])


def unpack_prefix(arr: np.ndarray):
    """Packed [N, 3, k] prefix result -> (scores f32[N, k],
    slots i32[N, k], exact bool[N]) numpy arrays."""
    return (arr[:, 0, :], arr[:, 1, :].astype(np.int32),
            arr[:, 2, 0] > 0.5)


def sliced_topk_packed(postings_pack, alive_mask, doc_len, buf, adl,
                       dense_rows=None, *, qs: int, L: int, D: int, T: int,
                       k: int, algo: int, n_slots: int, use_mask: bool,
                       single: bool, alive_all: bool, use_rows: bool,
                       depth: int = 8, T_head: int = 0, n_run: int = 0):
    """One-buffer front end for sliced_topk (one host->device copy per
    dispatch group), the reference's layout (row-major [n, ...] per
    field, fields concatenated):
    sl_start[n,qs] sl_len[n,qs] sl_idf[n,qs]
    | use_mask: prog_ops[n,L] prog_args[n,L]
    | use_rows: d_row[n,D] d_idf[n,D]
    | T_head:   h_start[n] h_len[n] h_idf[n] h_row[n] h_pass[n]
    | use_mask and n_run: sl_rows[n,qs]
    | use_mask and use_rows: d_bit[n,D] d_pass[n,2**D]"""
    per = (3 * qs + (2 * L if use_mask else 0)
           + (2 * D if use_rows else 0) + (5 if T_head else 0)
           + (qs if (use_mask and n_run) else 0)
           + (D + (1 << D) if (use_mask and use_rows) else 0))
    n = buf.shape[0] // per
    off = 0

    def take(m, shape, f32=False):
        nonlocal off
        seg = _take(buf, off, n, m, shape, f32)
        off += m * n
        return seg

    q_start = take(qs, (qs,))
    q_len = take(qs, (qs,))
    q_idf = take(qs, (qs,), True)
    kw = {}
    if use_mask:
        kw["prog_ops"] = take(L, (L,))
        kw["prog_args"] = take(L, (L,))
    if use_rows:
        kw["d_row"] = take(D, (D,))
        kw["d_idf"] = take(D, (D,), True)
    if T_head:
        kw["h_start"] = take(1, ())
        kw["h_len"] = take(1, ())
        kw["h_idf"] = take(1, (), True)
        kw["h_row"] = take(1, ())
        kw["h_pass"] = take(1, ()) != 0
    if use_mask and n_run:
        kw["sl_rows"] = take(qs, (qs,))
    if use_mask and use_rows:
        kw["d_bit"] = take(D, (D,))
        kw["d_pass"] = take(1 << D, (1 << D,)) != 0
    return sliced_topk(
        postings_pack, alive_mask, doc_len, q_start, q_len, q_idf, adl,
        dense_rows=dense_rows, T=T, k=k, algo=algo, n_slots=n_slots,
        use_mask=use_mask, single=single, alive_all=alive_all,
        use_rows=use_rows, depth=depth, T_head=T_head, n_run=n_run, **kw)


def pack_sliced_group(sl_start, sl_len, sl_idf, prog_ops=None,
                      prog_args=None, d_row=None, d_idf=None,
                      h_start=None, h_len=None, h_idf=None, h_row=None,
                      h_pass=None, sl_rows=None, d_bit=None,
                      d_pass=None) -> np.ndarray:
    """Host-side packer matching sliced_topk_packed's layout (the
    reference's signature).  Fields must be passed exactly when their
    gate is on."""
    parts = [sl_start, sl_len, sl_idf]
    if prog_ops is not None:
        parts += [prog_ops, prog_args]
    if d_row is not None:
        parts += [d_row, d_idf]
    if h_start is not None:
        parts += [h_start, h_len, h_idf, h_row, h_pass]
    if sl_rows is not None:
        parts.append(sl_rows)
    if d_bit is not None:
        parts += [d_bit, d_pass]
    return np.concatenate([_i32(p) for p in parts])


def unpack_sliced(arr: np.ndarray):
    """Packed [N, 2, k] sliced result -> (scores f32[N, k],
    slots i32[N, k]) numpy arrays."""
    return arr[:, 0, :], arr[:, 1, :].astype(np.int32)


def csr_block_bounds(postings_slot, q_start, q_len, *, n_blocks: int,
                     block: int = BLOCK_SLOTS):
    """bounds int32[Q, n_blocks+1]: for each term, the index of its
    first posting with slot >= g*block -- the reference's 32-step
    vectorised lower-bound search within each term's slot-sorted CSR
    range."""
    dev = postings_slot.device
    edges = torch.arange(n_blocks + 1, dtype=torch.int64,
                         device=dev)[None, :] * block
    lo = q_start.to(torch.int64)[:, None].expand(-1, n_blocks + 1)
    hi = lo + q_len.to(torch.int64)[:, None]
    p_max = postings_slot.shape[0]
    for _ in range(32):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = postings_slot[mid.clamp(0, p_max - 1)]
        go_right = active & (v < edges)
        lo, hi = (torch.where(go_right, mid + 1, lo),
                  torch.where(active & ~go_right, mid, hi))
    return lo.to(torch.int32)


def blockdense_topk_bounds(
    postings_slot, postings_ltf, doc_len, alive_mask,
    bounds,     # int32[N, Q, G+1]: per-term block bounds rows
    q_idf,      # float32[N, Q]
    adl,        # f32 scalar tensor
    prog_ops,   # int32[N, L]
    prog_args,  # int32[N, L]
    dense_rows=None,  # f32[H, S]: heavy-term ltf rows
    d_qpos=None,      # int32[N, D]: query row of each dense entry, -1 pad
    d_row=None,       # int32[N, D]: dense_rows row index
    *, k: int, algo: int, n_slots: int, use_mask: bool, depth: int = 8,
    use_rows: bool = False,
):
    """Exact top-k over every slot: (scores f32[N, k'], slots int64).

    Dense-row terms are summed first, elementwise over their ltf rows
    and times alive; then each group of MAX_KERNEL_TERMS terms adds the
    segsum kernel's alive-masked scores, its presence bits shifted to
    the group's global positions (bit min(g0, 31), as u32); the program
    gates each slot; top-k keeps the lowest slot among equal scores.
    The summation order is the reference's."""
    n_batch, n_terms = bounds.shape[0], bounds.shape[1]
    dev = doc_len.device
    c1 = torch.tensor(BM25_K1 * (1.0 - BM25_B), dtype=torch.float32,
                      device=dev)
    c2 = (torch.tensor(BM25_K1 * BM25_B, dtype=torch.float32, device=dev)
          / torch.clamp(adl, min=1e-9))
    alive_f = alive_factors(alive_mask)
    total = torch.zeros((n_batch, n_slots), dtype=torch.float32, device=dev)
    bits_total = torch.zeros((n_batch, n_slots), dtype=torch.int64,
                             device=dev) if use_mask else None

    if use_rows:
        # Heavy terms: their kernel bounds rows are empty, so only this
        # sweep scores them (same ltf, same f32 formula).
        dtotal = torch.zeros_like(total)
        for j in range(d_qpos.shape[1]):
            row = dense_rows[d_row[:, j].to(torch.int64).clamp(min=0)]
            qp = d_qpos[:, j].to(torch.int64)
            idf = q_idf.gather(1, qp.clamp(min=0)[:, None])      # [N, 1]
            valid = (qp >= 0)[:, None]
            contrib = row * idf / (row + c1 + c2 * doc_len[None, :]) \
                if algo == ALGO_BM25 else row * idf
            dtotal = dtotal + torch.where(valid, contrib, 0.0)
            if use_mask:
                bit = 1 << qp.clamp(0, 31)
                bits_total = bits_total | torch.where(
                    valid & (row > 0.0), bit[:, None], 0)
        total = total + dtotal * alive_f[None, :]

    for g0 in range(0, n_terms, MAX_KERNEL_TERMS):
        qi = q_idf[:, g0: g0 + MAX_KERNEL_TERMS]
        coef = torch.stack([qi, c1.expand_as(qi), c2.expand_as(qi),
                            torch.zeros_like(qi)], dim=2).contiguous()
        sc, bits = blockdense_scores(
            postings_slot, postings_ltf, doc_len, alive_f,
            bounds[:, g0: g0 + MAX_KERNEL_TERMS].contiguous(), coef,
            algo=algo, use_mask=use_mask)
        total = total + sc
        if use_mask:
            bits_total = bits_total | (
                ((bits.to(torch.int64) & _U32) << min(g0, 31)) & _U32)

    if use_mask:
        total = torch.where(
            eval_program_bits(bits_total, prog_ops, prog_args, depth=depth),
            total, 0.0)
    return _topk(total, min(k, n_slots))


def blockdense_topk(
    postings_slot, postings_ltf, doc_len, alive_mask,
    q_start,    # int32[N, Q]
    q_len,      # int32[N, Q]
    q_idf,      # float32[N, Q]
    adl, prog_ops, prog_args, dense_rows=None, d_qpos=None, d_row=None,
    *, k: int, algo: int, n_slots: int, use_mask: bool, depth: int = 8,
    use_rows: bool = False,
):
    """blockdense_topk_bounds with the bounds rows computed from the
    CSR ranges (the serving path gathers them from the per-term bounds
    cache instead: DeviceIndex.bounds_crows).  Dense-handled terms'
    rows collapse to empty ranges."""
    n_batch, n_terms = q_start.shape
    n_blocks = n_slots // BLOCK_SLOTS
    bounds = csr_block_bounds(
        postings_slot, q_start.reshape(-1), q_len.reshape(-1),
        n_blocks=n_blocks).reshape(n_batch, n_terms, n_blocks + 1)
    if use_rows:
        is_dense = (d_qpos.to(torch.int64)[:, :, None]
                    == torch.arange(n_terms, device=bounds.device)[
                        None, None, :]).any(dim=1)                # [N, Q]
        bounds = torch.where(is_dense[:, :, None], 0, bounds)
    return blockdense_topk_bounds(
        postings_slot, postings_ltf, doc_len, alive_mask, bounds, q_idf,
        adl, prog_ops, prog_args, dense_rows, d_qpos, d_row, k=k,
        algo=algo, n_slots=n_slots, use_mask=use_mask, depth=depth,
        use_rows=use_rows)


def _pack_result(scores, slots, n_slots: int):
    """Scores and slots in ONE f32[N, 2, k] array (one device->host
    copy); slots by value, exact below 2**24."""
    assert n_slots < (1 << 24), "slot indexes must stay exact in f32"
    return torch.stack([scores, slots.to(torch.float32)], dim=1)


def blockdense_core(
    postings_slot, postings_ltf, doc_len, alive_mask,
    bounds_cache,   # int32[C, G+1]: per-term bounds rows (row 0 zero)
    q_crow,         # int32[N, Q]: cache row per query term
    q_idf, adl, prog_ops, prog_args, dense_rows=None, d_qpos=None,
    d_row=None, *, k: int, algo: int, n_slots: int, use_mask: bool,
    depth: int = 8, use_rows: bool = False,
):
    """Cached-bounds blockdense, packed f32[N, 2, k'] (the reference's
    ``_blockdense_core``).  Dense-handled and padding terms point at
    cache row 0 (all-zero bounds = empty ranges)."""
    bounds = bounds_cache[q_crow.to(torch.int64)]         # [N, Q, G+1]
    scores, slots = blockdense_topk_bounds(
        postings_slot, postings_ltf, doc_len, alive_mask, bounds, q_idf,
        adl, prog_ops, prog_args, dense_rows, d_qpos, d_row, k=k,
        algo=algo, n_slots=n_slots, use_mask=use_mask, depth=depth,
        use_rows=use_rows)
    return _pack_result(scores, slots, n_slots)


def blockdense_ranges_core(*args, n_slots: int, **kw):
    """Ranges-based blockdense packed f32[N, 2, k'] (the reference's
    ``_blockdense_ranges_core``); arguments as blockdense_topk."""
    scores, slots = blockdense_topk(*args, n_slots=n_slots, **kw)
    return _pack_result(scores, slots, n_slots)


# The blockdense result has the sliced result's [N, 2, k] layout.
unpack_blockdense = unpack_sliced


def device_search_blockdense(postings_slot, postings_ltf, doc_len,
                             alive_mask, q_start, q_len, q_idf, adl,
                             prog_ops, prog_args, dense_rows=None,
                             d_qpos=None, d_row=None, **kw):
    """Single-query entry over the ranges core ([Q] / [L] / [D] inputs);
    returns (scores f32[k], slots i32[k]) numpy arrays."""
    def one(t):
        return None if t is None else t[None]
    packed = blockdense_ranges_core(
        postings_slot, postings_ltf, doc_len, alive_mask, one(q_start),
        one(q_len), one(q_idf), adl, one(prog_ops), one(prog_args),
        dense_rows, one(d_qpos), one(d_row), **kw)
    scores, slots = unpack_blockdense(packed.cpu().numpy())
    return scores[0], slots[0]


_SLOT_SENTINEL = 0x7FFFFFFF


def _flat_plane(postings_slot, postings_ltf, doc_len, alive_mask, q_start,
                q_len, q_idf, adl, *, budget: int, algo: int):
    """Each row's query-term ranges flattened into one [N, budget]
    gather plane (ops/scoring.flatten_ranges) and scored: returns
    (slot int64, qid, valid, contrib f32).  Positions past a row's
    postings read a clamped index and contribute nothing (JAX clamps
    such gathers)."""
    src, qid, valid = flatten_ranges(q_start, q_len, budget)
    src = src.clamp(max=postings_slot.shape[0] - 1)
    slot = postings_slot[src].to(torch.int64)
    ltf = postings_ltf[src]
    idf = q_idf.gather(1, qid)
    score = bm25(ltf, doc_len[slot], idf, adl) if algo == ALGO_BM25 \
        else tf_idf(ltf, idf)
    contrib = torch.where(valid & _alive_at(alive_mask, slot), score, 0.0)
    return slot, qid, valid, contrib


def candidate_topk(
    postings_slot,   # int32[P_pad], slot-sorted per term
    postings_ltf,    # f32[P_pad]
    doc_len,         # f32[S_pad]
    alive_mask,      # int32[S_pad/32]
    q_start,         # int32[N, Q]
    q_len,           # int32[N, Q]
    q_idf,           # f32[N, Q]
    adl,             # f32 scalar tensor
    prog_ops,        # int32[N, L] (NOP-padded; read when use_mask)
    prog_args,       # int32[N, L]
    *, budget: int, k: int, algo: int, use_mask: bool, depth: int = 8,
):
    """Candidate-scoring exact top-k of each row: (scores f32[N, k'],
    slots int32[N, k']), k' = min(k, budget); score <= 0 is no match.

    The flat plane is sorted by slot (stable: a document's lanes stay
    in term order, padding lanes keyed past every slot), each run of
    equal slots is summed from its first lane forward -- the order of
    the reference's sequential scatter-add, and a run is at most Q
    lanes long since each (term, slot) pair occurs once -- and the
    runs are compacted to the front as the reference's segment arrays
    are.  Masked rows evaluate their program on each candidate's
    presence bits (at most 32 terms)."""
    n, n_terms = q_start.shape
    slot, qid, valid, contrib = _flat_plane(
        postings_slot, postings_ltf, doc_len, alive_mask, q_start, q_len,
        q_idf, adl, budget=budget, algo=algo)
    bits = torch.where(valid, 1 << qid.clamp(max=31), 0)
    key_s, order = torch.sort(torch.where(valid, slot, _SLOT_SENTINEL),
                              dim=1, stable=True)
    contrib_s = contrib.gather(1, order)
    bits_s = bits.gather(1, order)

    first = torch.cat([torch.ones((n, 1), dtype=torch.bool,
                                  device=key_s.device),
                       key_s[:, 1:] != key_s[:, :-1]], dim=1)
    total = contrib_s
    agg_bits = bits_s
    for off in range(1, min(n_terms, budget)):
        same = torch.nn.functional.pad(key_s[:, off:] == key_s[:, :-off],
                                       (0, off))
        nxt = torch.nn.functional.pad(contrib_s[:, off:], (0, off))
        total = total + torch.where(same, nxt, 0.0)
        if use_mask:
            nb = torch.nn.functional.pad(bits_s[:, off:], (0, off))
            agg_bits = agg_bits | torch.where(same, nb, 0)
    # Compact: run r's first lane lands at position r; later lanes go
    # to a spill column.
    seg = torch.cumsum(first.to(torch.int64), dim=1) - 1
    dest = torch.where(first, seg, budget)
    agg_score = torch.zeros((n, budget + 1), dtype=torch.float32,
                            device=key_s.device).scatter_(1, dest, total)
    agg_slot = torch.zeros((n, budget + 1), dtype=torch.int64,
                           device=key_s.device).scatter_(1, dest, key_s)
    agg_score = agg_score[:, :budget]
    if use_mask:
        agg_bits = torch.zeros_like(agg_slot).scatter_(
            1, dest, agg_bits)[:, :budget]
        keep = eval_program_bits(agg_bits, prog_ops, prog_args, depth=depth)
        agg_score = torch.where(keep, agg_score, 0.0)
    scores, ix = _topk(agg_score, min(k, budget))
    return scores, agg_slot.gather(1, ix).to(torch.int32)


def dense_topk(
    postings_slot, postings_ltf, doc_len, alive_mask,
    q_start,         # int32[N, Q]
    q_len,           # int32[N, Q]
    q_idf,           # f32[N, Q]
    adl,             # f32 scalar tensor
    prog_ops,        # int32[N, L] or None when not use_mask
    prog_args,
    *, budget: int, k: int, algo: int, n_slots: int, use_mask: bool,
    depth: int = 8, term_lens,
):
    """Dense-scoring exact top-k of each row: (scores f32[N, k'], slots
    int32[N, k']), k' = min(k, n_slots).  No sort: packed per-term doc
    bitmaps (any number of terms) gate the postings through the
    program, and the contributions land in a dense per-slot row one
    term at a time, in term order, so each slot adds its terms in the
    reference's order and no two lanes of a pass share a slot.  Right
    for > 32-term boolean queries and for postings streams as large as
    the corpus.  ``term_lens``: each term column's longest range over
    the rows, as host ints."""
    n, n_terms = q_start.shape
    slot, qid, valid, contrib = _flat_plane(
        postings_slot, postings_ltf, doc_len, alive_mask, q_start, q_len,
        q_idf, adl, budget=budget, algo=algo)
    if use_mask:
        masks = build_term_masks(slot, qid, valid, n_terms=n_terms,
                                 n_words=n_slots // 32)
        final = eval_program(masks, prog_ops, prog_args, depth=depth)
        word = final.gather(1, (slot >> 5).clamp(max=final.shape[1] - 1))
        contrib = torch.where(((word.to(torch.int64) >> (slot & 31)) & 1)
                              != 0, contrib, 0.0)
    q_len = q_len.to(torch.int64)
    first = torch.cumsum(q_len, dim=1) - q_len      # term q's first lane
    row_at = torch.arange(n, device=slot.device)[:, None] * n_slots
    dense = torch.zeros(n * n_slots, dtype=torch.float32, device=slot.device)
    for q, width in enumerate(term_lens):
        if width <= 0:
            continue
        lane = torch.arange(int(width), device=slot.device)[None, :]
        at = (first[:, q: q + 1] + lane).clamp(max=budget - 1)
        s = slot.gather(1, at)
        on = (lane < q_len[:, q: q + 1]) & (s < n_slots)
        dense.index_add_(0, (row_at + s.clamp(max=n_slots - 1)).reshape(-1),
                         torch.where(on, contrib.gather(1, at), 0.0)
                         .reshape(-1))
    scores, slots = _topk(dense.reshape(n, n_slots), min(k, n_slots))
    return scores, slots.to(torch.int32)


def _one(t):
    return None if t is None else t[None]


def device_search(postings_slot, postings_ltf, doc_len, alive_mask,
                  q_start, q_len, q_idf, adl, prog_ops, prog_args, **kw):
    """Single-query candidate entry ([Q] / [L] inputs): (scores f32[k'],
    slots int32[k']) device tensors."""
    scores, slots = candidate_topk(
        postings_slot, postings_ltf, doc_len, alive_mask, _one(q_start),
        _one(q_len), _one(q_idf), adl, _one(prog_ops), _one(prog_args),
        **kw)
    return scores[0], slots[0]


# The batched candidate entry: one call scores N queries over the
# shared snapshot (the reference's vmap of the candidate core).
device_search_batch = candidate_topk


def device_search_dense(postings_slot, postings_ltf, doc_len, alive_mask,
                        q_start, q_len, q_idf, adl, prog_ops, prog_args,
                        **kw):
    """Single-query dense entry ([Q] / [L] inputs; the program may be
    None when not use_mask): (scores f32[k'], slots int32[k'])."""
    scores, slots = dense_topk(
        postings_slot, postings_ltf, doc_len, alive_mask, _one(q_start),
        _one(q_len), _one(q_idf), adl, _one(prog_ops), _one(prog_args),
        term_lens=q_len.tolist(), **kw)
    return scores[0], slots[0]


# The batched dense entry (the reference's vmap of the dense core).
device_search_dense_batch = dense_topk

