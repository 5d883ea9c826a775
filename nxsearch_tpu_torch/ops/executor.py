"""Device search executors (torch).

Port of nxsearch_tpu/ops/executor.py:

- ``prefix_topk`` (R = 0: the complete-plane impact-prefix path, the
  dominant serving signature);
- ``sliced_topk`` (single-term plane, windowed ``n_run`` planes, the
  dense-row hybrid ``use_rows``, the head-term merge ``T_head`` and the
  masked branches: presence bits per candidate, the program evaluated
  per document, the masked dense-row hybrid);
- ``blockdense_topk`` / ``blockdense_topk_bounds``: every slot scored
  by the segsum kernel (ops/kernels.py) in 8-term groups, dense-row
  terms swept elementwise, the program evaluated per slot.

The windowed executors read the snapshot's interleaved (slot, ltf, dl)
pack through contiguous per-(query, window) row windows, score BM25 /
TF-IDF elementwise, sort each query's plane by slot, sum every
document's run with the reference's fixed shifted passes and take the
top k.  These are plain tensor operations in the reference too (no
Pallas), so here they are torch ops; the block-dense scores are the
one hand kernel on these routes.

Exactness rules kept from the reference:
- ties in every top-k resolve toward the lowest plane index, i.e. the
  lowest device slot (``lax.top_k`` semantics): a stable descending
  sort replaces ``torch.topk``, which promises no tie order;
- the slot sort is stable (``lax.sort`` is), and the run sums add in
  the same shifted-pass order, so CPU results match to ~1 ulp;
- bitmaps stay int32 and every shift is masked with ``& 1``; presence
  bits (u32 in the reference) ride in int64 masked to 32 bits, so bit
  31 is not a sign bit.

The impact-prefix R > 0 branch is not carried yet and raises
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from .boolean import eval_program_bits
from .kernels import BLOCK_SLOTS, MAX_KERNEL_TERMS, blockdense_scores
from .scoring import ALGO_BM25, BM25_B, BM25_K1, bm25, tf_idf

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
    postings_pack,   # f32[P_pad + guard, 3]: (slot, ltf, dl)
    alive_mask,      # int32[S_pad/32]
    q_start,         # int32[N, Qs]: window starts
    q_len,           # int32[N, Qs]
    q_idf,           # float32[N, Qs]
    adl,             # f32 scalar tensor
    *, R: int, T: int, k: int, algo: int, n_slots: int,
    alive_all: bool, n_run: int,
):
    """Impact-prefix exact top-k, complete-plane branch (R = 0): every
    term's windows cover its full CSR range, so the result is exact by
    construction.  Returns packed f32[N, 3, k'] (scores, slots by
    value, exact flag = 1)."""
    assert algo == ALGO_BM25, "impact prefixes are built for BM25"
    if R > 0:
        raise NotImplementedError(
            "prefix_topk: the R > 0 branch (wide-term rescore and "
            "certification) is not ported")
    assert n_slots < (1 << 24), "slot indexes must stay exact in f32"
    n_batch, n_terms = q_start.shape
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
    if n_logical == 1:
        key_s, contrib_s = key, contrib_f
    else:
        key_s, contrib_s = _slot_sort(key, contrib_f)
    run, _ = _run_sums(key_s, contrib_s, n_logical)
    is_doc = _last_of_run(key_s) & torch.isfinite(key_s)
    segsum = torch.where(is_doc, run, 0.0)
    scores, ix = _topk(segsum, min(k, flat))
    slots = key_s.gather(1, ix)
    slots = torch.where(scores > 0.0, slots, 0.0)
    return torch.stack([scores, slots, torch.ones_like(scores)], dim=1)


def _take(buf, off: int, n: int, m: int, shape: tuple, f32: bool):
    seg = buf[off: off + m * n].reshape((n,) + shape)
    return seg.view(torch.float32) if f32 else seg


def prefix_topk_packed(postings_pack, alive_mask, buf, adl, *, qs: int,
                       R: int, T: int, k: int, algo: int, n_slots: int,
                       alive_all: bool, n_run: int):
    """One-buffer front end for prefix_topk (one host->device copy per
    dispatch group).  Layout (row-major [n, ...] per field):
    sl_start[n,qs] sl_len[n,qs] sl_idf[n,qs] col_bit[n,qs] and, for
    R > 0, w_tail w_start w_len w_idf [n,R] each."""
    if R > 0:
        raise NotImplementedError(
            "prefix_topk: the R > 0 branch (wide-term rescore and "
            "certification) is not ported")
    n = buf.shape[0] // (4 * qs)
    q_start = _take(buf, 0, n, qs, (qs,), False)
    q_len = _take(buf, n * qs, n, qs, (qs,), False)
    q_idf = _take(buf, 2 * n * qs, n, qs, (qs,), True)
    return prefix_topk(postings_pack, alive_mask, q_start, q_len, q_idf,
                       adl, R=R, T=T, k=k, algo=algo, n_slots=n_slots,
                       alive_all=alive_all, n_run=n_run)


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
