"""Device search executors for pure-OR queries (torch).

Port of the windowed executors of nxsearch_tpu/ops/executor.py:

- ``prefix_topk`` (R = 0: the complete-plane impact-prefix path, the
  dominant serving signature) and
- ``sliced_topk`` (single-term plane, windowed ``n_run`` planes, the
  dense-row hybrid ``use_rows`` and the head-term merge ``T_head``).

Both read the snapshot's interleaved (slot, ltf, dl) pack through
contiguous per-(query, window) row windows, score BM25 / TF-IDF
elementwise, sort each query's plane by slot, sum every document's run
with the reference's fixed shifted passes and take the top k.  These
are plain tensor operations in the reference too (no Pallas), so here
they are torch ops, not hand kernels.

Exactness rules kept from the reference:
- ties in every top-k resolve toward the lowest plane index, i.e. the
  lowest device slot (``lax.top_k`` semantics): a stable descending
  sort replaces ``torch.topk``, which promises no tie order;
- the slot sort is stable (``lax.sort`` is), and the run sums add in
  the same shifted-pass order, so CPU results match to ~1 ulp;
- bitmaps stay int32 and every shift is masked with ``& 1``.

Branches the port does not carry yet (masked queries, impact-prefix
R > 0) raise ``NotImplementedError`` naming the branch.
"""

from __future__ import annotations

import numpy as np
import torch

from .scoring import ALGO_BM25, BM25_B, BM25_K1, bm25, tf_idf

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


def _run_sums(key_s, contrib_s, n_logical: int):
    """Within-document run sums by shifted passes: a document's run is
    at most ``n_logical`` lanes, so adding each lane's neighbours at
    offsets 1..n_logical-1 whose key matches is an exact segment sum.
    Same passes and order as the reference."""
    n_batch, flat = key_s.shape
    run = contrib_s
    for off in range(1, n_logical):
        if off >= flat:
            break
        key_prev = torch.nn.functional.pad(key_s[:, :-off], (off, 0),
                                           value=-_INF)
        c_prev = torch.nn.functional.pad(contrib_s[:, :-off], (off, 0),
                                         value=0.0)
        run = run + torch.where(key_prev == key_s, c_prev, 0.0)
    return run


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
    dense_rows=None,  # f32[H, S_pad]: heavy-term ltf rows
    d_row=None,       # int32[N, D]: dense_rows row index, -1 pad
    d_idf=None,       # float32[N, D]
    h_start=None,     # int32[N]: head term CSR start (T_head > 0)
    h_len=None,       # int32[N]
    h_idf=None,       # float32[N]
    *, T: int, k: int, algo: int, n_slots: int, use_mask: bool,
    single: bool, alive_all: bool, use_rows: bool, T_head: int = 0,
    n_run: int = 0,
):
    """Sliced exact top-k for pure-OR queries; returns packed
    f32[N, 2, k'] (scores, slots by value -- exact below 2**24 slots,
    which the router gates on).  See nxsearch_tpu's sliced_topk for
    the derivation of each branch."""
    if use_mask:
        raise NotImplementedError(
            "sliced_topk: the use_mask branch (masked AND/NOT queries) "
            "is not ported")
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
            part = row / (row + c1 + c2 * doc_len[None, :]) \
                if algo == ALGO_BM25 else row
            part = part * d_idf[:, j: j + 1]
            dsum = dsum + torch.where((d_row[:, j] >= 0)[:, None], part,
                                      0.0)
        if not alive_all:
            dsum = dsum * alive_factors(alive_mask)[None, :]

    if single and not use_rows:
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
    if n_logical == 1:
        # One CSR term: its windows are already slot-ascending (invalid
        # tail lanes keyed +inf) and each document occurs once.
        key_s, contrib_s = key, contrib_f
    else:
        key_s, contrib_s = _slot_sort(key, contrib_f)
    run = _run_sums(key_s, contrib_s, n_logical)

    h_add = None
    if T_head > 0:
        # Batched binary search of the candidate slots into the sorted
        # head slice: matched candidates absorb the head contribution.
        find = torch.searchsorted(h_key.contiguous(), key_s.contiguous(),
                                  side="left")
        find_c = torch.clamp(find, max=T_head - 1)
        matched = ((h_key.gather(1, find_c) == key_s)
                   & torch.isfinite(key_s))
        h_add = torch.where(matched, hc.gather(1, find_c), 0.0)

    is_doc = _last_of_run(key_s) & torch.isfinite(key_s)
    total = run if h_add is None else run + h_add
    segsum = torch.where(is_doc, total, 0.0)

    if use_rows:
        # Pure-OR merge: scatter-max is exact because contributions are
        # non-negative (a candidate total dominates its dense-only
        # partial sum).  Padding lanes scatter into a spill column.
        slot_idx = torch.where(is_doc, key_s, float(n_slots)).to(
            torch.int64)
        dense_at = dsum.gather(1, torch.clamp(slot_idx, max=n_slots - 1))
        cand_final = torch.where(segsum > 0.0, segsum + dense_at, 0.0)
        merged = torch.nn.functional.pad(dsum, (0, 1))
        merged.scatter_reduce_(1, slot_idx, cand_final, reduce="amax",
                               include_self=True)
        scores, slots_i = _topk(merged[:, :n_slots], min(k, n_slots))
        slots = torch.where(scores > 0.0, slots_i.to(torch.float32), 0.0)
        return torch.stack([scores, slots], dim=1)

    if T_head > 0:
        # Head-only documents: drop head postings a tail candidate
        # consumed, then top-k over both planes at once.
        drop_ix = torch.where(is_doc & matched, find_c, T_head)
        hplane = torch.nn.functional.pad(hc, (0, 1))
        hplane.scatter_(1, drop_ix, 0.0)
        scores_all = torch.cat([segsum, hplane[:, :T_head]], dim=1)
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
    run = _run_sums(key_s, contrib_s, n_logical)
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
                       dense_rows=None, *, qs: int, D: int, T: int,
                       k: int, algo: int, n_slots: int, use_mask: bool,
                       single: bool, alive_all: bool, use_rows: bool,
                       T_head: int = 0, n_run: int = 0):
    """One-buffer front end for sliced_topk, same layout as the
    reference's: sl_start[n,qs] sl_len[n,qs] sl_idf[n,qs]
    | use_rows: d_row[n,D] d_idf[n,D]
    | T_head: h_start[n] h_len[n] h_idf[n] h_row[n] h_pass[n]."""
    if use_mask:
        raise NotImplementedError(
            "sliced_topk: the use_mask branch (masked AND/NOT queries) "
            "is not ported")
    per = 3 * qs + (2 * D if use_rows else 0) + (5 if T_head else 0)
    n = buf.shape[0] // per
    q_start = _take(buf, 0, n, qs, (qs,), False)
    q_len = _take(buf, n * qs, n, qs, (qs,), False)
    q_idf = _take(buf, 2 * n * qs, n, qs, (qs,), True)
    off = 3 * n * qs
    d_row = d_idf = None
    if use_rows:
        d_row = _take(buf, off, n, D, (D,), False)
        d_idf = _take(buf, off + n * D, n, D, (D,), True)
        off += 2 * n * D
    h_start = h_len = h_idf = None
    if T_head:
        h_start = _take(buf, off, n, 1, (), False)
        h_len = _take(buf, off + n, n, 1, (), False)
        h_idf = _take(buf, off + 2 * n, n, 1, (), True)
    return sliced_topk(
        postings_pack, alive_mask, doc_len, q_start, q_len, q_idf, adl,
        dense_rows=dense_rows, d_row=d_row, d_idf=d_idf,
        h_start=h_start, h_len=h_len, h_idf=h_idf,
        T=T, k=k, algo=algo, n_slots=n_slots, use_mask=use_mask,
        single=single, alive_all=alive_all, use_rows=use_rows,
        T_head=T_head, n_run=n_run)


def pack_sliced_group(sl_start, sl_len, sl_idf, d_row=None, d_idf=None,
                      h_start=None, h_len=None, h_idf=None, h_row=None,
                      h_pass=None) -> np.ndarray:
    """Host-side packer matching sliced_topk_packed's layout.  Fields
    must be passed exactly when their gate is on."""
    parts = [sl_start, sl_len, sl_idf]
    if d_row is not None:
        parts += [d_row, d_idf]
    if h_start is not None:
        parts += [h_start, h_len, h_idf, h_row, h_pass]
    return np.concatenate([_i32(p) for p in parts])


def unpack_sliced(arr: np.ndarray):
    """Packed [N, 2, k] sliced result -> (scores f32[N, k],
    slots i32[N, k]) numpy arrays."""
    return arr[:, 0, :], arr[:, 1, :].astype(np.int32)
