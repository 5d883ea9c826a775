"""Search orchestration: parse -> prepare -> device execute -> response.

Port of nxsearch_tpu/search.py.  The host half of nxs_index_search
(src/query/search.c:285-342) -- parameter handling, journal sync,
query preparation, the numpy planner and response assembly -- is
carried over unchanged, so both packages build field-for-field equal
plans.  The device half dispatches the two executors this port
carries (ops/executor.py): the impact-prefix complete-plane path
("pf", R = 0) and the sliced path ("sl": single, windowed, dense-row
hybrid, head merge).  A plan that routes anywhere else raises
NotImplementedError naming the route; nothing is silently rerouted.

Device work is asynchronous on CUDA: a batch's groups are enqueued
back to back, their packed results are concatenated on the device and
ONE device->host copy into pinned memory starts at the end of submit;
collect waits for that copy only.  The pipelined entry point submits
batch i before collecting batch i-1, so host prep overlaps device
execution.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .errors import ErrorCode, NxsError
from .index.device import DeviceIndex
from .ops.boolean import (EMPTY_LEAF_BIT, QUERY_NESTING_LIMIT,
                          check_nesting, compile_program)
from .ops.scoring import ALGO_BM25, ALGO_TFIDF, host_idf
from .params import DEFAULT_RESULTS_LIMIT, Params

# Beyond 32 unique query terms the presence-bits boolean evaluation
# does not fit a uint32; such queries use the dense packed-bitmap path.
MAX_BITS_TERMS = 32
from .query.ast import EXPR_OP_OR, EXPR_VAL_TOKEN, Expr
from .query.parser import parse_query
from .query.prepare import Query, prepare
from .resp import Response
from .text.tokenizer import Token

# Shared AST stand-in for batched fast-path queries (pure implicit-OR
# term lists resolve without an Expr tree; a lone leaf is trivially
# pure-OR for any walker that does look).
_PURE_OR_ROOT = Expr.leaf("<batched-pure-or>")

_ALGO_BY_NAME = {"BM25": ALGO_BM25, "TF-IDF": ALGO_TFIDF}

# Executor-path counters (observability; reset freely).  Keys:
# prefix / prefix_exact / prefix_fallback / sliced / full / dense /
# candidate count QUERIES routed through each path.
EXEC_STATS: dict[str, int] = {}


def _count(key: str, n: int = 1) -> None:
    EXEC_STATS[key] = EXEC_STATS.get(key, 0) + n


_MAX_DENSE_PER_QUERY = 4

# Static bucket floors: shapes round up to powers of two, so queries
# of similar size share one group signature.
#
# The planner constants below are nxsearch_tpu's, unchanged, so both
# packages plan identically; they were tuned on the reference's TPU
# and are not retuned for the H100 yet (ROADMAP queue 1 item 9).  The
# measurements behind each choice are in nxsearch_tpu/search.py.
_MIN_BUDGET = 1024
_MIN_TERMS = 8
_MIN_K = 16
_MIN_PROG = 16
_MIN_DEPTH = 4
# Head-term extraction thresholds (sliced path): a CSR term with df at
# or above this leaves the sort plane for the searchsorted/top_k merge.
# Disabled by default (the reference measured its batched binary
# search slower than sorting the same postings); the thresholds stay
# monkeypatchable (tests) and env-tunable.
_HEAD_MIN_DF = int(os.environ.get("NXS_HEAD_MIN_DF", str(1 << 30)))
# Two-term queries: extracting the bigger term as the head leaves ONE
# logical term in the plane, which skips the sort entirely (sliced_topk
# n_logical == 1).  Off by default for the same reason.
_HEAD_MIN_DF_PAIR = int(os.environ.get("NXS_HEAD_MIN_DF_PAIR",
                                       str(1 << 30)))


@dataclass
class SearchParams:
    """Resolved per-query parameters (search_params_t, search.c:71-76)."""
    limit: int
    algo: int
    fuzzymatch: bool


def get_search_params(default_algo: int, params: Params | None) -> SearchParams:
    sp = SearchParams(limit=DEFAULT_RESULTS_LIMIT, algo=default_algo,
                      fuzzymatch=True)
    if params is None:
        return sp
    # A wrong-typed limit is ignored, matching nxs_params_get_uint's
    # failure being ignored (search.c:96); an explicit 0 or oversized
    # value is an error (search.c:96-101).
    limit = params.get_uint("limit")
    if limit is not None:
        if limit == 0 or limit > 0xFFFFFFFF:
            raise NxsError(ErrorCode.INVALID, "invalid limit")
        sp.limit = limit
    algo_name = params.get_str("algo")
    if algo_name is not None:
        if algo_name not in _ALGO_BY_NAME:
            raise NxsError(ErrorCode.INVALID, "invalid algorithm")
        sp.algo = _ALGO_BY_NAME[algo_name]
    fl = params.get_bool("fuzzymatch")
    if fl is not None:
        sp.fuzzymatch = fl
    return sp


def _bucket(n: int, minimum: int, shift: int = 1) -> int:
    """Round up to the bucket grid: minimum * (2**shift)**i.

    Coarse grids (shift > 1) trade some wasted device work for far
    fewer distinct group signatures -- every distinct signature is a
    separate device dispatch.
    """
    size = minimum
    while size < n:
        size <<= shift
    return size


def _slice_tier(n: int, cap: int) -> int:
    """Sort-plane slice tier: coarse 512 * 8**i grid with the
    SLICE_MAX_T cap tier folded in.  Every dispatched group costs a
    plan upload and a launch, so tier count multiplies per-batch
    dispatch overhead; a coarse grid overfetches instead.

    ``cap`` is the index's slice_t_cap: the widest window its pack
    guard rows allow.  cap >= every sliceable df, so the clamp never
    shrinks a tier below the plane's widest term."""
    t = 512
    while t < n:
        t <<= 3
    if n <= DeviceIndex.SLICE_MAX_T:
        return min(t, DeviceIndex.SLICE_MAX_T, cap)
    return t    # over the cap: the router rejects the sliced path


def _head_tier(n: int, cap: int) -> int:
    """Head-slice tier: two tiers only.  The head plane skips the sort
    (top_k + searchsorted merge), so padding is cheap -- coarse tiers
    keep the signature space tiny."""
    return min(65536 if n <= 65536 else DeviceIndex.SLICE_MAX_T, cap)


# Windowed sliced plans: fixed sort-plane window width.  A term wider
# than this splits into ceil(df/T0) columns, so the sort plane holds
# ~df lanes instead of a power-of-8 tier pad (up to ~8x fewer lanes),
# while ONE width covers every df -- fewer group signatures than the
# tier grid it replaces.
_WINDOW_T = int(os.environ.get("NXS_WINDOW_T", "1024"))
# Column cap: wider queries (> _WINDOW_MAX_COLS * T0 sliced postings)
# keep the legacy tiered plane / other executors.  32768 * T0=1024
# covers four ~4.2M-df terms in one query, so wide-term rows stay on
# the pack-only sliced path instead of an executor that needs the
# separate slot/ltf columns.
_WINDOW_MAX_COLS = int(os.environ.get("NXS_WINDOW_MAX_COLS", "32768"))


def _window_t0(cap: int) -> int:
    """Window width, shrunk to what the pack's guard rows can absorb
    (window starts sit inside the real postings, so a read never
    extends more than T0 past n_postings)."""
    t = _WINDOW_T
    while t > cap and t > 1:
        t >>= 1
    return t


# Variable-width windows: per-ROW window width chosen from this rung
# ladder (clipped to the guard cap).  The plane cost of a dispatched
# row is (column tier) x (window width) lanes -- independent of how
# much of it is real postings -- and with a fixed T0 = 1024 the
# damped-Zipf mix pays mostly padding: a 3-term query whose terms
# window once each pads to the 8-column tier = 8192 sorted lanes for
# a few hundred real postings.  Choosing the rung that minimizes the
# padded plane (a small-df row drops to 8 x 128 = 1024 lanes; a
# mid-df row to 64 x 256; wide rows keep T0) shrinks the sort plane
# while every window still covers its postings in full -- exactness
# is untouched.  Smaller widths are always safe
# against the pack guard (reads extend at most T <= T0 past a start
# inside the postings).
_T_LADDER_CFG = tuple(sorted(
    int(x) for x in os.environ.get("NXS_T_LADDER",
                                   "128,256,512,1024").split(",") if x))


def _t_ladder(T0: int) -> tuple:
    """Window-width rungs available under the guard cap T0 (ascending,
    always ending at T0 itself)."""
    return tuple(t for t in _T_LADDER_CFG if t < T0) + (T0,)


def _tier_cols(nw: np.ndarray) -> np.ndarray:
    """Column count a row with ``nw`` windows pads to after group
    coalescing: the _PF_TIERS tier grid for narrow planes, pow2
    beyond (wide fine groups)."""
    cost = _pow2ceil(np.maximum(nw, 1))
    for bound in reversed(_PF_TIERS):
        cost = np.where(nw <= bound, bound, cost)
    return np.where(nw == 0, 0, cost)


def _choose_T(ln_eff: np.ndarray, T0: int) -> np.ndarray:
    """Per-row window width: the ladder rung minimizing the padded
    plane lane count (tier columns x width).  Ties prefer the widest
    rung -- fewer columns, fewer signatures.  ``ln_eff`` is the
    [rows, terms] effective-length matrix (zeros for dead cells)."""
    ladder = _t_ladder(T0)
    ns = ln_eff.shape[0]
    big = np.int64(np.iinfo(np.int64).max)
    best_T = np.full(ns, ladder[-1], np.int64)
    best_cost = np.full(ns, big, np.int64)
    nw0 = None
    for T in ladder:                    # ascending: ties -> larger T
        nw = (-(-ln_eff // T)).sum(axis=1)
        cost = _tier_cols(nw) * T
        if T != ladder[-1]:
            # Sub-T0 rungs are only legal while the row stays within
            # the coalesce tiers: beyond 64 columns a row becomes a
            # WIDE-plane fine group whose (qs, T) signature tracks
            # content; wide planes keep T0 so their signatures stay
            # few.
            cost = np.where(nw <= _COALESCE_MAX_COLS, cost, big)
        better = cost <= best_cost
        best_T = np.where(better, T, best_T)
        best_cost = np.where(better, cost, best_cost)
        nw0 = nw                        # last iteration: nw at T0
    # Wide planes (beyond the last coalesce tier at T0) pin to T0:
    # their plane is ~df lanes at every rung (the tie rule resolves
    # there anyway), and the wide-signature AOT prewarm covers T0
    # shapes only.
    return np.where(nw0 > _COALESCE_MAX_COLS, ladder[-1], best_T)


# Column-pad floor: the plan-stats model shows sorted lanes at the
# 8.8M mix are dominated by padding (a 2-window query pads to 4
# columns = 16k lanes).  A floor of 2 halves those lanes at the cost
# of one extra signature group; tune on hardware via NXS_QS_MIN.
_QS_MIN = int(os.environ.get("NXS_QS_MIN", "2"))

# Impact-prefix pruned path (ops/executor.prefix_topk): rescored
# candidate count for R > 0 plans (the exactness certificate covers
# the top-k only when k <= M) and the per-query cap on wide terms
# (each costs a binary-search rescore pass; queries with more fall
# back to the classic plan).  _PREFIX_M is the floor rung; R > 0
# dispatches ladder M up to the requested limit (reference default
# limit is 1000, nxs_impl.h:39, so a stock caller must still route
# the fast path), and R = 0 plans are exact at ANY depth by
# construction -- their plane is complete -- so only the ladder top
# bounds them.
_PREFIX_M = 32
_PREFIX_M_RUNGS = (32, 128, 1024)
_PREFIX_LIMIT_MAX = _PREFIX_M_RUNGS[-1]


# Wide terms in a prefix plan default OFF (the reference found R > 0
# certification rarely succeeds: every near-tied plane doc is granted
# the whole missing tail).  Wide rows plan classically up front; R > 0
# plans (NXS_PREFIX_MAX_WIDE > 0) reach prefix_topk's R > 0 branch,
# which this port does not carry yet.
_PREFIX_MAX_WIDE = int(os.environ.get("NXS_PREFIX_MAX_WIDE", "0"))


def _prefix_mode(dev, sp, sharded: bool) -> bool:
    """Scalar gate for impact-prefix plans: single chip, BM25 (the
    impacts are BM25 tf-parts), live adl equal to the adl the impacts
    were ordered under, and a limit the M-rescore ladder covers
    (R = 0 plans -- the default serving shape -- are exact at any
    depth; see _prefix_m)."""
    return (not sharded
            and getattr(dev, "prefix_ready", False)
            and sp.algo == ALGO_BM25
            and sp.limit <= _PREFIX_LIMIT_MAX
            and dev.adl == dev.adl_built
            and getattr(dev, "postings_pack", None) is not None
            and dev.n_slots < (1 << 24))


def _prefix_mode_sharded(dev, sp) -> bool:
    """Mesh twin of _prefix_mode.  Doc sharding needs no impact
    regions or adl pinning: each shard windows its own rows of every
    term IN FULL, so every sharded prefix plan is R = 0 (complete
    plane, exact by construction) -- the only gates are the scoring
    algo, the rescoreable limit, and f32 slot exactness per shard."""
    return (sp.algo == ALGO_BM25
            and sp.limit <= _PREFIX_LIMIT_MAX
            and getattr(dev, "postings_pack", None) is not None
            and dev.slots_per_shard < (1 << 24))
# Masked dense-row hybrid: route masked (AND/NOT) queries with
# dense-handled terms through the sliced hybrid instead of the
# blockdense kernel.  Exact either way; ON by default for memory: the
# hybrid stays on the pack-only sliced plane, where blockdense needs
# separate slot/ltf columns and O(rows x n_slots) workspace.
_MASKED_HYBRID = os.environ.get("NXS_MASKED_HYBRID", "1") == "1"


def _row_pad(n: int, qs: int = 0, T: int = 0, pf: bool = False) -> int:
    """Group row count -> padded row count on the configured grid.

    Wide-plane groups (qs > 64: the monster-term rows) pad on the
    {1, 2, 4, 8, 64} ladder, clamped so one dispatch stays under ~16M
    plane lanes (an unclamped rung would re-inflate chunked groups
    past the chunk cap).  Narrow prefix groups (``pf``) ladder onto
    {8, 64, 128, ..., 2048}: variable-width windows split a batch over
    several (tier, T) cells whose member counts track the query mix,
    and the ladder keeps their signatures few.
    Other narrow groups keep the pow2 floor-8 grid.  ``T`` is the
    group's actual window width (the chunking cap's T can shrink
    below _WINDOW_T on small guard caps, so the lane clamp must use
    the same T as the chunker or a chunk can hold more members than
    the clamped pad)."""
    if qs > 64:
        # {1,2,4,8,64}: monster planes are the most expensive lanes
        # in the batch, and padding rows sort REAL lanes, so the small
        # rungs stay fine-grained.
        p = _ladder(n, (1, 2, 4, 8, 64))
        if p > 64:
            p = _bucket(n, 64)
        lane_cap = max(1, (1 << 24) // (qs * (T or _WINDOW_T)))
        # pad >= n always: the chunker is the source of truth for
        # group size; a pad below it would overflow the fill loops.
        return max(min(p, lane_cap), n)
    if pf:
        # 2x steps from 64 up: the pf cells carry hundreds of rows of
        # the batch's most-traveled planes, so coarser steps would pay
        # much of the variable-width saving back in row padding; below
        # 64 rows the cells are cheap and one rung keeps signatures
        # scarce.
        return _ladder(_bucket(n, 8),
                       (8, 64, 128, 256, 512, 1024, 2048))
    return _bucket(n, 8)


def _qs_pad(n: int) -> int:
    """Sliced-plane term-count pad: 1 keeps the sort-free single-term
    plane; everything else rounds to >= _QS_MIN (padding lanes
    dominate the sort, so the floor stays low)."""
    if n <= 1:
        return 1
    p = _QS_MIN
    while p < n:
        p <<= 1
    return p


def _is_pure_or(expr: Expr) -> bool:
    """True if every operator in the tree is OR: the final bitmap is
    the plain union of the leaves, so no mask evaluation is needed."""
    stack = [expr]
    while stack:
        e = stack.pop()
        if e.type == EXPR_VAL_TOKEN:
            continue
        if e.type != EXPR_OP_OR:
            return False
        stack.extend(e.elements)
    return True


@dataclass
class _Plan:
    """Host-resolved device inputs for one query."""
    q_start: np.ndarray    # [Q] or [n_dev, Q] when sharded
    q_len: np.ndarray
    q_idf: np.ndarray      # [Q]
    term_ids: np.ndarray   # int64[n_tok]: resolved term IDs (row order)
    prog_ops: np.ndarray   # [L] NOP-padded
    prog_args: np.ndarray
    use_mask: bool
    use_dense: bool
    budget: int
    depth: int
    # Dense-row tier entries (blockdense/sliced-hybrid): query row +
    # device row of up to _MAX_DENSE_PER_QUERY heavy terms; -1 padded.
    d_qpos: np.ndarray = None  # int32[_MAX_DENSE_PER_QUERY]
    d_row: np.ndarray = None
    d_idf: np.ndarray = None   # float32[_MAX_DENSE_PER_QUERY]
    # Sliced-executor inputs: the non-dense (CSR) terms' ranges,
    # compacted and padded to a power-of-two width, plus the per-term
    # slice length bucket (>= the widest CSR term's df).
    sl_start: np.ndarray = None  # int32[Qs_pad]
    sl_len: np.ndarray = None
    sl_idf: np.ndarray = None
    sl_T: int = 0
    # Windowed plans (single-chip): token row per column and the
    # logical CSR term count (bounds aggregation run lengths).  n_run
    # stays 0 on legacy tiered plans (sharded / over-wide fallback).
    sl_rows: np.ndarray = None   # int32[Qs_pad]
    n_run: int = 0
    single: bool = False        # exactly one term, pure-OR
    # Head-term hybrid (sliced path): the heaviest CSR term, kept out
    # of the sort plane (ops/executor.py sliced_topk T_head).
    h_start: int = 0
    h_len: int = 0
    h_idf: float = 0.0
    h_row: int = -1             # token row (presence-bit position)
    h_T: int = 0                # pow2 slice tier; 0 = no head
    h_pass: bool = True         # program({head}) for head-only docs
    # Masked dense-row hybrid: program verdict for every dense-only
    # presence pattern (bool[2**_MAX_DENSE_PER_QUERY]).
    d_pass: np.ndarray = None
    # Impact-prefix plan (pure-OR BM25; ops/executor.prefix_topk):
    # per-column wide-term bit, and per wide term the tail bound
    # (idf * excluded-impact max) plus its FULL CSR range and idf for
    # the exact rescore.  R-padded; pf_len 0 on padding rows.
    pf: bool = False
    pf_bits: np.ndarray = None   # int32[Qs_pad]
    pf_tail: np.ndarray = None   # float32[R]
    pf_start: np.ndarray = None  # int32[R]
    pf_len: np.ndarray = None    # int32[R]
    pf_idf: np.ndarray = None    # float32[R]

    @property
    def use_rows(self) -> bool:
        return self.d_qpos is not None and bool((self.d_qpos >= 0).any())

    @property
    def batch_key(self):
        """Static-signature key of the reference's candidate/dense
        executors (plans with equal keys share one batched call)."""
        return (self.q_start.shape[-1], len(self.prog_ops), self.use_mask,
                self.use_dense, self.budget, self.depth)


def _build_plan_prefix(dev, tokens, q_start, q_len, q_idf,
                       term_ids) -> Optional[_Plan]:
    """Impact-prefix plan: wide terms window over their top-CAP impact
    region with a tail bound; complete terms window over their full
    CSR range.  None when the query exceeds the wide-term or column
    caps (the caller falls through to the classic plan)."""
    T0 = _window_t0(dev.slice_t_cap)
    lookup = dev.prefix_start_lookup
    tails = dev.prefix_tail
    plens = dev.prefix_len
    entries: list[tuple[int, int, float, int]] = []   # (s, eln, idf, bit)
    w_tail: list[float] = []
    w_start: list[int] = []
    w_len: list[int] = []
    w_idf: list[float] = []
    n_live = 0
    for i in range(len(tokens)):
        ln = int(q_len[i])
        if ln <= 0:
            continue
        n_live += 1
        tid = int(term_ids[i])
        pstart = int(lookup[tid]) if tid <= dev.base_nterms else -1
        if pstart >= 0:
            j = len(w_tail)
            if j >= _PREFIX_MAX_WIDE:
                return None
            w_tail.append(float(tails[tid]) * float(q_idf[i]))
            w_start.append(int(q_start[i]))
            w_len.append(ln)
            w_idf.append(float(q_idf[i]))
            # Windows cover the tie-free cut, not the full cap (ranks
            # past the cut are boundary ties the build excluded).
            s, eln, bit = pstart, int(plens[tid]), 1 << j
        else:
            s, eln, bit = int(q_start[i]), ln, 0
        entries.append((s, eln, float(q_idf[i]), bit))
    T0 = int(_choose_T(np.asarray(
        [[e[1] for e in entries]], dtype=np.int64), T0)[0]) \
        if entries else T0
    starts: list[int] = []
    lens: list[int] = []
    idfs: list[float] = []
    bits: list[int] = []
    for s, eln, idf, bit in entries:
        for off in range(0, eln, T0):
            starts.append(s + off)
            lens.append(min(T0, eln - off))
            idfs.append(idf)
            bits.append(bit)
    if len(starts) > _WINDOW_MAX_COLS:
        return None

    qs_pad = _qs_pad(len(starts))
    sl_start = np.zeros(qs_pad, dtype=np.int32)
    sl_len = np.zeros(qs_pad, dtype=np.int32)
    sl_idf = np.zeros(qs_pad, dtype=np.float32)
    pf_bits = np.zeros(qs_pad, dtype=np.int32)
    sl_start[: len(starts)] = starts
    sl_len[: len(starts)] = lens
    sl_idf[: len(starts)] = idfs
    pf_bits[: len(starts)] = bits
    # No wide terms: R = 0 routes the complete-plane fast path in
    # prefix_topk (2-operand sort, no rescore epilogue, always exact).
    r_pad = _bucket(len(w_tail), 1) if w_tail else 0
    pf_tail = np.zeros(r_pad, dtype=np.float32)
    pf_start = np.zeros(r_pad, dtype=np.int32)
    pf_len = np.zeros(r_pad, dtype=np.int32)
    pf_idf = np.zeros(r_pad, dtype=np.float32)
    pf_tail[: len(w_tail)] = w_tail
    pf_start[: len(w_tail)] = w_start
    pf_len[: len(w_tail)] = w_len
    pf_idf[: len(w_tail)] = w_idf
    return _Plan(q_start=q_start, q_len=q_len, q_idf=q_idf,
                 term_ids=np.asarray(term_ids, dtype=np.int64),
                 prog_ops=_PROG_DUMMY, prog_args=_PROG_DUMMY,
                 use_mask=False, use_dense=False,
                 budget=_MIN_BUDGET, depth=_MIN_DEPTH,
                 sl_start=sl_start, sl_len=sl_len, sl_idf=sl_idf,
                 sl_T=T0, n_run=_bucket(n_live, 1) if n_live else 1,
                 pf=True, pf_bits=pf_bits, pf_tail=pf_tail,
                 pf_start=pf_start, pf_len=pf_len, pf_idf=pf_idf)


def _build_plan(dev, query: Query, sp: SearchParams,
                no_prefix: bool = False) -> Optional[_Plan]:
    """Resolve a prepared query to padded device inputs, or None when
    the query produces a trivially empty result."""
    tokens = query.tokens.tokens
    if query.root is None or not tokens:
        # No meaningful tokens: empty result, not an error
        # (search.c:219-226).
        return None

    # BM25 skips every score when adl < 1 (ranking.c:161-163), and
    # both algorithms bail with empty results when doc_count == 0.
    if dev.doc_count == 0 or (sp.algo == ALGO_BM25 and dev.adl < 1.0):
        return None

    sharded = hasattr(dev, "mesh")

    # Per-query-term CSR metadata (host side; the term dictionary and
    # starts live on the host, the postings live on device).  IDF is
    # computed here in f64, matching the C double-precision arithmetic
    # (ranking.c:91,171).
    n_tok = len(tokens)
    q_pad = _bucket(n_tok, _MIN_TERMS)
    lead = (dev.n_dev,) if sharded else ()
    q_start = np.zeros(lead + (q_pad,), dtype=np.int32)
    q_len = np.zeros(lead + (q_pad,), dtype=np.int32)
    q_idf = np.zeros(q_pad, dtype=np.float32)
    row_of_token = {}
    for i, token in enumerate(tokens):
        if sharded:
            start, length = dev.term_ranges(token.term_id)
            q_start[:, i] = start
            q_len[:, i] = length
        else:
            q_start[i], q_len[i] = dev.term_range(token.term_id)
        df = dev.term_live_df(token.term_id)
        if df > 0:
            q_idf[i] = host_idf(sp.algo, dev.doc_count, df)
        row_of_token[id(token)] = i
    # Budget covers the largest per-device flat postings stream.
    total = int(q_len.sum(axis=-1).max())

    use_mask = not _is_pure_or(query.root)

    if (not no_prefix and not use_mask
            and _prefix_mode(dev, sp, sharded)):
        plan = _build_plan_prefix(
            dev, tokens, q_start, q_len, q_idf,
            [t.term_id for t in tokens])
        if plan is not None:
            return plan

    budget = _bucket(max(total, 1), _MIN_BUDGET, shift=2)
    # Dense execution (packed bitmaps + per-slot score scatter) is
    # O(B + S) with no sort; candidate scoring is O(B log B).  Dense
    # wins for >32-term queries (presence bits overflow u32) and for
    # high-df queries whose postings stream rivals the corpus size.
    # Sharded indexes use the per-shard slot count (the dense core
    # runs inside the shard_map body over shard-local slots).
    local_slots = dev.slots_per_shard if sharded else dev.n_slots
    use_dense = n_tok > MAX_BITS_TERMS or budget >= max(local_slots, 1)
    empty_leaf = q_pad if use_dense else EMPTY_LEAF_BIT
    depth = _MIN_DEPTH
    # Dummy one-op program when maskless: keeps the argument pytree
    # shape stable for shard_map specs; DCE'd when unused.
    prog_ops = np.zeros(1, dtype=np.int32)
    prog_args = np.zeros(1, dtype=np.int32)
    if use_mask:
        ops, args, max_depth = compile_program(
            query.root,
            lambda tok: row_of_token.get(id(tok), empty_leaf)
            if tok is not None else empty_leaf)
        prog_len = _bucket(len(ops), _MIN_PROG)
        prog_ops = np.zeros(prog_len, dtype=np.int32)
        prog_ops[: len(ops)] = ops
        prog_args = np.zeros(prog_len, dtype=np.int32)
        prog_args[: len(args)] = args
        depth = _bucket(max_depth, _MIN_DEPTH)

    # Heavy terms with a dense device row (blockdense path only;
    # overflow beyond _MAX_DENSE_PER_QUERY stays in the kernel --
    # exact either way).
    d_qpos = np.full(_MAX_DENSE_PER_QUERY, -1, dtype=np.int32)
    d_row = np.full(_MAX_DENSE_PER_QUERY, -1, dtype=np.int32)
    row_of = getattr(dev, "dense_row_of", None)
    if row_of:
        j = 0
        for i, token in enumerate(tokens):
            if j >= _MAX_DENSE_PER_QUERY:
                break
            h = row_of.get(token.term_id)
            if h is not None:
                d_qpos[j] = i
                d_row[j] = h
                j += 1

    # Sliced-executor inputs: non-dense terms compacted in token order
    # (for masked queries no term is dense-handled on the sliced path,
    # so column index == token row == presence-bit index).
    d_idf = np.zeros(_MAX_DENSE_PER_QUERY, dtype=np.float32)
    for j in range(_MAX_DENSE_PER_QUERY):
        if d_qpos[j] >= 0:
            d_idf[j] = q_idf[d_qpos[j]]
    dense_set = {int(x) for x in d_qpos if x >= 0}
    csr_cols = [i for i in range(n_tok) if i not in dense_set]

    # Masked hybrid verdict table: the program evaluated on every
    # dense-only presence pattern (documents matched by no CSR term
    # are gated by this on the dense-sweep side).
    d_pass_v = None
    if use_mask and _MASKED_HYBRID and dense_set:
        nd = _MAX_DENSE_PER_QUERY
        pats = np.zeros((EMPTY_LEAF_BIT + 1, 1 << nd), np.bool_)
        for m in range(1 << nd):
            for j in range(nd):
                if d_qpos[j] >= 0 and (m >> j) & 1:
                    pats[min(int(d_qpos[j]), EMPTY_LEAF_BIT - 1), m] = \
                        True
        d_pass_v = _eval_program_np(pats, prog_ops, prog_args)

    # Head-term extraction (sliced path): the heaviest CSR term leaves
    # the sort plane for the searchsorted + top_k merge when its df
    # clears the tier threshold -- sorting costs far more per lane
    # than top_k, and high-df terms dominate the sort.  Sharded
    # plans carry per-shard head ranges (the merge is shard-local);
    # eligibility and the tier use the max per-shard length.
    h_start_v = h_len_v = 0
    h_idf_v = 0.0
    h_row_v = -1
    h_T = 0
    h_pass_v = True
    if not dense_set and len(csr_cols) >= 2:
        lens = [int(q_len[..., c].max()) for c in csr_cols]
        hmax = max(lens)
        min_df = _HEAD_MIN_DF_PAIR if len(csr_cols) == 2 else _HEAD_MIN_DF
        if hmax >= min_df and hmax <= DeviceIndex.SLICE_MAX_T:
            hcol = csr_cols[lens.index(hmax)]
            if sharded:
                h_start_v = q_start[:, hcol].copy()
                h_len_v = q_len[:, hcol].copy()
            else:
                h_start_v = int(q_start[hcol])
                h_len_v = hmax
            h_idf_v = float(q_idf[hcol])
            h_row_v = hcol
            h_T = _head_tier(hmax, dev.slice_t_cap)
            csr_cols = [c for c in csr_cols if c != hcol]
            if use_mask:
                present = np.zeros((EMPTY_LEAF_BIT + 1, 1), np.bool_)
                present[min(h_row_v, EMPTY_LEAF_BIT - 1)] = True
                h_pass_v = bool(_eval_program_np(
                    present, prog_ops, prog_args)[0])

    # Windowed plane: split each CSR term into ceil(df/T0) fixed-width
    # windows so the sort plane holds ~df lanes.  Sharded plans window
    # on the max per-shard length, so the column -> token-row map and
    # the column count stay replicated across devices (shards with
    # fewer windows carry zero-length columns, whose lanes are all
    # invalid).  Queries whose windows overflow the column cap keep
    # the legacy tiered plane.
    T0 = _window_t0(dev.slice_t_cap)
    live_cols = [i for i in csr_cols if int(q_len[..., i].max()) > 0]
    if live_cols:
        # Per-row variable window width (same chooser as the batch
        # planner; sharded rows size windows on the max per-shard
        # length so the column layout stays replicated).
        T0 = int(_choose_T(np.asarray(
            [[int(q_len[..., i].max()) for i in live_cols]],
            dtype=np.int64), T0)[0])
    n_w = sum(-(-int(q_len[..., i].max()) // T0) for i in live_cols)
    if not sharded and n_w <= _WINDOW_MAX_COLS:
        # Vectorized ragged window expansion: a monster term yields
        # thousands of windows, too many for a python per-window
        # loop.
        cl = np.asarray([int(q_len[i]) for i in live_cols],
                        dtype=np.int64)
        cs = np.asarray([int(q_start[i]) for i in live_cols],
                        dtype=np.int64)
        ci = np.asarray(live_cols, dtype=np.int64)
        wcnt = -(-cl // T0) if len(cl) else cl
        cell_of = np.repeat(np.arange(len(ci)), wcnt)
        wi = (np.arange(cell_of.size, dtype=np.int64)
              - np.repeat(np.cumsum(wcnt) - wcnt, wcnt))
        n_wins = cell_of.size
        qs_pad = _qs_pad(n_wins)
        sl_start = np.zeros(qs_pad, dtype=np.int32)
        sl_len = np.zeros(qs_pad, dtype=np.int32)
        sl_idf = np.zeros(qs_pad, dtype=np.float32)
        sl_rows = np.zeros(qs_pad, dtype=np.int32)
        sl_start[:n_wins] = cs[cell_of] + wi * T0
        sl_len[:n_wins] = np.minimum(cl[cell_of] - wi * T0, T0)
        sl_idf[:n_wins] = q_idf[ci[cell_of]]
        sl_rows[:n_wins] = ci[cell_of]
        sl_T = T0
        n_run = _bucket(len(live_cols), 1) if live_cols else 1
        single_v = n_tok == 1 and not use_mask and n_wins <= 1
    elif sharded and n_w <= _WINDOW_MAX_COLS:
        cols = [(i, j)
                for i in live_cols
                for j in range(-(-int(q_len[..., i].max()) // T0))]
        qs_pad = _qs_pad(len(cols))
        sl_start = np.zeros(lead + (qs_pad,), dtype=np.int32)
        sl_len = np.zeros(lead + (qs_pad,), dtype=np.int32)
        sl_idf = np.zeros(qs_pad, dtype=np.float32)
        sl_rows = np.zeros(qs_pad, dtype=np.int32)
        for c, (i, j) in enumerate(cols):
            # Clamp a zero-length column's start into the shard's own
            # range so the window read never leaves the pack (its
            # lanes are all invalid either way).
            off = np.minimum(j * T0, np.maximum(q_len[:, i] - 1, 0))
            sl_start[:, c] = q_start[:, i] + off
            sl_len[:, c] = np.clip(q_len[:, i] - j * T0, 0, T0)
            sl_idf[c] = q_idf[i]
            sl_rows[c] = i
        sl_T = T0
        n_run = _bucket(len(live_cols), 1) if live_cols else 1
        single_v = n_tok == 1 and not use_mask and len(cols) <= 1
    else:
        qs_pad = _qs_pad(len(csr_cols))
        sl_start = np.zeros(lead + (qs_pad,), dtype=np.int32)
        sl_len = np.zeros(lead + (qs_pad,), dtype=np.int32)
        sl_idf = np.zeros(qs_pad, dtype=np.float32)
        for col, i in enumerate(csr_cols):
            sl_start[..., col] = q_start[..., i]
            sl_len[..., col] = q_len[..., i]
            sl_idf[col] = q_idf[i]
        sl_T = _slice_tier(int(sl_len.max()) if sl_len.size else 0,
                           dev.slice_t_cap)
        sl_rows = None
        n_run = 0
        single_v = n_tok == 1 and not use_mask

    # Sharded prefix plans: a pure-OR windowed plan on the mesh IS an
    # R = 0 prefix plan (per-shard windows cover each shard's postings
    # in full), so the flagship executor serves multi-chip too.
    pf_v = False
    pf_bits_v = pf_tail_v = pf_start_v = pf_len_v = pf_idf_v = None
    if (sharded and not no_prefix and not use_mask and n_run > 0
            and h_T == 0 and not bool((d_qpos >= 0).any())
            and _prefix_mode_sharded(dev, sp)):
        pf_v = True
        pf_bits_v = np.zeros(sl_start.shape[-1], dtype=np.int32)
        pf_tail_v = np.zeros(0, dtype=np.float32)
        pf_start_v = np.zeros(0, dtype=np.int32)
        pf_len_v = np.zeros(0, dtype=np.int32)
        pf_idf_v = np.zeros(0, dtype=np.float32)

    return _Plan(q_start=q_start, q_len=q_len, q_idf=q_idf,
                 term_ids=np.asarray([t.term_id for t in tokens],
                                     dtype=np.int64),
                 prog_ops=prog_ops, prog_args=prog_args,
                 use_mask=use_mask, use_dense=use_dense,
                 budget=budget, depth=depth,
                 d_qpos=d_qpos, d_row=d_row, d_idf=d_idf,
                 sl_start=sl_start, sl_len=sl_len, sl_idf=sl_idf,
                 sl_T=sl_T, sl_rows=sl_rows, n_run=n_run,
                 single=single_v,
                 h_start=h_start_v, h_len=h_len_v, h_idf=h_idf_v,
                 h_row=h_row_v, h_T=h_T, h_pass=h_pass_v,
                 d_pass=d_pass_v,
                 pf=pf_v, pf_bits=pf_bits_v, pf_tail=pf_tail_v,
                 pf_start=pf_start_v, pf_len=pf_len_v,
                 pf_idf=pf_idf_v)


# Shared read-only dummy program for unmasked plans (kept 1-op so the
# argument pytree shape is stable; DCE'd when unused).
_PROG_DUMMY = np.zeros(1, dtype=np.int32)
_PROG_DUMMY.setflags(write=False)


def _pow2ceil(x: np.ndarray) -> np.ndarray:
    """Elementwise next power of two (>= 1) for small positive ints."""
    x = np.maximum(x, 1)
    return (1 << np.ceil(np.log2(x)).astype(np.int64)).astype(np.int64)


def _build_plans(dev, queries: list[Query], sp: SearchParams,
                 no_prefix: bool = False) -> list[Optional[_Plan]]:
    """Batch twin of _build_plan: one vectorized numpy pass plans every
    simple (pure-OR, non-sharded) query; the rest fall back to the
    per-query path.  Field-for-field identical plans, without the
    per-query planner's small-array Python per query."""
    n_q = len(queries)
    plans: list[Optional[_Plan]] = [None] * n_q
    if dev.doc_count == 0 or (sp.algo == ALGO_BM25 and dev.adl < 1.0):
        return plans

    sharded = hasattr(dev, "mesh")
    lookup = getattr(dev, "dense_row_lookup", None)
    simple: list[int] = []
    for i, q in enumerate(queries):
        tokens = q.tokens.tokens
        if q.root is None or not tokens:
            continue
        if (sharded or lookup is None or len(tokens) > MAX_BITS_TERMS
                or not _is_pure_or(q.root)):
            plans[i] = _build_plan(dev, q, sp, no_prefix=no_prefix)
            continue
        simple.append(i)
    if not simple:
        return plans

    ns = len(simple)
    counts = np.fromiter((len(queries[i].tokens.tokens) for i in simple),
                         np.int64, ns)
    total_tok = int(counts.sum())
    flat_tid = np.fromiter(
        (t.term_id for i in simple for t in queries[i].tokens.tokens),
        np.int64, total_tok)
    offs = np.zeros(ns + 1, np.int64)
    np.cumsum(counts, out=offs[1:])

    base_n = dev.base_nterms
    ts = dev.term_starts
    tid_c = np.minimum(flat_tid, base_n)
    in_base = flat_tid <= base_n
    st_f = np.where(in_base, ts[tid_c - 1], 0).astype(np.int32)
    ln_f = np.where(in_base, ts[tid_c] - ts[tid_c - 1], 0).astype(np.int32)
    df_f = np.asarray(dev.host.term_df.a[flat_tid - 1], dtype=np.int64)
    # IDF in f64, same arithmetic as host_idf (ranking.c:91,171).
    with np.errstate(divide="ignore", invalid="ignore"):
        if sp.algo == ALGO_TFIDF:
            ratio = (np.float32(dev.doc_count)
                     / df_f.astype(np.float32)).astype(np.float64)
            idf64 = np.log(ratio) + 1.0
        else:
            idf64 = np.log((dev.doc_count - df_f + 0.5)
                           / (df_f + 0.5) + 1.0)
    idf_f = np.where(df_f > 0, idf64, 0.0).astype(np.float32)
    drow_f = np.where(in_base, lookup[tid_c], -1).astype(np.int32)

    # [ns, mp] matrices, token row-major scatter.
    mp = int(_bucket(int(counts.max()), _MIN_TERMS))
    row_f = np.repeat(np.arange(ns, dtype=np.int64), counts)
    col_f = np.arange(total_tok, dtype=np.int64) - offs[:-1][row_f]
    st_m = np.zeros((ns, mp), np.int32)
    ln_m = np.zeros((ns, mp), np.int32)
    idf_m = np.zeros((ns, mp), np.float32)
    st_m[row_f, col_f] = st_f
    ln_m[row_f, col_f] = ln_f
    idf_m[row_f, col_f] = idf_f

    if not no_prefix and _prefix_mode(dev, sp, sharded):
        return _plans_prefix(
            dev, sp, queries, plans, simple, counts, offs, flat_tid,
            tid_c, in_base, row_f, col_f, st_m, ln_m, idf_m)

    # Dense-row split: first _MAX_DENSE_PER_QUERY dense-capable tokens
    # take a dense row; overflow stays in the CSR columns.
    isdense_m = np.zeros((ns, mp), bool)
    isdense_m[row_f, col_f] = drow_f >= 0
    dord = np.cumsum(isdense_m, axis=1) - 1
    take = isdense_m & (dord < _MAX_DENSE_PER_QUERY)
    any_dense = bool(take.any())
    d_qpos_m = np.full((ns, _MAX_DENSE_PER_QUERY), -1, np.int32)
    d_row_m = np.full((ns, _MAX_DENSE_PER_QUERY), -1, np.int32)
    d_idf_m = np.zeros((ns, _MAX_DENSE_PER_QUERY), np.float32)
    valid_m = np.zeros((ns, mp), bool)
    valid_m[row_f, col_f] = True
    if any_dense:
        drow_m = np.full((ns, mp), -1, np.int32)
        drow_m[row_f, col_f] = drow_f
        tr, tc = np.nonzero(take)
        d_qpos_m[tr, dord[tr, tc]] = tc.astype(np.int32)
        d_row_m[tr, dord[tr, tc]] = drow_m[tr, tc]
        d_idf_m[tr, dord[tr, tc]] = idf_m[tr, tc]
        iscsr = valid_m & ~take
    else:
        iscsr = valid_m

    # Head-term extraction (matches _build_plan): rows without dense
    # terms whose heaviest CSR term clears the tier threshold move it
    # out of the sort plane (pure-OR here, so h_pass is always True).
    ln_csr = np.where(iscsr, ln_m, 0)
    row_max = ln_csr.max(axis=1)
    n_csr0 = iscsr.sum(axis=1)
    min_df_row = np.where(n_csr0 == 2, _HEAD_MIN_DF_PAIR, _HEAD_MIN_DF)
    elig = ((~take.any(axis=1)) & (n_csr0 >= 2)
            & (row_max >= min_df_row)
            & (row_max <= DeviceIndex.SLICE_MAX_T))
    any_head = bool(elig.any())
    h_col = np.argmax(ln_csr, axis=1)
    if any_head:
        ishead = np.zeros((ns, mp), bool)
        er = np.nonzero(elig)[0]
        ishead[er, h_col[er]] = True
        iscsr = iscsr & ~ishead

    # Windowed plane construction: each CSR cell of length ln becomes
    # ceil(ln/T) fixed-width window columns (vectorized ragged
    # expansion), so the sort plane holds ~postings lanes instead of a
    # power-of-8 tier pad per term.  T is chosen PER ROW from the rung
    # ladder (variable-width windows; see _choose_T).
    T0 = _window_t0(dev.slice_t_cap)
    ln_csr = np.where(iscsr, ln_m, 0)
    T_row = _choose_T(ln_csr, T0)
    w_m = -(-ln_csr // T_row[:, None])   # windows per (row, cell)
    n_w = w_m.sum(axis=1)                # windows per query
    n_csr = (w_m > 0).sum(axis=1)        # logical CSR terms (df > 0)

    # Queries whose windows overflow the column cap keep the
    # per-query planner's legacy tiered plane.  no_prefix must thread
    # through: a certification-fallback batch re-entering the prefix
    # planner here would recurse forever (observed on the 8.8M tier,
    # whose mix has over-wide rows).
    over = n_w > _WINDOW_MAX_COLS
    if bool(over.any()):
        for j in np.nonzero(over)[0]:
            i = simple[j]
            plans[i] = _build_plan(dev, queries[i], sp,
                                   no_prefix=no_prefix)
        w_m[over] = 0
        n_w[over] = 0

    rr, cc = np.nonzero(w_m > 0)         # cells, row-major order
    wcnt = w_m[rr, cc]
    cell_of = np.repeat(np.arange(len(rr), dtype=np.int64), wcnt)
    wi = (np.arange(cell_of.size, dtype=np.int64)
          - np.repeat(np.cumsum(wcnt) - wcnt, wcnt))
    wr = rr[cell_of]                     # query row per window
    t_w = T_row[wr]                      # window width per lane
    w_start = (st_m[rr, cc][cell_of] + wi * t_w).astype(np.int32)
    w_len = np.minimum(ln_csr[rr, cc][cell_of] - wi * t_w, t_w
                       ).astype(np.int32)
    w_idf = idf_m[rr, cc][cell_of]
    w_row = cc[cell_of].astype(np.int32)  # token row (presence bit)
    # Column index within each query row (windows are row-major).
    row_first = np.zeros(ns + 1, np.int64)
    np.cumsum(n_w, out=row_first[1:])
    wcol = np.arange(wr.size, dtype=np.int64) - row_first[:-1][wr]

    qs_pad = np.where(n_w <= 1, 1, np.maximum(_QS_MIN, _pow2ceil(n_w)))
    qs_max = int(qs_pad.max()) if len(qs_pad) else 1
    sl_start_m = np.zeros((ns, qs_max), np.int32)
    sl_len_m = np.zeros((ns, qs_max), np.int32)
    sl_idf_m = np.zeros((ns, qs_max), np.float32)
    sl_rows_m = np.zeros((ns, qs_max), np.int32)
    sl_start_m[wr, wcol] = w_start
    sl_len_m[wr, wcol] = w_len
    sl_idf_m[wr, wcol] = w_idf
    sl_rows_m[wr, wcol] = w_row
    n_run = np.where(n_csr <= 1, 1, _pow2ceil(n_csr))

    t_cap = min(DeviceIndex.SLICE_MAX_T, dev.slice_t_cap)
    h_t = np.where(elig,
                   np.minimum(np.where(row_max <= 65536, 65536,
                                       DeviceIndex.SLICE_MAX_T), t_cap),
                   0)

    # Per-query scalars.
    totals = ln_m.sum(axis=1, dtype=np.int64)
    x = np.maximum(totals, 1)
    exp = np.maximum(np.ceil((np.log2(x) - np.log2(_MIN_BUDGET)) / 2.0),
                     0).astype(np.int64)
    budget = (_MIN_BUDGET << (2 * exp)).astype(np.int64)
    q_pad = _pow2ceil(np.maximum(counts, _MIN_TERMS))
    use_dense = budget >= max(dev.n_slots, 1)

    for j, i in enumerate(simple):
        if plans[i] is not None:         # over-wide fallback above
            continue
        qp = int(q_pad[j])
        head = bool(elig[j])
        hc = int(h_col[j])
        plans[i] = _Plan(
            q_start=st_m[j, :qp], q_len=ln_m[j, :qp],
            q_idf=idf_m[j, :qp],
            term_ids=flat_tid[offs[j]: offs[j + 1]],
            prog_ops=_PROG_DUMMY, prog_args=_PROG_DUMMY,
            use_mask=False, use_dense=bool(use_dense[j]),
            budget=int(budget[j]), depth=_MIN_DEPTH,
            d_qpos=d_qpos_m[j], d_row=d_row_m[j], d_idf=d_idf_m[j],
            sl_start=sl_start_m[j, : qs_pad[j]],
            sl_len=sl_len_m[j, : qs_pad[j]],
            sl_idf=sl_idf_m[j, : qs_pad[j]],
            sl_T=int(T_row[j]),
            sl_rows=sl_rows_m[j, : qs_pad[j]],
            n_run=int(n_run[j]),
            single=bool(counts[j] == 1 and n_w[j] <= 1),
            h_start=int(st_m[j, hc]) if head else 0,
            h_len=int(row_max[j]) if head else 0,
            h_idf=float(idf_m[j, hc]) if head else 0.0,
            h_row=hc if head else -1,
            h_T=int(h_t[j]))
    return plans


def _plans_prefix(dev, sp, queries, plans, simple, counts, offs,
                  flat_tid, tid_c, in_base, row_f, col_f,
                  st_m, ln_m, idf_m) -> list[Optional[_Plan]]:
    """Vectorized impact-prefix twin of _plans' classic tail: every
    simple row becomes a prefix plan (wide terms window over their
    top-CAP impact region, complete terms over their full range); rows
    exceeding the wide-term or column caps fall back to the per-query
    planner.  Field-for-field identical to _build_plan_prefix."""
    ns = len(simple)
    mp = st_m.shape[1]
    T0 = _window_t0(dev.slice_t_cap)
    pfx_f = np.where(in_base, dev.prefix_start_lookup[tid_c],
                     np.int32(-1))
    tail_f = np.where(in_base, dev.prefix_tail[tid_c],
                      np.float32(0.0)).astype(np.float32)
    plen_f = np.where(in_base, dev.prefix_len[tid_c], np.int32(0))
    wide_f = pfx_f >= 0

    valid_m = np.zeros((ns, mp), bool)
    valid_m[row_f, col_f] = True
    wide_m = np.zeros((ns, mp), bool)
    wide_m[row_f, col_f] = wide_f
    pfx_m = np.zeros((ns, mp), np.int32)
    pfx_m[row_f, col_f] = pfx_f
    tail_m = np.zeros((ns, mp), np.float32)
    tail_m[row_f, col_f] = tail_f
    plen_m = np.zeros((ns, mp), np.int32)
    plen_m[row_f, col_f] = plen_f

    # Wide terms window over their tie-free cut (<= cap; ranks past
    # it are boundary ties the build excluded -- see _prefix_build_dev).
    ln_eff = np.where(valid_m, np.where(wide_m, plen_m, ln_m), 0)
    st_eff = np.where(wide_m, pfx_m, st_m)
    word = np.cumsum(wide_m, axis=1) - 1      # wide index j per cell
    n_wide = wide_m.sum(axis=1)

    T_row = _choose_T(ln_eff, T0)        # variable-width windows
    w_m = -(-ln_eff // T_row[:, None])
    n_w = w_m.sum(axis=1)
    n_live = (ln_eff > 0).sum(axis=1)

    over = (n_w > _WINDOW_MAX_COLS) | (n_wide > _PREFIX_MAX_WIDE)
    if bool(over.any()):
        for j in np.nonzero(over)[0]:
            i = simple[j]
            plans[i] = _build_plan(dev, queries[i], sp)
        w_m[over] = 0
        n_w[over] = 0

    rr, cc = np.nonzero(w_m > 0)
    wcnt = w_m[rr, cc]
    cell_of = np.repeat(np.arange(len(rr), dtype=np.int64), wcnt)
    wi = (np.arange(cell_of.size, dtype=np.int64)
          - np.repeat(np.cumsum(wcnt) - wcnt, wcnt))
    wr = rr[cell_of]
    t_w = T_row[wr]
    w_start = (st_eff[rr, cc][cell_of] + wi * t_w).astype(np.int32)
    w_len = np.minimum(ln_eff[rr, cc][cell_of] - wi * t_w, t_w
                       ).astype(np.int32)
    w_idf = idf_m[rr, cc][cell_of]
    bit_cell = np.where(wide_m[rr, cc],
                        1 << np.minimum(word[rr, cc], 31), 0)
    w_bit = bit_cell[cell_of].astype(np.int32)
    row_first = np.zeros(ns + 1, np.int64)
    np.cumsum(n_w, out=row_first[1:])
    wcol = np.arange(wr.size, dtype=np.int64) - row_first[:-1][wr]

    qs_pad = np.where(n_w <= 1, 1, np.maximum(_QS_MIN, _pow2ceil(n_w)))
    qs_max = int(qs_pad.max()) if len(qs_pad) else 1
    sl_start_m = np.zeros((ns, qs_max), np.int32)
    sl_len_m = np.zeros((ns, qs_max), np.int32)
    sl_idf_m = np.zeros((ns, qs_max), np.float32)
    pf_bits_m = np.zeros((ns, qs_max), np.int32)
    sl_start_m[wr, wcol] = w_start
    sl_len_m[wr, wcol] = w_len
    sl_idf_m[wr, wcol] = w_idf
    pf_bits_m[wr, wcol] = w_bit

    wr2, wc2 = np.nonzero(wide_m)
    j2 = word[wr2, wc2]
    pf_tail_m = np.zeros((ns, _PREFIX_MAX_WIDE), np.float32)
    pf_start_m = np.zeros((ns, _PREFIX_MAX_WIDE), np.int32)
    pf_len_m = np.zeros((ns, _PREFIX_MAX_WIDE), np.int32)
    pf_idf_m = np.zeros((ns, _PREFIX_MAX_WIDE), np.float32)
    keep2 = j2 < _PREFIX_MAX_WIDE      # over rows were zeroed above
    wr2, wc2, j2 = wr2[keep2], wc2[keep2], j2[keep2]
    pf_tail_m[wr2, j2] = tail_m[wr2, wc2] * idf_m[wr2, wc2]
    pf_start_m[wr2, j2] = st_m[wr2, wc2]
    pf_len_m[wr2, j2] = ln_m[wr2, wc2]
    pf_idf_m[wr2, j2] = idf_m[wr2, wc2]
    # Fallback rows must not carry wide entries (their plan comes from
    # the per-query planner; these arrays are unused there).
    if bool(over.any()):
        pf_tail_m[over] = 0.0
        pf_len_m[over] = 0

    n_run = np.where(n_live <= 1, 1, _pow2ceil(n_live))
    # n_wide == 0 -> R = 0: the complete-plane fast path (2-operand
    # sort, no bound/rescore epilogue, exact by construction).
    r_pad = np.where(n_wide == 0, 0,
                     np.where(n_wide <= 1, 1, _pow2ceil(np.minimum(
                         n_wide, _PREFIX_MAX_WIDE))))
    q_pad = _pow2ceil(np.maximum(counts, _MIN_TERMS))
    for j, i in enumerate(simple):
        if plans[i] is not None:
            continue
        qp = int(q_pad[j])
        rp = int(r_pad[j])
        plans[i] = _Plan(
            q_start=st_m[j, :qp], q_len=ln_m[j, :qp],
            q_idf=idf_m[j, :qp],
            term_ids=flat_tid[offs[j]: offs[j + 1]],
            prog_ops=_PROG_DUMMY, prog_args=_PROG_DUMMY,
            use_mask=False, use_dense=False,
            budget=_MIN_BUDGET, depth=_MIN_DEPTH,
            sl_start=sl_start_m[j, : qs_pad[j]],
            sl_len=sl_len_m[j, : qs_pad[j]],
            sl_idf=sl_idf_m[j, : qs_pad[j]],
            sl_T=int(T_row[j]), n_run=int(n_run[j]),
            pf=True, pf_bits=pf_bits_m[j, : qs_pad[j]],
            pf_tail=pf_tail_m[j, :rp], pf_start=pf_start_m[j, :rp],
            pf_len=pf_len_m[j, :rp], pf_idf=pf_idf_m[j, :rp])
    return plans


def _eval_program_np(present: np.ndarray, prog_ops: np.ndarray,
                     prog_args: np.ndarray) -> np.ndarray:
    """Host postfix-program evaluation over a presence matrix
    (bool[R, n]); the numpy twin of ops/boolean eval for delta docs."""
    from .ops.boolean import OP_AND, OP_ANDNOT, OP_NOP, OP_OR, OP_PUSH

    n = present.shape[1]
    stack: list[np.ndarray] = []
    for op, arg in zip(prog_ops, prog_args):
        if op == OP_NOP:
            continue
        if op == OP_PUSH:
            row = present[arg] if arg < present.shape[0] \
                else np.zeros(n, dtype=np.bool_)
            stack.append(row)
        else:
            b = stack.pop()
            a = stack.pop()
            if op == OP_AND:
                stack.append(a & b)
            elif op == OP_OR:
                stack.append(a | b)
            elif op == OP_ANDNOT:
                stack.append(a & ~b)
    return stack[0] if stack else np.zeros(n, dtype=np.bool_)


def _delta_results(dev, plan: _Plan, sp: SearchParams):
    """Score the post-snapshot delta on the host (same formulas as the
    device executors, f32 arithmetic).  Returns (slots, scores) of
    live matching delta documents, or None when there is no delta."""
    if not getattr(dev, "has_delta", False):
        return None
    from .ops.scoring import BM25_B, BM25_K1

    host = dev.host
    slot0 = dev.delta_slot0
    n_new = host.doc_ids.n - slot0
    if n_new <= 0:
        return None

    n_tok = len(plan.term_ids)
    acc = np.zeros(n_new, dtype=np.float32)
    present = np.zeros((n_tok, n_new), dtype=np.bool_) if plan.use_mask \
        else None
    adl = np.float32(dev.adl)
    for i, term_id in enumerate(plan.term_ids):
        # Term-sorted delta index: O(log delta + matches) per term
        # instead of a full boolean scan of the delta per (query, term).
        t_count, t_slot = dev.delta_lookup(int(term_id))
        if not len(t_count):
            continue
        rows = t_slot.astype(np.int64) - slot0
        ltf = np.log(t_count.astype(np.float64) + 1.0).astype(np.float32)
        idf = np.float32(plan.q_idf[i])
        if sp.algo == ALGO_BM25:
            dl = host.doc_len.a[t_slot].astype(np.float32)
            denom = ltf + np.float32(BM25_K1) * (
                np.float32(1.0 - BM25_B) + np.float32(BM25_B) * dl / adl)
            contrib = ltf / denom * idf
        else:
            contrib = ltf * idf
        np.add.at(acc, rows, contrib)
        if present is not None:
            present[i, rows] = True

    if present is not None:
        keep = _eval_program_np(present, plan.prog_ops, plan.prog_args)
        acc = np.where(keep, acc, np.float32(0.0))
    alive = host.doc_alive.a[slot0: slot0 + n_new]
    acc = np.where(alive, acc, np.float32(0.0))
    nz = np.nonzero(acc > 0.0)[0]
    if not len(nz):
        return None
    return nz + slot0, acc[nz]


def _use_sliced(plan: _Plan, sharded: bool, dev) -> bool:
    """The sliced executor is the exact fast path for selective
    queries: contiguous per-term postings windows (no random gathers),
    one variadic sort, segmented-scan aggregation (ops/executor.py
    sliced_topk).  With dense-row terms it becomes the pure-OR hybrid
    (candidate plane scatter-max-merged into the dense-row sweep).

    Exclusions: sharded indexes (those route to the shard_map twin),
    slot counts that overflow exact f32 packing, terms wider than the
    slice guard, masked queries with dense-handled terms (unless the
    masked hybrid is enabled: candidate lanes gather dense presence
    bits and dense-only documents are gated by a host-evaluated
    verdict table), and very wide queries.
    """
    if sharded or getattr(dev, "postings_pack", None) is None:
        return False
    from .index.device import DeviceIndex
    cols_cap = _WINDOW_MAX_COLS if plan.n_run else 64
    # The masked hybrid needs the explicit column -> token-row map of
    # windowed plans (dense terms leave gaps in the column order, so
    # column index != token row on the tiered fallback).
    masked_rows_ok = (_MASKED_HYBRID and plan.d_pass is not None
                      and plan.n_run > 0)
    return (dev.n_slots < (1 << 24)
            and plan.sl_T <= DeviceIndex.SLICE_MAX_T
            and len(plan.sl_start) <= cols_cap
            and not (plan.use_mask and plan.use_rows
                     and not masked_rows_ok)
            and (not plan.use_mask or plan.q_start.shape[-1] <= 32))


def _to_response(dev, scores, slots, limit: int, delta=None) -> Response:
    scores = np.asarray(scores)
    slots = np.asarray(slots)
    matched = scores > 0.0
    scores = scores[matched]
    slots = slots[matched]
    perm = getattr(dev, "slot_perm", None)
    if perm is not None:
        # Device slots are dl-ordered; translate back to host slots
        # before doc-id lookup and delta merging (delta slots are
        # host-ordered).
        slots = perm[slots.astype(np.int64)]
    if delta is not None:
        d_slots, d_scores = delta
        slots = np.concatenate([slots.astype(np.int64), d_slots])
        scores = np.concatenate([scores, d_scores])
        order = np.argsort(-scores, kind="stable")
        slots = slots[order]
        scores = scores[order]
    doc_ids = dev.doc_ids
    results = [
        (int(doc_ids[slot]), float(score))
        for score, slot in zip(scores[:limit], slots[:limit])
    ]
    return Response(results)


def _route_error(plan: _Plan) -> str:
    route = ("masked sliced" if plan.use_mask else
             "dense" if plan.use_dense else "blockdense/candidate")
    return (f"query routes to the {route} executor, which is not ported "
            "(only the impact-prefix R = 0 'pf' and pure-OR sliced "
            "'sl' executors are)")


def _upload(dev, buf: np.ndarray) -> torch.Tensor:
    """One host->device copy of a group's packed int32 inputs."""
    return torch.from_numpy(buf).to(dev.device)


def _dispatch_prefix(dev, sl_start, sl_len, sl_idf, pf_bits, pf_tail,
                     pf_start, pf_len, pf_idf, *, sp: SearchParams,
                     k: int, n_run: int, T: int):
    """Dispatch one impact-prefix group ([n, qs] plan arrays); returns
    the packed device result f32[n, 3, k']."""
    from .ops.executor import pack_prefix_group, prefix_topk_packed
    buf = pack_prefix_group(sl_start, sl_len, sl_idf, pf_bits, pf_tail,
                            pf_start, pf_len, pf_idf)
    return prefix_topk_packed(
        dev.postings_pack, dev.alive_mask, _upload(dev, buf), dev.adl_dev,
        qs=sl_start.shape[1], R=pf_tail.shape[1], T=T, k=k,
        algo=sp.algo, n_slots=dev.n_slots, alive_all=dev.alive_all,
        n_run=n_run)


def _dispatch_sliced_single(dev, plan: _Plan, sp: SearchParams, k: int):
    """Dispatch ONE query's sliced-executor call; returns the packed
    device result f32[1, 2, k']."""
    from .ops.executor import pack_sliced_group, sliced_topk_packed
    t_head = plan.h_T
    use_rows = plan.use_rows
    buf = pack_sliced_group(
        plan.sl_start[None], plan.sl_len[None], plan.sl_idf[None],
        plan.d_row[None] if use_rows else None,
        plan.d_idf[None] if use_rows else None,
        np.asarray([plan.h_start], np.int32) if t_head else None,
        np.asarray([plan.h_len], np.int32) if t_head else None,
        np.asarray([plan.h_idf], np.float32) if t_head else None,
        np.asarray([plan.h_row], np.int32) if t_head else None,
        np.asarray([plan.h_pass], np.bool_) if t_head else None)
    return sliced_topk_packed(
        dev.postings_pack, dev.alive_mask, dev.doc_len, _upload(dev, buf),
        dev.adl_dev, dev.dense_rows if use_rows else None,
        qs=len(plan.sl_start), D=_MAX_DENSE_PER_QUERY, T=plan.sl_T, k=k,
        algo=sp.algo, n_slots=dev.n_slots, use_mask=plan.use_mask,
        single=plan.single, alive_all=dev.alive_all, use_rows=use_rows,
        T_head=t_head, n_run=plan.n_run)


def execute_query(dev, query: Query, sp: SearchParams) -> Response:
    """Run one prepared query against the device snapshot."""
    from .ops.executor import unpack_prefix, unpack_sliced
    plan = _build_plan(dev, query, sp)
    if plan is None:
        return Response()
    k = _bucket(min(sp.limit, dev.n_slots), _MIN_K)
    if plan.pf:
        packed = _dispatch_prefix(
            dev, plan.sl_start[None], plan.sl_len[None], plan.sl_idf[None],
            plan.pf_bits[None], plan.pf_tail[None], plan.pf_start[None],
            plan.pf_len[None], plan.pf_idf[None], sp=sp, k=k,
            n_run=plan.n_run, T=plan.sl_T)
        scores, slots, _exact = unpack_prefix(packed.cpu().numpy())
        _count("prefix")
        _count("prefix_exact")
        return _to_response(dev, scores[0], slots[0], sp.limit,
                            delta=_delta_results(dev, plan, sp))
    if _use_sliced(plan, False, dev):
        packed = _dispatch_sliced_single(dev, plan, sp, k)
        scores, slots = unpack_sliced(packed.cpu().numpy())
        _count("sliced")
        if plan.h_T:
            _count("sliced_head")
        return _to_response(dev, scores[0], slots[0], sp.limit,
                            delta=_delta_results(dev, plan, sp))
    raise NotImplementedError(_route_error(plan))


@dataclass
class _PendingBatch:
    """In-flight batch state between submit and collect: every group
    has been enqueued on the device and the batch's one device->host
    copy has started."""
    plans: list
    responses: list
    pending: list          # (members, packed device result, tag)
    fetch: tuple           # (host tensor, copy-done event, shapes)
    t_dispatch: float
    t_submitted: float


def execute_query_batch(dev, queries: list[Query],
                        sp: SearchParams) -> list[Response]:
    """Execute many prepared queries with batched device dispatches.

    Queries are planned host-side, grouped by static signature, and
    each group runs as ONE vmapped device call over the shared
    snapshot -- amortizing dispatch and filling the chip.  Results are
    identical to per-query execution.
    """
    return collect_query_batch(dev, submit_query_batch(dev, queries, sp),
                               sp)


# Group coalescing: a mixed batch shatters into many fine signature
# groups, most holding < 64 rows but each costing a dispatch and a
# plan upload.  Small sliced groups that differ only in the cheap
# static dimensions (head tier, run count, single flag, column pad)
# merge into one widened group: rows re-pad to the group maxima, which
# is exact -- zero-length window columns score nothing, n_run beyond a
# row's run length adds no-op aggregation passes, and a head plane is
# cheap top_k work.  Headless rows joining a head group carry h_len = 0
# (their head plane is all-invalid).  Groups at or above the row
# threshold keep their fine signature: wasted lanes scale with row
# count, dispatch overhead does not.
_COALESCE_MIN_ROWS = 64
_COALESCE_MAX_COLS = 64
# Prefix groups coalesce unconditionally: padded window columns are
# cheap (zero-length windows score nothing) while each extra dispatch
# has a fixed cost.
_COALESCE_MIN_ROWS_PF = 1 << 30
# Column tiers for the merge: "8" buckets small pf groups into a
# narrow (qs <= 8) and a wide dispatch instead of padding every row to
# the batch-max window count (most damped-Zipf rows have 2-4 windows;
# one 16-wide row would force every lane to 16).  Lanes scale with the
# tier width, so the split cuts the merged plane roughly in half for
# one extra dispatch.  Empty NXS_PF_TIERS = single merged group.
_PF_TIERS = tuple(sorted(
    int(x) for x in os.environ.get("NXS_PF_TIERS", "8,64").split(",")
    if x))


def _ladder(v: int, rungs: tuple) -> int:
    """Smallest rung >= v (v itself beyond the top rung): quantizes
    merged-group dimensions onto a fixed ladder so coalesced dispatch
    signatures do not vary with batch composition."""
    for r in rungs:
        if v <= r:
            return r
    return v


def _coalesce_sliced_groups(groups: dict, plans: list) -> dict:
    small = [key for key, members in groups.items()
             if key[0] == "sl" and len(members) < _COALESCE_MIN_ROWS
             and key[9] > 0              # windowed plans only
             and key[1] <= _COALESCE_MAX_COLS]
    if len(small) < 2:
        return groups
    # Bucket by the dimensions that genuinely split signatures:
    # (plane width class is folded; mask/use_rows/head-presence kept
    # -- merging headless rows into a head group would hand EVERY row
    # a T_head plane fetch).
    buckets: dict[tuple, list[tuple]] = {}
    for key in small:
        ck = (key[2], key[4], key[7], key[8] > 0)   # T, mask, rows, head
        buckets.setdefault(ck, []).append(key)
    for ck, keys in buckets.items():
        if len(keys) < 2:
            continue
        T, use_mask, use_rows, _ = ck
        members: list[int] = []
        for key in keys:
            members.extend(groups.pop(key))
        # Quantize the merged shape onto a coarse ladder instead of
        # the member maxima: maxima differ run to run with query
        # content, so max-shaped merges would mint fresh signatures
        # every batch.  A {8, 64, 512}-rung ladder pins the signature
        # while padded
        # lanes stay cheap (zero-length window columns score nothing).
        qs_g = max(len(plans[i].sl_start) for i in members)
        qs_g = _ladder(_qs_pad(qs_g), (8, 64, 512))
        L_g = max(len(plans[i].prog_ops) for i in members) \
            if use_mask else 0
        depth_g = max(plans[i].depth for i in members)
        h_g = max(plans[i].h_T for i in members)
        n_run_g = _ladder(
            max(plans[i].n_run for i in members), (1, 4, 16))
        merged = ("sl", qs_g, T, L_g, use_mask, depth_g, False,
                  use_rows, h_g, n_run_g)
        groups.setdefault(merged, []).extend(members)
        _count("coalesced", len(members))
    return groups


def _coalesce_prefix_groups(groups: dict, plans: list) -> dict:
    """Merge small impact-prefix groups (same T by construction) into
    one widened group: rows re-pad to the group maxima, which is exact
    -- zero-length window columns score nothing, padding wide-term
    rows carry zero tails and empty rescore ranges, and extra n_run
    passes are no-ops.  Same dispatch-overhead argument as
    _coalesce_sliced_groups."""
    small = [key for key, members in groups.items()
             if key[0] in ("pf", "spf")
             and len(members) < _COALESCE_MIN_ROWS_PF
             and key[1] <= _COALESCE_MAX_COLS]
    if not small:
        return groups
    # Tier by (qs bound, has-wide, window width): merging an R = 0
    # group into an R > 0 one would hand the complete-plane rows the
    # full 3-operand sort + rescore epilogue back, and merging across
    # window widths would re-pad narrow rows to a wide plane (undoing
    # the variable-width diet).  Singleton cells still re-key onto the
    # tier bound so dispatch signatures never track the batch's exact
    # column counts.
    tiers: dict[tuple, list[tuple]] = {}
    for key in small:
        for bound in _PF_TIERS:
            if key[1] <= bound:
                break
        else:
            bound = 1 << 30
        tiers.setdefault((key[0], bound, key[3] > 0, key[2]),
                         []).append(key)
    for (kind, _bound, _wide, T), keys in tiers.items():
        members: list[int] = []
        qs_g = run_g = 1
        r_g = 0                # stays 0 for an all-R=0 tier
        for key in keys:
            members.extend(groups.pop(key))
            qs_g = max(qs_g, key[1])
            r_g = max(r_g, key[3])
            run_g = max(run_g, key[4])
        # Ladder-quantize the merged dims (same signature-stability
        # argument as _coalesce_sliced_groups): the wide tier always
        # dispatches at R=4 / the tier's qs bound, the R=0 tier at its
        # qs bound, so every batch reuses the same few signatures.
        if r_g:
            r_g = _PREFIX_MAX_WIDE
        qs_g = _ladder(qs_g, _PF_TIERS)
        run_g = _ladder(run_g, (4, 8))
        merged = (kind, qs_g, T, r_g, run_g)
        groups.setdefault(merged, []).extend(members)
        _count("coalesced_pf", len(members))
    return groups


def submit_query_batch(dev, queries: list[Query],
                       sp: SearchParams,
                       no_prefix: bool = False) -> _PendingBatch:
    """Plan, group and asynchronously dispatch every device call for a
    query batch; pair with collect_query_batch.  Between the two calls
    the chip crunches this batch while the host is free to prepare and
    submit the next one (the pipelined serving path)."""
    from .utils.trace import phase

    with phase("batch.plan"):
        plans: list[Optional[_Plan]] = _build_plans(
            dev, queries, sp, no_prefix=no_prefix)
    return _submit_plans(dev, plans, queries, sp)


# Per-dispatch plane caps (lanes): narrow planes 2**26, wide planes
# (qs > 64) 2**24, and dense-row hybrids bound their [N, S_pad] sweep.
_ELEMS_CAP = 1 << 26
_WIDE_ELEMS_CAP = 1 << 24
_ROWS_ELEMS_CAP = 1 << 26


def _submit_plans(dev, plans: list, queries: list[Query],
                  sp: SearchParams) -> _PendingBatch:
    """Group and dispatch already-built plans (pf and sl routes)."""
    from .ops.executor import pack_sliced_group, sliced_topk_packed

    responses: list[Optional[Response]] = [
        Response() if p is None else None for p in plans]
    k = _bucket(min(sp.limit, dev.n_slots), _MIN_K)
    groups: dict[tuple, list[int]] = {}
    for i, plan in enumerate(plans):
        if plan is None:
            continue
        if plan.pf:
            key = ("pf", len(plan.sl_start), plan.sl_T,
                   len(plan.pf_tail), plan.n_run)
        elif _use_sliced(plan, False, dev):
            # Wide planes (qs > 64) quantize n_run onto a ladder, as in
            # the reference (extra passes are exact no-ops).
            n_run_k = plan.n_run
            if len(plan.sl_start) > 64 and n_run_k > 0:
                n_run_k = _ladder(n_run_k, (4, 16, 128))
            key = ("sl", len(plan.sl_start), plan.sl_T,
                   len(plan.prog_ops) if plan.use_mask else 0,
                   plan.use_mask, plan.depth, plan.single, plan.use_rows,
                   plan.h_T, n_run_k)
        else:
            raise NotImplementedError(_route_error(plan))
        groups.setdefault(key, []).append(i)

    groups = _coalesce_sliced_groups(groups, plans)
    groups = _coalesce_prefix_groups(groups, plans)

    # Chunk groups so one dispatch's plane stays bounded in device
    # memory (same caps as the reference).
    chunked: list[tuple[tuple, list[int]]] = []
    for key, members in groups.items():
        elems = max(key[1] * key[2] + (key[8] if key[0] == "sl" else 0),
                    1)
        cap_l = _WIDE_ELEMS_CAP if key[1] > 64 else _ELEMS_CAP
        max_n = max(1, cap_l // elems)
        if key[0] == "sl" and key[7]:              # use_rows
            max_n = min(max_n, max(1, _ROWS_ELEMS_CAP
                                   // max(dev.n_slots, 1)))
        for at in range(0, len(members), max_n):
            chunked.append((key, members[at: at + max_n]))

    t_dispatch = time.perf_counter()
    pending = []
    for key, members in chunked:
        n = len(members)
        if key[0] == "pf":
            _, qs_pad, T_g, r_pad, n_run_g = key
            n_pad = _row_pad(n, qs_pad, T_g, pf=True)
            sl_start = np.zeros((n_pad, qs_pad), dtype=np.int32)
            sl_len = np.zeros((n_pad, qs_pad), dtype=np.int32)
            sl_idf = np.zeros((n_pad, qs_pad), dtype=np.float32)
            pf_bits = np.zeros((n_pad, qs_pad), dtype=np.int32)
            pf_tail = np.zeros((n_pad, r_pad), dtype=np.float32)
            pf_start = np.zeros((n_pad, r_pad), dtype=np.int32)
            pf_len = np.zeros((n_pad, r_pad), dtype=np.int32)
            pf_idf = np.zeros((n_pad, r_pad), dtype=np.float32)
            for row, i in enumerate(members):
                p = plans[i]
                w = len(p.sl_start)       # coalesced rows re-pad
                r = len(p.pf_tail)
                sl_start[row, :w] = p.sl_start
                sl_len[row, :w] = p.sl_len
                sl_idf[row, :w] = p.sl_idf
                pf_bits[row, :w] = p.pf_bits
                pf_tail[row, :r] = p.pf_tail
                pf_start[row, :r] = p.pf_start
                pf_len[row, :r] = p.pf_len
                pf_idf[row, :r] = p.pf_idf
            packed = _dispatch_prefix(
                dev, sl_start, sl_len, sl_idf, pf_bits, pf_tail, pf_start,
                pf_len, pf_idf, sp=sp, k=k, n_run=n_run_g, T=T_g)
            _count("prefix", n)
            pending.append((members, packed, "prefix"))
            continue
        # Group params come from the KEY: coalesced groups carry
        # widened maxima there, and member rows re-pad below.
        (_, qs_pad, T_g, _L, use_mask_g, _depth, single_g, use_rows_g,
         t_head, n_run_g) = key
        n_pad = _row_pad(n, qs_pad, T_g)
        sl_start = np.zeros((n_pad, qs_pad), dtype=np.int32)
        sl_len = np.zeros((n_pad, qs_pad), dtype=np.int32)
        sl_idf = np.zeros((n_pad, qs_pad), dtype=np.float32)
        if use_rows_g:
            d_row = np.full((n_pad, _MAX_DENSE_PER_QUERY), -1,
                            dtype=np.int32)
            d_idf = np.zeros((n_pad, _MAX_DENSE_PER_QUERY),
                             dtype=np.float32)
        if t_head:
            h_start = np.zeros(n_pad, dtype=np.int32)
            h_len = np.zeros(n_pad, dtype=np.int32)
            h_idf = np.zeros(n_pad, dtype=np.float32)
            h_row = np.zeros(n_pad, dtype=np.int32)
            h_pass = np.zeros(n_pad, dtype=np.bool_)
        for row, i in enumerate(members):
            p = plans[i]
            w = len(p.sl_start)
            sl_start[row, :w] = p.sl_start
            sl_len[row, :w] = p.sl_len
            sl_idf[row, :w] = p.sl_idf
            if use_rows_g and p.d_row is not None:
                d_row[row] = p.d_row
                d_idf[row] = p.d_idf
            if t_head and p.h_T:
                h_start[row] = p.h_start
                h_len[row] = p.h_len
                h_idf[row] = p.h_idf
                h_row[row] = p.h_row
                h_pass[row] = p.h_pass
        buf = pack_sliced_group(
            sl_start, sl_len, sl_idf,
            d_row if use_rows_g else None,
            d_idf if use_rows_g else None,
            h_start if t_head else None, h_len if t_head else None,
            h_idf if t_head else None, h_row if t_head else None,
            h_pass if t_head else None)
        packed = sliced_topk_packed(
            dev.postings_pack, dev.alive_mask, dev.doc_len,
            _upload(dev, buf), dev.adl_dev,
            dev.dense_rows if use_rows_g else None,
            qs=qs_pad, D=_MAX_DENSE_PER_QUERY, T=T_g, k=k, algo=sp.algo,
            n_slots=dev.n_slots, use_mask=use_mask_g, single=single_g,
            alive_all=dev.alive_all, use_rows=use_rows_g,
            T_head=t_head, n_run=n_run_g)
        _count("sliced", n)
        if t_head:
            _count("sliced_head", n)
        pending.append((members, packed, "sliced"))

    fetch = _fetch_start([p[1] for p in pending]) if pending else None
    return _PendingBatch(plans=plans, responses=responses,
                         pending=pending, fetch=fetch,
                         t_dispatch=t_dispatch,
                         t_submitted=time.perf_counter())


def _fetch_start(results: list) -> tuple:
    """Concatenate a batch's packed results on the device and start ONE
    device->host copy, into pinned memory (asynchronous) on CUDA."""
    shapes = [tuple(r.shape) for r in results]
    dims = [int(np.prod(s[1:])) for s in shapes]
    d_max = max(dims)
    flat = torch.cat([torch.nn.functional.pad(
        r.reshape(r.shape[0], -1), (0, d_max - d))
        for r, d in zip(results, dims)])
    if flat.device.type != "cuda":
        return flat, None, shapes
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(flat.device))
    return host, done, shapes


def _fetch_finish(fetch: tuple) -> list[np.ndarray]:
    """Wait for the batch copy; split it back into per-group arrays."""
    host, done, shapes = fetch
    if done is not None:
        done.synchronize()
    arr = host.numpy()
    out = []
    at = 0
    for shape in shapes:
        d = int(np.prod(shape[1:]))
        out.append(arr[at: at + shape[0], :d].reshape(shape))
        at += shape[0]
    return out


def collect_query_batch(dev, st: _PendingBatch,
                        sp: SearchParams) -> list[Response]:
    """Wait for a submitted batch's results and build responses."""
    from .ops.executor import unpack_prefix, unpack_sliced

    t_fetch = time.perf_counter()
    arrays = _fetch_finish(st.fetch) if st.fetch is not None else []
    t_resp = time.perf_counter()
    for (members, _packed, tag), arr in zip(st.pending, arrays):
        n = len(members)
        if tag == "prefix":
            scores, slots, exact = unpack_prefix(arr)
            # R = 0 planes are complete: exact by construction.
            _count("prefix_exact", int(exact[:n].sum()))
        else:
            scores, slots = unpack_sliced(arr)
        _to_responses_group(dev, members, scores[:n], slots[:n],
                            st.plans, sp, st.responses)
    log = _trace_logger()
    if log.isEnabledFor(10):      # logging.DEBUG
        log.debug("batch.exec: %d groups, dispatch %.1f ms, fetch %.1f "
                  "ms, respond %.1f ms", len(st.pending),
                  (st.t_submitted - st.t_dispatch) * 1e3,
                  (t_resp - t_fetch) * 1e3,
                  (time.perf_counter() - t_resp) * 1e3)
    return st.responses


@functools.lru_cache(maxsize=1)
def _trace_logger():
    from .utils.log import get_logger
    return get_logger("trace")


def _to_responses_group(dev, members, scores, slots, plans, sp,
                        responses) -> None:
    """Vectorized _to_response over one result group: one perm/doc-id
    gather for the whole [N, k] block instead of N small-array
    passes.  Falls back to the
    per-row path when a delta must be merged (rare in serving: only
    between a mutation and the next refresh)."""
    scores = np.asarray(scores)
    slots = np.asarray(slots)
    if getattr(dev, "has_delta", False):
        for row, i in enumerate(members):
            responses[i] = _to_response(
                dev, scores[row], slots[row], sp.limit,
                delta=_delta_results(dev, plans[i], sp))
        return
    n, k = scores.shape
    matched = scores > 0.0
    # Unmatched rows may carry padding slot indexes past the host slot
    # count; clamp them to 0 before the gathers (they are dropped).
    safe = np.where(matched, slots, 0).astype(np.int64)
    perm = getattr(dev, "slot_perm", None)
    if perm is not None:
        safe = perm[safe]
    ids = np.asarray(dev.doc_ids)[safe]
    # top_k scores are descending, so the matched mask is a prefix:
    # each row's results are a SLICE, and Response keeps the numpy
    # rows, materializing (doc_id, score) tuples only on demand.
    counts = np.minimum(matched.sum(axis=1), sp.limit).tolist()
    for row, i in enumerate(members):
        c = counts[row]
        responses[i] = Response.from_arrays(ids[row, :c], scores[row, :c])


def search(dev: DeviceIndex, pipeline, query_str: str,
           sp: SearchParams, fuzzy_lookup=None) -> Response:
    """Full search path against an up-to-date device snapshot."""
    root = parse_query(query_str)
    check_nesting(root)
    query = prepare(root, pipeline, dev.host.term_lookup,
                    fuzzy_lookup=fuzzy_lookup, fuzzymatch=sp.fuzzymatch)
    return execute_query(dev, query, sp)


# Fast-path term-count bound: a left-folded OR chain of N leaves puts
# its deepest leaf at recursion depth N-1, so the reference's nesting
# limit of 100 (search.c:66-75) first fires at 102 terms; the value
# list is only taken below that (check_nesting on the built chain
# raises for parity otherwise).
_FAST_MAX_TERMS = QUERY_NESTING_LIMIT + 1


def _prepare_many(dev, pipeline, query_strs: list[str],
                  sp: SearchParams, fuzzy_lookup=None,
                  fuzzy_prefetch=None) -> list[Query]:
    """Host query prep for a batch.

    Work is deduplicated across the *batch*, not per query: each
    unique raw value is filtered once (one native call primes the
    memo), each unique filtered token is resolved against the term
    dictionary once, and all fuzzy misses resolve in one batched
    dispatch.  Plain term queries (the overwhelming serving majority)
    skip AST construction entirely -- their Query carries the resolved
    token list and a ``pure_or`` flag.  Only chains of the pure
    builtin filters take the batched path: plugin filters may be
    stateful, so they keep the reference's per-leaf run order.
    """
    from .query.parser import parse_fast_values
    from .utils.trace import phase

    if getattr(pipeline, "_memo", None) is None:
        # Non-memoizable (stateful plugin) chain: per-query reference
        # flow, one pipeline run per leaf occurrence.
        out = []
        for query_str in query_strs:
            root = parse_query(query_str)
            check_nesting(root)
            out.append(prepare(root, pipeline, dev.host.term_lookup,
                               fuzzy_lookup=(fuzzy_lookup
                                             if sp.fuzzymatch else None),
                               fuzzymatch=sp.fuzzymatch))
        return out

    with phase("prep.parse"):
        fast_vals: list[Optional[list[str]]] = []
        roots: list[Optional[Expr]] = []
        slow_ix: list[int] = []
        for i, query_str in enumerate(query_strs):
            vals = parse_fast_values(query_str)
            if vals is not None and len(vals) <= _FAST_MAX_TERMS:
                fast_vals.append(vals)
                roots.append(None)
            else:
                root = parse_query(query_str)
                check_nesting(root)
                fast_vals.append(None)
                roots.append(root)
                slow_ix.append(i)

    # Unique raw values across the whole batch (insertion-ordered).
    uniq: dict[str, None] = {}
    for vals in fast_vals:
        if vals:
            for v in vals:
                uniq[v] = None
    for i in slow_ix:
        for leaf in roots[i].walk_leaves():
            uniq[leaf.value] = None

    prime = getattr(pipeline, "prime", None)
    if prime is not None:
        # One native call filters the batch's unique values into the
        # pipeline memo; run() below is then a small-dict hit.
        with phase("prep.prime"):
            prime(list(uniq))

    with phase("prep.resolve"):
        run = pipeline.run
        fmap = {v: run(v) for v in uniq}         # raw -> filtered|None
        lookup = dev.host.term_lookup
        tid_map: dict[str, Optional[int]] = {}   # filtered -> term id
        missing: list[str] = []
        for f in fmap.values():
            if f is None or f in tid_map:
                continue
            t = lookup(f)
            tid_map[f] = t
            if t is None:
                missing.append(f)

    if missing and sp.fuzzymatch and fuzzy_lookup is not None:
        # One batched fuzzy dispatch for every miss, then per-value
        # cache hits.
        with phase("prep.fuzzy"):
            if fuzzy_prefetch is not None:
                fuzzy_prefetch(sorted(missing))
            for f in missing:
                tid_map[f] = fuzzy_lookup(f)

    with phase("prep.prepare"):
        out = []
        tid_get = tid_map.get
        for i, query_str in enumerate(query_strs):
            vals = fast_vals[i]
            if vals is None:
                # Boolean/quoted query: reference prepare() over the
                # AST; term resolution (incl. fuzzy) comes from the
                # batch maps, so no big-dict or device work remains.
                out.append(prepare(roots[i], pipeline, tid_get,
                                   fuzzy_lookup=None,
                                   fuzzymatch=sp.fuzzymatch))
                continue
            q = Query(root=_PURE_OR_ROOT, pure_or=True)
            tset = q.tokens
            tmap = tset._map
            tlist = tset.tokens
            for v in vals:
                f = fmap[v]
                if f is None:
                    continue            # filter discarded (stopword)
                tok = tmap.get(f)
                if tok is not None:
                    tok.count += 1
                    tset.seen += 1
                    continue
                tid = tid_get(f)
                if tid is None:
                    continue            # TRIM: no matching term
                tok = Token(value=f, count=1, term_id=tid)
                tmap[f] = tok
                tlist.append(tok)
                tset.seen += 1
                tset.data_len += len(f.encode("utf-8"))
            out.append(q)
        return out


def search_many(dev, pipeline, query_strs: list[str],
                sp: SearchParams, fuzzy_lookup=None,
                fuzzy_prefetch=None) -> list[Response]:
    """Batched search path: one device dispatch per signature group."""
    prepared = _prepare_many(dev, pipeline, query_strs, sp,
                             fuzzy_lookup, fuzzy_prefetch)
    return execute_query_batch(dev, prepared, sp)


def search_many_pipelined(dev, pipeline, batches: list[list[str]],
                          sp: SearchParams, fuzzy_lookup=None,
                          fuzzy_prefetch=None) -> list[list[Response]]:
    """Streaming serving path: overlap host work with device work.

    Batch i is prepared, planned and enqueued while the device still
    runs batch i-1 (only the result copy blocks), so steady-state
    throughput approaches max(host time, device time) per batch
    instead of their sum.  Results are identical to per-batch
    search_many.
    """
    from .utils.trace import phase

    out: list[Optional[list[Response]]] = [None] * len(batches)
    prev_st = None
    prev_i = -1
    for i, query_strs in enumerate(batches):
        with phase("pipeline.prepare"):
            prepared = _prepare_many(dev, pipeline, query_strs, sp,
                                     fuzzy_lookup, fuzzy_prefetch)
        with phase("pipeline.submit"):
            st = submit_query_batch(dev, prepared, sp)
        if prev_st is not None:
            with phase("pipeline.collect"):
                out[prev_i] = collect_query_batch(dev, prev_st, sp)
        prev_st, prev_i = st, i
    if prev_st is not None:
        with phase("pipeline.collect"):
            out[prev_i] = collect_query_batch(dev, prev_st, sp)
    return out  # type: ignore[return-value]
