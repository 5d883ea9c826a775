"""Host-authoritative index: terms journal + document-term journal.

This is the TPU-native re-design of the reference's index engine
(src/index/terms.c, dtmap.c, idxterm.c, idxdoc.c).  Instead of
pointer-chased in-memory objects over mmap'd blocks, the index is a set
of *columnar arrays*:

- a term dictionary (value -> 1-based sequential ID, append order),
- per-document posting blocks stored columnar (term_id, count,
  owning doc slot) in arrival order -- the journal's dtmap mirrored
  into flat numpy arrays,
- a document table (doc_id, doc_len, liveness, journal offset),
- per-term aggregates (document frequency, total occurrences).

Durability follows the reference protocol exactly: append-only journal
files whose header ``data_len`` is the commit pointer (storage.py), EX
flock for writers with re-sync of other writers' tails before
appending (terms.c:184-198, dtmap.c:274-293), terms always synced
before dtmap (dtmap.c:18-26), and the dual tombstone for removals:
zero the doc_id in place for fresh readers *and* append a marker for
live readers (dtmap.c:29-38).

The device-facing CSR snapshot (postings grouped by term) is produced
by :meth:`HostIndex.build_csr` -- a vectorized transpose of the
arrival-ordered postings.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..errors import ErrorCode, NxsError
from ..text.tokenizer import TokenSet
from .storage import MAGIC_DTMAP, MAGIC_TERMS, LogFile

# Limits (reference: terms.c:226-235, index.h).
MAX_TERM_LEN = 0xFFFF           # UINT16_MAX bytes
MAX_TERM_ID = 0xFFFFFFFF        # UINT32_MAX

_TERM_REC = struct.Struct("<I")          # len | bytes | pad4
_DT_HDR = struct.Struct("<QII")          # doc_id, doc_len, n
_DT_PAIR = struct.Struct("<II")          # term_id, count
_TOMBSTONE = struct.Struct("<QQ")        # doc_id, 0


def _pad4(n: int) -> int:
    return (n + 3) & ~3


class _Grow:
    """Geometrically-grown 1-D numpy array with an explicit length."""

    def __init__(self, dtype, cap: int = 1024):
        self.a = np.zeros(cap, dtype=dtype)
        self.n = 0

    def reserve(self, extra: int) -> None:
        need = self.n + extra
        if need > len(self.a):
            cap = max(need, len(self.a) * 2)
            new = np.zeros(cap, dtype=self.a.dtype)
            new[: self.n] = self.a[: self.n]
            self.a = new

    def push(self, value) -> None:
        self.reserve(1)
        self.a[self.n] = value
        self.n += 1

    def extend(self, values) -> None:
        k = len(values)
        self.reserve(k)
        self.a[self.n: self.n + k] = values
        self.n += k

    def view(self) -> np.ndarray:
        return self.a[: self.n]


@dataclass
class _PartialStop(Exception):
    """Raised when a dtmap block references a not-yet-visible term."""
    offset: int


class HostIndex:
    """One open index over its journal files (nxs_index_t analogue)."""

    SNAPSHOT_VERSION = 2

    def __init__(self, idxdir: str, durable_sync: bool = False,
                 use_snapshot: bool = True):
        self.idxdir = idxdir
        os.makedirs(idxdir, exist_ok=True)
        self.terms_log = LogFile(os.path.join(idxdir, "terms.db"),
                                 MAGIC_TERMS, sync=durable_sync)
        try:
            self.dtmap_log = LogFile(os.path.join(idxdir, "dtmap.db"),
                                     MAGIC_DTMAP, sync=durable_sync)
        except Exception:
            self.terms_log.close()
            raise

        # --- term dictionary -------------------------------------------
        self.term_values: list[str] = []        # id-1 -> value
        self.term_map: dict[str, int] = {}      # value -> id
        self.term_total = _Grow(np.int64)       # live total occurrences
        self.term_df = _Grow(np.int64)          # live document frequency

        # --- postings (arrival order, per-doc contiguous) ----------------
        self.p_term = _Grow(np.int32, 4096)     # 1-based term ids
        self.p_count = _Grow(np.int32, 4096)
        self.p_slot = _Grow(np.int32, 4096)     # owning doc slot

        # --- document table ----------------------------------------------
        self.doc_ids = _Grow(np.int64)
        self.doc_len = _Grow(np.int32)
        self.doc_start = _Grow(np.int64)        # slice into postings
        self.doc_n = _Grow(np.int32)
        self.doc_alive = _Grow(np.bool_)
        self.doc_off = _Grow(np.int64)          # journal payload offset
        self._doc_map: Optional[dict[int, int]] = {}  # doc_id -> slot

        self.doc_count = 0                      # live docs
        self.token_count = 0                    # live tokens (incl. dups)

        self._terms_consumed = 0
        self._dt_consumed = 0
        self.generation = 0                     # bumped on any change
        self._snapshot_gen = -1                 # generation last saved

        if use_snapshot:
            self._load_snapshot()
        self.sync()

    @property
    def doc_map(self) -> dict:
        """live doc_id -> slot map, built lazily after a snapshot
        open: read-only serving never pays the (multi-second at 8.8M
        docs) dict construction; the first mutation or doc lookup
        does."""
        if self._doc_map is None:
            alive = self.doc_alive.view()
            ids = self.doc_ids.view()
            slots = np.arange(len(ids))
            self._doc_map = dict(zip(ids[alive].tolist(),
                                     slots[alive].tolist()))
        return self._doc_map

    # ------------------------------------------------------------------
    # Terms journal
    # ------------------------------------------------------------------

    def _register_term(self, value: str) -> int:
        term_id = len(self.term_values) + 1
        self.term_values.append(value)
        self.term_map[value] = term_id
        self.term_total.push(0)
        self.term_df.push(0)
        return term_id

    def _consume_terms(self, committed: int) -> None:
        """Parse the terms tail [consumed, committed)."""
        if committed <= self._terms_consumed:
            return
        raw = self.terms_log.read_payload(self._terms_consumed, committed)
        off, end = 0, len(raw)
        while off + 4 <= end:
            (length,) = _TERM_REC.unpack_from(raw, off)
            value = raw[off + 4: off + 4 + length].decode("utf-8")
            off += 4 + _pad4(length)
            self._register_term(value)
        self._terms_consumed = committed
        self.generation += 1

    def terms_sync(self) -> None:
        """Consume terms appended by other writers (idx_terms_sync)."""
        with self.terms_log.lock_sh():
            committed = self.terms_log.committed_len()
            self._consume_terms(committed)

    def terms_add(self, tokens: TokenSet) -> None:
        """Append staged tokens as new terms (idx_terms_add).

        Under the EX lock: re-sync other writers' terms, dedupe the
        staged tokens against the refreshed dictionary, then append the
        remaining new terms with sequential IDs and publish.
        """
        if not tokens.staging:
            return
        with self.terms_log.lock_ex():
            committed = self.terms_log.committed_len()
            self._consume_terms(committed)

            buf = bytearray()
            for token in list(tokens.staging):
                term_id = self.term_map.get(token.value)
                if term_id is None:
                    encoded = token.value.encode("utf-8")
                    if len(encoded) > MAX_TERM_LEN:
                        raise NxsError(ErrorCode.LIMIT,
                                       f"term too long ({len(encoded)})")
                    if len(self.term_values) >= MAX_TERM_ID:
                        raise NxsError(
                            ErrorCode.LIMIT,
                            f"reached the term limit ({MAX_TERM_ID})")
                    term_id = self._register_term(token.value)
                    buf += _TERM_REC.pack(len(encoded))
                    buf += encoded
                    buf += b"\x00" * (_pad4(len(encoded)) - len(encoded))
                token.term_id = term_id
                tokens.moveback(token)

            if buf:
                committed = self.terms_log.append(bytes(buf), committed)
                self._terms_consumed = committed
                self.generation += 1

    # ------------------------------------------------------------------
    # Document-term journal
    # ------------------------------------------------------------------

    def _apply_block(self, doc_id: int, doc_len: int,
                     pairs: np.ndarray, offset: int) -> None:
        """Apply a live document block to the in-memory arrays."""
        slot = self.doc_ids.n
        n = len(pairs)
        term_ids = pairs[:, 0]
        counts = pairs[:, 1]

        self.p_term.extend(term_ids.astype(np.int32))
        self.p_count.extend(counts.astype(np.int32))
        self.p_slot.extend(np.full(n, slot, dtype=np.int32))

        self.doc_ids.push(doc_id)
        self.doc_len.push(doc_len)
        self.doc_start.push(self.p_term.n - n)
        self.doc_n.push(n)
        self.doc_alive.push(True)
        self.doc_off.push(offset)
        self.doc_map[doc_id] = slot

        idx = term_ids - 1
        self.term_total.a[idx] += counts
        self.term_df.a[idx] += 1
        self.doc_count += 1
        self.token_count += doc_len

    def _apply_remove(self, doc_id: int) -> None:
        slot = self.doc_map.get(doc_id)
        if slot is None or not self.doc_alive.a[slot]:
            return
        start = int(self.doc_start.a[slot])
        n = int(self.doc_n.a[slot])
        idx = self.p_term.a[start: start + n] - 1
        counts = self.p_count.a[start: start + n]
        self.term_total.a[idx] -= counts
        self.term_df.a[idx] -= 1
        self.doc_alive.a[slot] = False
        self.doc_count -= 1
        self.token_count -= int(self.doc_len.a[slot])
        del self.doc_map[doc_id]

    def _consume_dtmap(self, committed: int) -> None:
        """Parse and apply the dtmap tail [consumed, committed).

        Vectorized: one Python pass over the block *headers*, then the
        pair data of every live block lands in bulk numpy applies (the
        per-document loop was the scaling wall for journal replay and
        for writers re-syncing each other under the lock).  Removal
        tombstones are applied in stream order between bulk runs;
        blocks referencing not-yet-visible terms defer to the next
        sync (DTMAP_PARTIAL_SYNC semantics).
        """
        if committed <= self._dt_consumed:
            return
        raw = self.dtmap_log.read_payload(self._dt_consumed, committed)
        base = self._dt_consumed
        end = len(raw)
        nterms = len(self.term_values)

        # Pass 1: header walk.
        hdr = _DT_HDR.unpack_from
        offs: list[int] = []
        ids: list[int] = []
        lens: list[int] = []
        ns: list[int] = []
        off = 0
        while off + _DT_HDR.size <= end:
            doc_id, doc_len, n = hdr(raw, off)
            offs.append(off)
            ids.append(doc_id)
            lens.append(doc_len)
            ns.append(n)
            off += (_TOMBSTONE.size if doc_len == 0 and n == 0
                    else _DT_HDR.size + 8 * n)
        n_blocks = len(offs)
        if not n_blocks:
            self._dt_consumed = base + off
            return

        offs_a = np.asarray(offs, dtype=np.int64)
        ids_a = np.asarray(ids, dtype=np.int64)
        lens_a = np.asarray(lens, dtype=np.int64)
        ns_a = np.asarray(ns, dtype=np.int64)
        is_tomb = (lens_a == 0) & (ns_a == 0)
        is_live = ~is_tomb & (ids_a != 0)   # doc_id==0: zeroed, skip

        # Flat (term, count) arrays over every live block's pairs: one
        # boolean compress dropping header words (and the rare zeroed
        # blocks' pairs) beats per-pair index arithmetic.
        u4 = np.frombuffer(raw, dtype="<u4", count=off // 4)
        ln = np.where(is_live, ns_a, 0)
        total = int(ln.sum())
        seg = np.cumsum(ln) - ln             # flat start per block
        if total:
            keep = np.ones(off // 4, dtype=np.bool_)
            w0 = offs_a // 4
            keep[(w0[:, None] + np.arange(4)).ravel()] = False
            dead = np.nonzero(~is_live & ~is_tomb & (ns_a > 0))[0]
            for b in dead:                   # zeroed blocks: rare
                s = int(w0[b]) + 4
                keep[s: s + 2 * int(ns_a[b])] = False
            tc = u4[keep]
            tids = tc[0::2].astype(np.int64)
            counts = tc[1::2].astype(np.int64)
            # Per-block max term id (empty segments masked to 0).
            starts = np.minimum(seg, max(total - 1, 0))
            blk_max = np.maximum.reduceat(tids, starts)
            blk_max = np.where(ln > 0, blk_max, 0)
        else:
            tids = counts = np.zeros(0, dtype=np.int64)
            blk_max = np.zeros(n_blocks, dtype=np.int64)

        # Partial stop: the first live block with unseen terms caps
        # processing; everything before it applies this sync.
        stop_block = n_blocks
        bad = np.nonzero(blk_max > nterms)[0]
        if len(bad):
            stop_block = int(bad[0])
            self._dt_consumed = base + int(offs_a[stop_block])
        else:
            self._dt_consumed = base + off

        changed = False

        def bulk_add(b0: int, b1: int) -> None:
            """Apply live blocks in [b0, b1) in one vectorized pass.

            Non-live blocks contribute zero flat length, so the
            range's pairs are one contiguous slice of tids/counts --
            no gather needed.
            """
            nonlocal changed
            sel = np.nonzero(is_live[b0:b1])[0] + b0
            if not len(sel):
                return
            sn = ns_a[sel]
            f0 = int(seg[b0])
            f1 = int(seg[b1 - 1] + ln[b1 - 1])
            t = tids[f0:f1]
            c = counts[f0:f1]
            slot0 = self.doc_ids.n
            p0 = self.p_term.n
            self.p_term.extend(t.astype(np.int32))
            self.p_count.extend(c.astype(np.int32))
            self.p_slot.extend((np.repeat(np.arange(len(sel)), sn)
                                + slot0).astype(np.int32))
            self.doc_ids.extend(ids_a[sel])
            self.doc_len.extend(lens_a[sel].astype(np.int32))
            self.doc_start.extend((np.cumsum(sn) - sn) + p0)
            self.doc_n.extend(sn.astype(np.int32))
            self.doc_alive.extend(np.ones(len(sel), dtype=np.bool_))
            self.doc_off.extend(base + offs_a[sel])
            self.doc_map.update(
                zip(ids_a[sel].tolist(),
                    range(slot0, slot0 + len(sel))))
            # bincount beats np.add.at ~30x (buffered histogram vs
            # unbuffered per-element ufunc.at).
            nt = len(self.term_values)
            self.term_total.a[:nt] += np.bincount(
                t - 1, weights=c, minlength=nt).astype(np.int64)
            self.term_df.a[:nt] += np.bincount(
                t - 1, minlength=nt).astype(np.int64)
            self.doc_count += len(sel)
            self.token_count += int(lens_a[sel].sum())
            changed = True

        # Pass 2: apply in stream order, batching runs between
        # tombstones (removal must see prior adds of the same tail).
        run_start = 0
        for tb in np.nonzero(is_tomb[:stop_block])[0]:
            tb = int(tb)
            bulk_add(run_start, tb)
            self._apply_remove(int(ids_a[tb]))
            changed = True
            run_start = tb + 1
        bulk_add(run_start, stop_block)
        if changed:
            self.generation += 1

    def dtmap_sync(self, partial: bool = True) -> None:
        """Consume the dtmap tail (idx_dtmap_sync).

        Terms are synced first; if the dtmap tail still references terms
        committed after our terms read, terms are re-synced once, and
        any remaining unseen-term block is deferred to the next sync.
        """
        self.terms_sync()
        with self.dtmap_log.lock_sh():
            committed = self.dtmap_log.committed_len()
            before = self._dt_consumed
            self._consume_dtmap(committed)
            if self._dt_consumed < committed and self._dt_consumed >= before:
                # Hit a block with unseen terms: re-sync terms, retry.
                self.terms_sync()
                self._consume_dtmap(committed)
                if self._dt_consumed < committed and not partial:
                    raise NxsError(ErrorCode.FATAL,
                                   "dtmap references unknown terms")

    def sync(self) -> None:
        """Full sync: terms then dtmap (search-path ordering)."""
        self.dtmap_sync(partial=True)

    def has_pending(self) -> bool:
        """Cheap probe: unconsumed journal bytes exist (other writers
        published past our marks).  Reads only the published commit
        pointers; used by the search fast path to stay on the shared
        lock when nothing changed."""
        return (self.terms_log.committed_len() > self._terms_consumed
                or self.dtmap_log.committed_len() > self._dt_consumed)

    def dtmap_add(self, doc_id: int, tokens: TokenSet) -> None:
        """Append a document block (idx_dtmap_add).

        The block is built off-line (sorted by term_id), then under the
        EX dtmap lock: terms and dtmap are re-synced, the duplicate-doc
        check re-run, the block appended and published.
        """
        assert not tokens.staging, "tokens must be fully resolved"
        pairs = sorted((t.term_id, t.count) for t in tokens.tokens)
        buf = bytearray(_DT_HDR.pack(doc_id, tokens.seen, len(pairs)))
        for term_id, count in pairs:
            buf += _DT_PAIR.pack(term_id, count)

        with self.dtmap_log.lock_ex():
            self.terms_sync()
            committed = self.dtmap_log.committed_len()
            self._consume_dtmap(committed)
            if self._dt_consumed != committed:  # cannot happen under EX
                raise NxsError(ErrorCode.FATAL,
                               "dtmap references unknown terms")
            if doc_id in self.doc_map:
                raise NxsError(ErrorCode.EXISTS,
                               f"document {doc_id} is already indexed")
            offset = committed
            committed = self.dtmap_log.append(bytes(buf), committed)
            self._apply_block(
                doc_id, tokens.seen,
                np.asarray(pairs, dtype=np.int64).reshape(len(pairs), 2),
                offset)
            self._dt_consumed = committed
            self.generation += 1

    def add_bulk(self, items) -> None:
        """Batched document add: one lock round-trip per journal.

        ``items`` is a list of (doc_id, TokenSet) with *unresolved*
        tokens.  Semantics match per-document add (same journal record
        format, same dedupe/limits), but the flock acquisition, the
        re-sync and the append syscall are amortized over the batch;
        the batch is atomic -- a duplicate doc anywhere aborts it
        before anything is published.
        """
        # Phase 1: terms (same ordering discipline as terms_add).
        with self.terms_log.lock_ex():
            committed = self.terms_log.committed_len()
            self._consume_terms(committed)
            buf = bytearray()
            term_map = self.term_map
            for _, ts in items:
                for token in ts.tokens:
                    term_id = term_map.get(token.value)
                    if term_id is None:
                        encoded = token.value.encode("utf-8")
                        if len(encoded) > MAX_TERM_LEN:
                            raise NxsError(
                                ErrorCode.LIMIT,
                                f"term too long ({len(encoded)})")
                        if len(self.term_values) >= MAX_TERM_ID:
                            raise NxsError(
                                ErrorCode.LIMIT,
                                f"reached the term limit ({MAX_TERM_ID})")
                        term_id = self._register_term(token.value)
                        buf += _TERM_REC.pack(len(encoded))
                        buf += encoded
                        buf += b"\x00" * (_pad4(len(encoded)) - len(encoded))
                    token.term_id = term_id
            if buf:
                committed = self.terms_log.append(bytes(buf), committed)
                self._terms_consumed = committed
                self.generation += 1

        # Phase 2: dtmap blocks, one append for the whole batch.
        with self.dtmap_log.lock_ex():
            self.terms_sync()
            committed = self.dtmap_log.committed_len()
            self._consume_dtmap(committed)
            batch_ids = set()
            for doc_id, _ in items:
                if doc_id in self.doc_map or doc_id in batch_ids:
                    raise NxsError(
                        ErrorCode.EXISTS,
                        f"document {doc_id} is already indexed")
                batch_ids.add(doc_id)
            buf = bytearray()
            staged = []
            for doc_id, ts in items:
                pairs = np.array(
                    sorted((t.term_id, t.count) for t in ts.tokens),
                    dtype="<u4").reshape(-1, 2)
                staged.append((doc_id, ts.seen, pairs,
                               committed + len(buf)))
                buf += _DT_HDR.pack(doc_id, ts.seen, len(pairs))
                buf += pairs.tobytes()
            committed = self.dtmap_log.append(bytes(buf), committed)
            for doc_id, seen, pairs, offset in staged:
                self._apply_block(doc_id, seen,
                                  pairs.astype(np.int64), offset)
            self._dt_consumed = committed
            self.generation += 1

    def add_bulk_arrays(self, doc_ids_arr: np.ndarray,
                        table_values: list[str],
                        pairs: np.ndarray,      # uint32[n, 2] (tix, count)
                        doc_ptr: np.ndarray,    # int64[n_docs + 1]
                        seen: np.ndarray) -> None:
        """Vectorized batched add: token data arrives as numpy arrays
        keyed by a batch-level string table (the native tokenizer's
        output) -- no per-token Python objects anywhere.

        Semantics identical to add_bulk: atomic batch, same journal
        record bytes, same limits and duplicate checks.
        """
        n_docs = len(doc_ids_arr)

        # Phase 1: resolve the batch string table to term IDs under the
        # terms lock (registering + journaling new terms).  Bulk
        # registration: one pass finds the new values, then the term
        # dictionary, journal records, and count columns are extended
        # in batch (the per-term _register_term loop was the ingest
        # profile's #2 cost after tokenization).
        with self.terms_log.lock_ex():
            committed = self.terms_log.committed_len()
            self._consume_terms(committed)
            term_map = self.term_map
            new_values = [v for v in table_values if v not in term_map]
            if new_values:
                encoded = [v.encode("utf-8") for v in new_values]
                if max(len(e) for e in encoded) > MAX_TERM_LEN:
                    n = max(len(e) for e in encoded)
                    raise NxsError(ErrorCode.LIMIT,
                                   f"term too long ({n})")
                if len(self.term_values) + len(new_values) > MAX_TERM_ID:
                    raise NxsError(
                        ErrorCode.LIMIT,
                        f"reached the term limit ({MAX_TERM_ID})")
                first_id = len(self.term_values) + 1
                term_map.update(
                    zip(new_values,
                        range(first_id, first_id + len(new_values))))
                self.term_values.extend(new_values)
                self.term_total.extend(
                    np.zeros(len(new_values), dtype=np.int64))
                self.term_df.extend(
                    np.zeros(len(new_values), dtype=np.int64))
                parts = []
                for e in encoded:
                    parts.append(_TERM_REC.pack(len(e)))
                    parts.append(e)
                    parts.append(b"\x00" * (_pad4(len(e)) - len(e)))
                committed = self.terms_log.append(b"".join(parts),
                                                  committed)
                self._terms_consumed = committed
                self.generation += 1
            tid_of_tix = np.fromiter(
                (term_map[v] for v in table_values),
                dtype=np.int64, count=len(table_values))

        # Vectorized: map table indexes to term IDs, sort each doc's
        # pairs by term ID (one global lexsort).
        tids = tid_of_tix[pairs[:, 0].astype(np.int64)]
        counts = pairs[:, 1].astype(np.int64)
        doc_n = np.diff(doc_ptr)
        doc_of_pair = np.repeat(np.arange(n_docs, dtype=np.int64), doc_n)
        # (doc, term) pairs are unique within a doc, so one unstable
        # composite-key argsort replaces lexsort's two mergesort
        # passes (same win as build_csr; ingest-dominant at scale).
        span = np.int64(len(self.term_values) + 1)
        if n_docs * int(span) < (1 << 62):
            order = np.argsort(doc_of_pair * span + tids)
        else:  # pragma: no cover - >4e18 key space
            order = np.lexsort((tids, doc_of_pair))
        tids = tids[order]
        counts = counts[order]
        blocks = np.column_stack([tids, counts]).astype("<u4")

        # Phase 2: one dtmap append for the batch.
        with self.dtmap_log.lock_ex():
            self.terms_sync()
            committed = self.dtmap_log.committed_len()
            self._consume_dtmap(committed)
            ids_list = doc_ids_arr.tolist()
            batch_ids = set(ids_list)
            if len(batch_ids) != n_docs:
                dups = set()
                doc_id = next(i for i in ids_list
                              if i in dups or dups.add(i))
                raise NxsError(
                    ErrorCode.EXISTS,
                    f"document {doc_id} is already indexed")
            existing = batch_ids & self.doc_map.keys()
            if existing:
                raise NxsError(
                    ErrorCode.EXISTS,
                    f"document {next(iter(existing))} is already indexed")

            # Serialize every dtmap block in one vectorized pass: the
            # record layout ({u64 doc_id, u32 doc_len, u32 n, n x
            # (u32, u32)}) is u64-aligned, so headers and pairs
            # scatter into one u64 plane (per-doc Python packing was
            # the ingest profile's #3 cost).
            off_u64 = np.zeros(n_docs + 1, dtype=np.int64)
            off_u64[1:] = np.cumsum(2 + doc_n)      # u64 words per block
            out_u64 = np.empty(int(off_u64[-1]), dtype="<u8")
            out_u64[off_u64[:-1]] = doc_ids_arr.astype(np.uint64)
            out_u64[off_u64[:-1] + 1] = (
                seen.astype(np.uint64)
                | (doc_n.astype(np.uint64) << np.uint64(32)))
            n_pairs = len(blocks)
            dst = (np.arange(n_pairs, dtype=np.int64)
                   + np.repeat(off_u64[:-1] + 2 - doc_ptr[:-1], doc_n))
            out_u64[dst] = blocks.reshape(-1).view("<u8")
            offsets = committed + off_u64[:-1] * 8
            committed = self.dtmap_log.append(out_u64.tobytes(),
                                              committed)

            # Bulk in-memory apply (vectorized _apply_block).
            slot0 = self.doc_ids.n
            p0 = self.p_term.n
            self.p_term.extend(tids.astype(np.int32))
            self.p_count.extend(counts.astype(np.int32))
            self.p_slot.extend((doc_of_pair + slot0).astype(np.int32))
            self.doc_ids.extend(doc_ids_arr.astype(np.int64))
            self.doc_len.extend(seen.astype(np.int32))
            self.doc_start.extend(doc_ptr[:-1] + p0)
            self.doc_n.extend(doc_n.astype(np.int32))
            self.doc_alive.extend(np.ones(n_docs, dtype=np.bool_))
            self.doc_off.extend(offsets)
            for i, doc_id in enumerate(doc_ids_arr):
                self.doc_map[int(doc_id)] = slot0 + i
            nt = len(self.term_values)
            self.term_total.a[:nt] += np.bincount(
                tids - 1, weights=counts, minlength=nt).astype(np.int64)
            self.term_df.a[:nt] += np.bincount(
                tids - 1, minlength=nt).astype(np.int64)
            self.doc_count += n_docs
            self.token_count += int(seen.sum())
            self._dt_consumed = committed
            self.generation += 1

    def dtmap_remove(self, doc_id: int) -> None:
        """Tombstone removal (idx_dtmap_remove, dual protocol)."""
        with self.dtmap_log.lock_ex():
            self.terms_sync()
            committed = self.dtmap_log.committed_len()
            self._consume_dtmap(committed)
            slot = self.doc_map.get(doc_id)
            if slot is None or not self.doc_alive.a[slot]:
                raise NxsError(ErrorCode.MISSING,
                               f"document {doc_id} not found")
            # 1) zero the original block's doc_id for fresh readers;
            self.dtmap_log.patch(int(self.doc_off.a[slot]),
                                 struct.pack("<Q", 0))
            # 2) append the marker for live readers and publish.
            committed = self.dtmap_log.append(
                _TOMBSTONE.pack(doc_id, 0), committed)
            self._apply_remove(doc_id)
            self._dt_consumed = committed
            self.generation += 1

    # ------------------------------------------------------------------
    # Lookups / aggregates
    # ------------------------------------------------------------------

    def term_lookup(self, value: str) -> Optional[int]:
        return self.term_map.get(value)

    def doc_lookup(self, doc_id: int) -> Optional[int]:
        return self.doc_map.get(doc_id)

    @property
    def term_count(self) -> int:
        return len(self.term_values)

    def get_doc_termcount(self, doc_id: int, term_id: int) -> int:
        """idxdoc_get_termcount: per-document term occurrence count."""
        slot = self.doc_map.get(doc_id)
        if slot is None:
            return 0
        start = int(self.doc_start.a[slot])
        n = int(self.doc_n.a[slot])
        terms = self.p_term.a[start: start + n]
        i = int(np.searchsorted(terms, term_id))
        if i < n and terms[i] == term_id:
            return int(self.p_count.a[start + i])
        return 0

    def get_doc_len(self, doc_id: int) -> int:
        slot = self.doc_map.get(doc_id)
        return int(self.doc_len.a[slot]) if slot is not None else 0

    def term_docs(self, term_id: int) -> np.ndarray:
        """Sorted live doc slots containing the term (doc_bitmap analogue)."""
        mask = self.p_term.view() == term_id
        slots = self.p_slot.view()[mask]
        slots = slots[self.doc_alive.view()[slots]]
        return np.unique(slots)

    # ------------------------------------------------------------------
    # Device snapshot
    # ------------------------------------------------------------------

    def build_csr(self, slot_remap=None):
        """Transpose arrival-ordered postings into term-grouped CSR.

        ``slot_remap`` (optional int64[S]) renumbers doc slots before
        grouping -- the device layer passes its dl-ordered slot
        permutation so the postings come out directly in device order,
        fusing what used to be two full sorts of every posting (the
        dominant cost of large-index opens on one core) into one.

        Returns a dict of numpy arrays:
          term_starts  int32[T+1]  CSR row pointers (0-based term index)
          postings_slot int32[P]   doc slots, grouped by term
                                   (remapped when slot_remap is given)
          postings_tf  float32[P]  occurrence counts
          doc_len      float32[S]  per-slot token counts (incl. dups)
          doc_ids      int64[S]    slot -> external doc id
          doc_alive    bool[S]
          term_df      int64[T], term_total int64[T]
          doc_count, token_count   (live scalars)
        """
        nterms = len(self.term_values)
        p_term = self.p_term.view()
        alive = self.doc_alive.view()
        live_mask = alive[self.p_slot.view()]
        t = (p_term[live_mask] - 1).astype(np.int64)
        slots = self.p_slot.view()[live_mask]
        if slot_remap is not None:
            slots = slot_remap[slots]
        tf = self.p_count.view()[live_mask]

        # Group by term AND sort by slot within each term: slot-sorted
        # posting lists let the device executor merge query terms'
        # postings into slot runs (candidate scoring) cheaply.
        # (term, slot) pairs are unique, so an unstable single-pass
        # argsort over the composite key replaces the two stable
        # mergesort passes of np.lexsort (~3x faster at 500M postings);
        # lexsort remains the fallback if the key could overflow.
        span = np.int64(max(self.doc_ids.n, 1))
        if nterms * int(span) < (1 << 62):
            order = np.argsort(t * span + slots)
        else:  # pragma: no cover - >4e18 key space
            order = np.lexsort((slots, t))
        counts = np.bincount(t, minlength=nterms)
        term_starts = np.zeros(nterms + 1, dtype=np.int64)
        np.cumsum(counts, out=term_starts[1:])

        return {
            "term_starts": term_starts,
            "postings_slot": slots[order].astype(np.int32),
            "postings_tf": tf[order].astype(np.float32),
            "doc_len": self.doc_len.view().astype(np.float32),
            "doc_ids": self.doc_ids.view().astype(np.int64),
            "doc_alive": alive.copy(),
            "term_df": self.term_df.view().copy(),
            "term_total": self.term_total.view().copy(),
            "doc_count": self.doc_count,
            "token_count": self.token_count,
            "generation": self.generation,
        }

    # ------------------------------------------------------------------
    # Fast-open snapshot cache
    # ------------------------------------------------------------------
    # The journals remain the single source of truth (the reference's
    # "the index IS the checkpoint" stance, SURVEY §5); the snapshot is
    # a derived-state cache so opening a large index replays only the
    # journal tail instead of the full history.  Written atomically;
    # a stale or missing snapshot just means more tail to replay, and
    # destroying the index removes it with the directory.

    @property
    def _snapshot_path(self) -> str:
        return os.path.join(self.idxdir, "snapshot.npz")

    def _postings_path(self, name: str) -> str:
        return os.path.join(self.idxdir, f"snapshot_{name}.npy")

    # Sidecar arrays: (name, dtype, length-group).  Lengths within a
    # group must agree; the loader verifies them against the meta.
    _SIDECARS = (
        ("p_term", np.int32, "n_postings"),
        ("p_count", np.int32, "n_postings"),
        ("p_slot", np.int32, "n_postings"),
        ("doc_ids", np.int64, "n_slots"),
        ("doc_len", np.int32, "n_slots"),
        ("doc_start", np.int64, "n_slots"),
        ("doc_n", np.int32, "n_slots"),
        ("doc_alive", np.bool_, "n_slots"),
        ("doc_off", np.int64, "n_slots"),
        ("term_total", np.int64, "n_terms"),
        ("term_df", np.int64, "n_terms"),
    )

    def save_snapshot(self) -> bool:
        """Persist the in-memory derived state (best-effort).

        Format v2: every large array is a raw .npy sidecar the loader
        memory-maps copy-on-write, so opening an index of any size
        reads only the meta .npz (term strings + counters) and pages
        array data in lazily as it is touched -- a read-only serving
        process whose device pack is already cached never reads the
        postings at all.  The meta .npz is written (and fsynced) last:
        a crash mid-save leaves sidecars the loader rejects by length
        check, falling back to journal replay -- the journals stay the
        only source of truth."""
        if self.generation == self._snapshot_gen:
            return False
        if any("\x00" in v for v in self.term_values):
            return False  # NUL-separated blob cannot hold such terms
        values_blob = "\x00".join(self.term_values).encode("utf-8")

        for name, _dtype, _group in self._SIDECARS:
            g: _Grow = getattr(self, name)
            tmp = self._postings_path(name) + ".tmp"
            with open(tmp, "wb") as f:
                np.save(f, g.view())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._postings_path(name))

        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(
                f,
                version=np.int64(self.SNAPSHOT_VERSION),
                terms_consumed=np.int64(self._terms_consumed),
                dt_consumed=np.int64(self._dt_consumed),
                doc_count=np.int64(self.doc_count),
                token_count=np.int64(self.token_count),
                values_blob=np.frombuffer(values_blob, dtype=np.uint8),
                n_terms=np.int64(len(self.term_values)),
                n_postings=np.int64(self.p_term.n),
                n_slots=np.int64(self.doc_ids.n),
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snapshot_path)
        self._snapshot_gen = self.generation
        return True

    def _load_snapshot(self) -> bool:
        try:
            with np.load(self._snapshot_path) as z:
                version = int(z["version"])
                if version not in (1, self.SNAPSHOT_VERSION):
                    return False
                terms_consumed = int(z["terms_consumed"])
                dt_consumed = int(z["dt_consumed"])
                # The snapshot must not be ahead of the journals (e.g.
                # journals truncated/recreated out-of-band).
                with self.terms_log.lock_sh():
                    if self.terms_log.committed_len() < terms_consumed:
                        return False
                with self.dtmap_log.lock_sh():
                    if self.dtmap_log.committed_len() < dt_consumed:
                        return False

                n_terms = int(z["n_terms"])
                blob = z["values_blob"].tobytes().decode("utf-8")
                self.term_values = blob.split("\x00") if n_terms else []
                if len(self.term_values) != n_terms:  # pragma: no cover
                    raise ValueError("snapshot term count mismatch")
                self.term_map = {
                    v: i + 1 for i, v in enumerate(self.term_values)}

                def grow(dtype, arr):
                    # Adopt the loaded array directly (no copy); the
                    # first mutating reserve() re-allocates.
                    g = _Grow(dtype, 0)
                    g.a = np.ascontiguousarray(arr, dtype=dtype)
                    g.n = len(arr)
                    return g

                if version >= 2:
                    # Every large array is a raw .npy sidecar,
                    # memory-mapped copy-on-write: pages fault in only
                    # when touched.
                    counts = {"n_postings": int(z["n_postings"]),
                              "n_slots": int(z["n_slots"]),
                              "n_terms": n_terms}
                    for name, dtype, group in self._SIDECARS:
                        m = np.load(self._postings_path(name),
                                    mmap_mode="c")
                        if len(m) != counts[group] or m.dtype != dtype:
                            raise ValueError(
                                f"sidecar {name} mismatch")
                        setattr(self, name, grow(dtype, m))
                else:  # legacy v1: everything inline in the npz
                    for name, dtype, _group in self._SIDECARS:
                        setattr(self, name, grow(dtype, z[name]))
                self._doc_map = None   # built lazily on first use
                self.doc_count = int(z["doc_count"])
                self.token_count = int(z["token_count"])
                self._terms_consumed = terms_consumed
                self._dt_consumed = dt_consumed
                self._snapshot_gen = self.generation
                return True
        except Exception:
            # Missing/corrupt snapshot or sidecar: fall back to full
            # replay.  State may be partially populated (e.g. the term
            # dictionary loads before a sidecar turns out to be gone),
            # so always reset.
            self._reset_state()
            return False

    def _reset_state(self) -> None:
        self.term_values = []
        self.term_map = {}
        self.term_total = _Grow(np.int64)
        self.term_df = _Grow(np.int64)
        self.p_term = _Grow(np.int32, 4096)
        self.p_count = _Grow(np.int32, 4096)
        self.p_slot = _Grow(np.int32, 4096)
        self.doc_ids = _Grow(np.int64)
        self.doc_len = _Grow(np.int32)
        self.doc_start = _Grow(np.int64)
        self.doc_n = _Grow(np.int32)
        self.doc_alive = _Grow(np.bool_)
        self.doc_off = _Grow(np.int64)
        self._doc_map = {}
        self.doc_count = 0
        self.token_count = 0
        self._terms_consumed = 0
        self._dt_consumed = 0

    def close(self) -> None:
        self.terms_log.close()
        self.dtmap_log.close()
