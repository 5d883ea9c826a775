"""Device snapshot of the host index with incremental refresh (torch).

Port of nxsearch_tpu/index/device.py:DeviceIndex onto an explicit
``torch.device``.  The host-authoritative :class:`HostIndex` is
transposed to term-grouped CSR (HostIndex.build_csr) and published as
device tensors:

    postings_pack f32[P_pad + prefix + guard, 3]
                  (slot, ltf, dl) rows, slots by value (exact below
                  2**24): the CSR postings, the impact-prefix region,
                  then guard rows
    doc_len       f32[S_pad]
    alive_mask    int32[S_pad/32]        packed little-bit-order bitmap
    dense_rows    f32[max(H, 1), S_pad]  ltf by device slot, heavy terms

The blockdense, candidate and dense executors also read the pack's
slot and ltf columns (``postings_slot`` / ``postings_ltf``, derived on
first use); blockdense reads a per-term LRU cache of 1024-slot block
bounds too (``bounds_crows``).  From 2**24 slots, where f32 rounds odd
slots onto their neighbours, the slot column is the exact int32 one
uploaded at the rebuild and kept resident (4 B a posting); the routes
that read slots from the pack itself (impact-prefix, sliced,
blockdense) are gated below 2**24 by the planner, so such a snapshot
is served by the candidate and dense executors, exactly.

Impact prefixes (``PREFIX_CAP`` > 0, built at every rebuild): each
"wide" term (base df above max(PREFIX_CAP, WIDE_MIN_DF)) gets its top
postings by BM25 impact part ltf / (ltf + c1 + c2 * dl), at the
snapshot's adl, copied slot-sorted into the region, with the tie-free
cut length and the tail bound (the largest excluded impact) that
impact-prefix plans of NXS_PREFIX_MAX_WIDE > 0 read.

Device slots ascend by document length; ``slot_perm`` maps a device
slot back to its host slot.  Removals flip alive bits; additions stay
on the host as the delta (scored by search._delta_results) until the
delta outgrows its budget and a full rebuild runs.  The CSR layout is
cached in ``csr_cache.npz`` beside the journals above 2**24 postings,
in the reference's format, so both packages can open one basedir.

``prefix_graphs`` (ops/graphs.GraphCache) holds the CUDA graphs of the
impact-prefix dispatch groups captured against this snapshot; every
generation that ``refresh`` installs starts an empty one.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from ..ops.graphs import GraphCache
from ..utils.trace import phase
from .hostindex import HostIndex


def _bucket(n: int, minimum: int) -> int:
    """Smallest power-of-two >= max(n, minimum)."""
    size = minimum
    while size < n:
        size <<= 1
    return size


# Padded array growth: powers of two up to this size, then 1 MiB-element
# granularity (the reference's _POW2_LIMIT).
_POW2_LIMIT = 1 << 22


def _pad_size(n: int, minimum: int) -> int:
    """Padded allocation size: power-of-two up to _POW2_LIMIT, then
    the next multiple of 2**20."""
    if n <= _POW2_LIMIT:
        return _bucket(n, minimum)
    grain = 1 << 20
    return -(-n // grain) * grain


def _pack_alive(alive: np.ndarray, s_pad: int) -> np.ndarray:
    """bool[n] -> little-bit-order int32[s_pad/32] bitmap."""
    padded = np.zeros(s_pad, dtype=np.bool_)
    padded[: len(alive)] = alive
    return np.packbits(padded, bitorder="little").view(np.int32)


# Rows per pack-build chunk (bounds the transient device memory of the
# build to the pack plus one chunk of compact columns).
_PACK_CHUNK = 1 << 22


def _prefix_tier(df: int, cap: int) -> int:
    """Power-of-two read window of the impact-prefix build for a term
    of ``df`` postings (df > cap): starting above cap keeps the
    top cap + 1 inside every tier."""
    t = _bucket(cap + 1, 2)
    while t < df:
        t <<= 1
    return t


def _prefix_build(pack, starts, lens, c1, c2, *, tier: int, cap: int):
    """Impact prefixes of a chunk of wide terms of one read tier.

    ``starts`` / ``lens`` int64[n] CSR ranges (every len in (cap,
    tier]); ``c1`` / ``c2`` f32 scalar tensors.  Each term's window
    [s, s + tier) of the pack is scored by impact part
    g = ltf / (ltf + c1 + c2 * dl) (lanes past its length -inf; the
    denominator rounded once, as a fused multiply-add), the
    top cap + 1 taken in stable order, and the cut placed at the last
    strict decrease within them, so the tail (the impact at the cut)
    is strictly below every included impact.  Returns (rows f32[n,
    cap, 3]: the top cap postings with ranks [0, cut) slot-sorted
    first and the excluded boundary ties after them, tails f32[n],
    cuts int64[n]).  The operations are the reference's
    ``_prefix_build_dev``, whose allocation keeps every window inside
    the pack (no clamped start)."""
    from ..ops.executor import _topk

    pos = torch.arange(tier, device=pack.device)
    at = starts[:, None] + pos[None, :]                    # [n, tier]
    ltf = pack[at, 1]
    # (ltf + c1) + c2 * dl rounded once, as the reference's compiler
    # fuses it (a multiply-add): the f32 product is exact in f64.
    den = ((ltf + c1).double() + c2.double() * pack[at, 2].double()).float()
    part = ltf / den
    part = torch.where(pos[None, :] < lens[:, None], part, -float("inf"))
    vals, ix = _topk(part, cap + 1)
    idxs = torch.arange(cap + 1, device=pack.device)
    strict = torch.nn.functional.pad(vals[:, 1:] < vals[:, :-1], (1, 0))
    cut = torch.where(strict, idxs, 0).amax(dim=1)
    tail = vals.gather(1, cut[:, None])[:, 0]
    rows = pack[starts[:, None] + ix[:, :cap]]             # [n, cap, 3]
    keep = idxs[None, :cap] < cut[:, None]
    order = torch.sort(torch.where(keep, rows[..., 0], float("inf")),
                       dim=1, stable=True)[1]
    return rows.gather(1, order[..., None].expand(-1, -1, 3)), tail, cut


class DeviceIndex:
    """Base device snapshot + host delta for one HostIndex."""

    _MIN_SLOTS = 1024
    _MIN_POSTINGS = 4096

    # Delta budgets before a full rebuild.
    DELTA_MAX_POSTINGS = 65536
    DELTA_MAX_REMOVALS = 65536

    # Dense-row tier: terms with base df > n_slots // DENSE_DF_DIV
    # (capped at MAX_DENSE_ROWS and DENSE_ROWS_MAX_BYTES, highest-df
    # first), same selection as the reference.
    DENSE_DF_DIV = 16
    MAX_DENSE_ROWS = 128
    DENSE_ROWS_MAX_BYTES = int(
        os.environ.get("NXS_DENSE_ROWS_MB", "1280")) << 20

    # Largest window the sliced executor reads; the pack's guard rows
    # absorb windows starting inside the postings.
    SLICE_MAX_T = 1 << 20

    # Per-term bounds-cache rows (must exceed the unique kernel terms
    # of one dispatch chunk; LRU beyond that).
    BOUNDS_CACHE_ROWS = 8192

    # Impact-prefix parameters: terms with base df above
    # max(PREFIX_CAP, WIDE_MIN_DF) are "wide" (see the module note).
    PREFIX_CAP = int(os.environ.get("NXS_PREFIX_CAP", "16384"))
    WIDE_MIN_DF = int(os.environ.get("NXS_WIDE_MIN_DF", str(1 << 16)))

    # Indexes above this many postings persist the sorted CSR layout.
    CSR_CACHE_MIN_POSTINGS = 1 << 24
    _CSR_CACHE_VERSIONS = (1, 2)

    def __init__(self, host: HostIndex, device: torch.device):
        self.host = host
        self.device = torch.device(device)
        self.generation = -1
        self.term_starts = np.zeros(1, dtype=np.int64)
        self.base_nterms = 0
        self.n_slots = 0            # padded slot count (S_pad)
        self.n_postings = 0         # padded postings count (P_pad)
        self._arrival_mark = 0      # host postings consumed into base
        self._slots_mark = 0        # host slot count at base build
        self._alive_cached = np.zeros(0, dtype=np.bool_)
        self._removed_since_base = 0
        self.postings_pack = None
        # Slot / ltf columns of the pack for the blockdense, candidate
        # and dense executors, derived on first use (postings_slot /
        # postings_ltf); from 2**24 slots the exact int32 slot column
        # of the rebuild instead, never dropped (it cannot be derived).
        self._slot_dev = None
        self._ltf_dev = None
        self._slot_exact = None
        self.doc_len = None
        self.alive_mask = None
        self._alive_all = True
        self.slot_perm = None
        self.dense_rows = None
        self.dense_row_of = {}          # term_id -> row index
        self.dense_row_lookup = None    # int32[base_nterms + 1]
        self.prefix_start_lookup = None
        self.prefix_tail = None
        self.prefix_len = None
        self.prefix_cap = 0
        self.adl_built = -1.0
        # The last region build: wide-term count, bytes, seconds.
        self.prefix_stats = {"wide_terms": 0, "bytes": 0, "seconds": 0.0}
        self._guard_len = 0
        self._adl_dev = None
        self._adl_dev_val = None
        # Per-term block-bounds cache of the blockdense executor: rows
        # depend only on the base snapshot and the term, so the binary
        # search runs only on misses.  Row 0 stays all-zero (padding,
        # dense-handled and delta-born terms).  The LRU mutates under
        # concurrent readers, hence the lock; a reader holds it (it is
        # re-entrant) from ``bounds_crows`` until the kernel that reads
        # the rows is enqueued, so no other thread evicts them first.
        self._bounds_lock = threading.RLock()
        self._bounds_cache = None       # device int32[C, G+1]
        self._bounds_map = None         # OrderedDict term_id -> row
        self._bounds_next = 1
        self.prefix_graphs = GraphCache(self.device)

    # -- live aggregates (host-authoritative; search syncs first) ------

    @property
    def doc_count(self) -> int:
        return self.host.doc_count

    @property
    def token_count(self) -> int:
        return self.host.token_count

    @property
    def doc_ids(self) -> np.ndarray:
        return self.host.doc_ids.view()

    def term_live_df(self, term_id: int) -> int:
        return int(self.host.term_df.a[term_id - 1])

    @property
    def postings_slot(self) -> torch.Tensor:
        """int32[P_pad] slot column: below 2**24 slots derived from the
        pack on first use (slots ride in the pack as f32, exact there);
        from 2**24 the exact column uploaded at the rebuild."""
        if self._slot_exact is not None:
            return self._slot_exact
        if self._slot_dev is None and self.postings_pack is not None:
            self._slot_dev = self.postings_pack[: self.n_postings, 0].to(
                torch.int32).contiguous()
        return self._slot_dev

    @property
    def postings_ltf(self) -> torch.Tensor:
        """float32[P_pad] ltf column, derived from the pack on first use."""
        if self._ltf_dev is None and self.postings_pack is not None:
            self._ltf_dev = self.postings_pack[: self.n_postings, 1] \
                .contiguous()
        return self._ltf_dev

    def drop_legacy_cols(self) -> None:
        """Release the derived slot / ltf columns of a large snapshot
        (above 2**26 postings) after a batch used them: the next
        blockdense batch derives them again, so the second postings
        copy beside the pack is transient.  The exact slot column of a
        snapshot of 2**24 slots or more stays: the pack cannot give it
        back.  Queued work keeps its memory: the caching allocator
        reuses it only for work ordered after it on the stream.

        Request threads call this under the index's shared read lock,
        so one thread may drop the columns while another still uses
        them.  It cannot lose them: dropping clears only this object's
        reference; a thread that read ``postings_slot`` / ``postings_ltf``
        holds its own reference to the tensor until its launches are
        enqueued, and every thread enqueues on the device's one current
        stream, so the memory is reused only by work ordered after
        theirs.  A thread that finds the column gone derives it again."""
        if self.postings_pack is not None and self.n_postings > (1 << 26):
            self._slot_dev = None
            self._ltf_dev = None

    def _reset_derived(self) -> None:
        """Drop what derives from the base CSR (on every rebuild; the
        rebuild sets the exact slot column after this)."""
        self._slot_dev = None
        self._ltf_dev = None
        self._bounds_cache = None
        self._bounds_map = None

    @property
    def slice_t_cap(self) -> int:
        """Largest window the pack's guard rows can absorb (the
        reference's value, so the planners' window widths agree)."""
        if self.postings_pack is None:
            return self.SLICE_MAX_T
        return self._guard_len

    @property
    def alive_all(self) -> bool:
        """True when no base-snapshot document is tombstoned."""
        return self._alive_all

    @property
    def adl(self) -> float:
        """Average document length with the reference's integer
        division (ranking.c:160: unsigned long / unsigned long)."""
        if self.doc_count == 0:
            return 0.0
        return float(self.token_count // self.doc_count)

    @property
    def adl_dev(self) -> torch.Tensor:
        """Device-resident f32 adl scalar, cached per value."""
        a = self.adl
        if self._adl_dev_val != a:
            self._adl_dev = torch.tensor(a, dtype=torch.float32,
                                         device=self.device)
            self._adl_dev_val = a
        return self._adl_dev

    @property
    def prefix_ready(self) -> bool:
        """True when the impact-prefix metadata matches the base
        snapshot (the planner additionally gates on adl == adl_built)."""
        return (self.prefix_start_lookup is not None
                and self.prefix_cap > 0)

    # -- refresh -------------------------------------------------------

    def refresh(self) -> bool:
        """Bring the device view up to the host generation.  Returns
        True when the device state changed (rebuild or bitmap flip)."""
        if self.generation == self.host.generation:
            return False
        self.prefix_graphs = GraphCache(self.device)
        host = self.host
        if self.postings_pack is None:
            return self._full_rebuild()

        delta_postings = host.p_term.n - self._arrival_mark
        host_alive = host.doc_alive.view()
        newly_dead = self._alive_cached & ~host_alive[: self._slots_mark]
        n_newly_dead = int(np.count_nonzero(newly_dead))
        if (delta_postings > self.DELTA_MAX_POSTINGS
                or self._removed_since_base + n_newly_dead
                > self.DELTA_MAX_REMOVALS):
            return self._full_rebuild()

        if n_newly_dead:
            self._alive_cached &= host_alive[: self._slots_mark]
            self._removed_since_base += n_newly_dead
            self._alive_all = False
            self.alive_mask = self._put(
                _pack_alive(self._alive_cached[self.slot_perm],
                            self.n_slots))
        self.generation = host.generation
        return n_newly_dead > 0

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
        # A CPU snapshot owns its memory (the array may be a reused
        # host buffer).
        return t.clone() if self.device.type == "cpu" else t.to(self.device)

    # -- CSR layout cache (same file format as the reference) ----------

    @property
    def _csr_cache_path(self) -> str:
        return os.path.join(self.host.idxdir, "csr_cache.npz")

    def _load_csr_cache(self):
        try:
            z = np.load(self._csr_cache_path, allow_pickle=False)
            if (int(z["version"]) not in self._CSR_CACHE_VERSIONS
                    or int(z["generation"]) != self.host.generation):
                return None
            return z
        except (OSError, KeyError, ValueError):
            return None

    def _save_csr_cache(self, term_starts, slot_real, tf16, ltf_real,
                        perm) -> None:
        tmp = self._csr_cache_path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                if tf16 is not None:
                    np.savez(f, version=np.int64(2),
                             generation=np.int64(self.host.generation),
                             term_starts=term_starts,
                             slot=slot_real, tf16=tf16, perm=perm)
                else:  # pragma: no cover - >64k tf fallback
                    np.savez(f, version=np.int64(1),
                             generation=np.int64(self.host.generation),
                             term_starts=term_starts,
                             slot=slot_real, ltf=ltf_real, perm=perm)
            os.replace(tmp, self._csr_cache_path)
        except OSError:  # pragma: no cover - best-effort cache
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _full_rebuild(self) -> bool:
        """Build the snapshot: one ``snapshot.build`` span, a child span
        a step (utils/trace.phase)."""
        with phase("snapshot.build", slots=self.host.doc_ids.n) as span:
            cached = self._load_csr_cache()
            span.set(from_cache=cached is not None)
            if cached is not None:
                return self._rebuild_from_cache(cached)
            return self._build_from_host()

    def _build_from_host(self) -> bool:
        # Device slots ascend by document length (stable), as in the
        # reference; build_csr emits postings in (term, device slot)
        # order directly.
        with phase("snapshot.build_csr") as span:
            n_slots_host = self.host.doc_ids.n
            dl_host = np.asarray(self.host.doc_len.view()[:n_slots_host],
                                 dtype=np.float32)
            perm = np.argsort(dl_host, kind="stable").astype(np.int64)
            inv = np.empty(n_slots_host, dtype=np.int64)
            inv[perm] = np.arange(n_slots_host)
            snap = self.host.build_csr(slot_remap=inv)
            span.set(postings=len(snap["postings_slot"]))
        n_post = len(snap["postings_slot"])
        s_pad = _pad_size(n_slots_host, self._MIN_SLOTS)
        p_pad = _pad_size(n_post, self._MIN_POSTINGS)
        counts = np.diff(snap["term_starts"])

        slot_real = np.ascontiguousarray(snap["postings_slot"],
                                         dtype=np.int32)
        tf_f = snap["postings_tf"]
        tf16 = ltf_real = None
        if not len(tf_f) or tf_f.max() < 65536:
            tf16 = tf_f.astype(np.uint16)
        else:  # pragma: no cover - >64k occurrences of one term
            ltf_real = np.log(tf_f.astype(np.float64) + 1.0).astype(
                np.float32)
        dlen = np.ones(s_pad, dtype=np.float32)
        dlen[:n_slots_host] = snap["doc_len"][perm]
        if n_post >= self.CSR_CACHE_MIN_POSTINGS:
            with phase("snapshot.csr_cache"):
                self._save_csr_cache(snap["term_starts"], slot_real, tf16,
                                     ltf_real, perm)

        return self._finish_rebuild(
            term_starts=snap["term_starts"], counts=counts,
            slot_real=slot_real, tf16=tf16, ltf_real=ltf_real,
            dlen=dlen, perm=perm, n_post=n_post,
            n_slots_host=n_slots_host, s_pad=s_pad, p_pad=p_pad,
            doc_alive=snap["doc_alive"].copy(),
            doc_count=snap["doc_count"], token_count=snap["token_count"],
            generation=snap["generation"])

    def _rebuild_from_cache(self, z) -> bool:
        """Assemble the snapshot from the persisted CSR layout (skips
        build_csr's lexsort; the cache is generation-checked)."""
        host = self.host
        term_starts = np.asarray(z["term_starts"])
        slot_real = np.asarray(z["slot"])
        tf16 = np.asarray(z["tf16"]) if "tf16" in z else None
        ltf_real = np.asarray(z["ltf"]) if tf16 is None else None
        perm = np.asarray(z["perm"])
        n_slots_host = host.doc_ids.n
        n_post = len(slot_real)
        s_pad = _pad_size(n_slots_host, self._MIN_SLOTS)
        p_pad = _pad_size(n_post, self._MIN_POSTINGS)
        dlen = np.ones(s_pad, dtype=np.float32)
        dlen[:n_slots_host] = \
            host.doc_len.view()[:n_slots_host].astype(np.float32)[perm]
        return self._finish_rebuild(
            term_starts=term_starts, counts=np.diff(term_starts),
            slot_real=slot_real, tf16=tf16, ltf_real=ltf_real,
            dlen=dlen, perm=perm, n_post=n_post,
            n_slots_host=n_slots_host, s_pad=s_pad, p_pad=p_pad,
            doc_alive=host.doc_alive.view()[:n_slots_host].copy(),
            doc_count=host.doc_count, token_count=host.token_count,
            generation=host.generation)

    def _finish_rebuild(self, *, term_starts, counts, slot_real,
                        dlen, perm, n_post, n_slots_host, s_pad, p_pad,
                        doc_alive, doc_count, token_count, generation,
                        tf16=None, ltf_real=None) -> bool:
        """Publish the device snapshot.  Postings arrive unpadded as
        ``slot_real`` int32[n_post] plus ``tf16`` uint16 counts (ltf is
        computed on the device as f32 log(tf + 1), the reference's
        device formula) or ``ltf_real`` float32."""
        self.term_starts = term_starts
        self.base_nterms = len(term_starts) - 1
        # Guard rows past the CSR postings keep every sliced window
        # start unclamped.  The impact-prefix region sits between the
        # postings and the guard; its build reads each wide term
        # through a power-of-two tier window, so the allocation also
        # absorbs the largest read overhang.  The pack rounds up to
        # whole build chunks, the reference's layout row for row.
        guard = min(self.SLICE_MAX_T,
                    max(int(counts.max()) if len(counts) else 0, 1))
        cap = int(self.PREFIX_CAP)
        wide_min = max(cap, int(self.WIDE_MIN_DF))
        wide = (np.nonzero(counts > wide_min)[0]
                if cap > 0 and doc_count > 0 else
                np.zeros(0, dtype=np.int64))
        prefix_len = len(wide) * cap
        tail_min = p_pad + prefix_len + guard
        if len(wide):
            w_tiers = np.asarray(
                [_prefix_tier(int(c), cap) for c in counts[wide]],
                dtype=np.int64)
            tail_min = max(tail_min, int(
                (term_starts[wide].astype(np.int64) + w_tiers).max()))
        assert tail_min < (1 << 31), "pack offsets must stay int32"
        chunk = min(_PACK_CHUNK, _pad_size(tail_min, 1 << 12))
        n_round = -(-tail_min // chunk) * chunk
        guard_len = n_round - p_pad - prefix_len
        upload_hi = min(n_round, -(-p_pad // chunk) * chunk)
        with phase("snapshot.pack", rows=n_round, postings=n_post):
            pack, dlen_dev = self._upload_pack(
                n_round, upload_hi, slot_real, tf16, ltf_real, dlen,
                n_post=n_post, s_pad=s_pad, p_pad=p_pad)
        # From 2**24 slots the pack's f32 slots round odd slots onto
        # their neighbours: the exact int32 column of the postings stays.
        slot_exact = None
        if s_pad >= (1 << 24):
            with phase("snapshot.slot_exact", postings=n_post):
                slot_exact = self._upload_slot_exact(slot_real, p_pad)

        # The region's rows carry f32 slots; only impact-prefix plans
        # read them, and search._prefix_mode gates those below 2**24.
        with phase("snapshot.prefix", wide_terms=len(wide)):
            self._build_prefix(pack, wide, term_starts, counts, cap=cap,
                               p_pad=p_pad, adl_build=float(
                                   (token_count // doc_count) if doc_count
                                   else 1.0))
        with phase("snapshot.dense_rows") as span:
            heavy = self._build_dense_rows(pack, slot_exact, term_starts,
                                           counts, s_pad)
            span.set(rows=len(heavy))

        self.postings_pack = pack
        self._guard_len = guard_len
        self.doc_len = dlen_dev
        self.slot_perm = perm
        self._alive_cached = doc_alive
        self._alive_all = bool(self._alive_cached.all())
        with phase("snapshot.alive"):
            self.alive_mask = self._put(
                _pack_alive(self._alive_cached[perm], s_pad))
        self.n_slots = s_pad
        self.n_postings = p_pad
        self._arrival_mark = self.host.p_term.n
        self._slots_mark = self.host.doc_ids.n
        self._removed_since_base = 0
        self._reset_derived()
        self._slot_exact = slot_exact
        self.generation = generation
        return True

    def _upload_pack(self, rows, upload_hi, slot_real, tf16, ltf_real,
                     dlen, *, n_post, s_pad, p_pad):
        """The pack on the device, uploaded in chunks: CSR postings, then
        zero rows up to p_pad, then rows carrying the s_pad sentinel slot
        as far as the reference's chunked upload writes them (beyond,
        zero rows); the prefix build overwrites the region.  Returns the
        pack and the device doc lengths."""
        dev = self.device
        pack = torch.zeros((rows, 3), dtype=torch.float32, device=dev)
        dlen_dev = self._put(dlen)
        sent_hi = min(rows, upload_hi)
        for off in range(0, sent_hi, _PACK_CHUNK):
            hi = min(off + _PACK_CHUNK, sent_hi)
            slot_c = np.zeros(hi - off, dtype=np.int32)
            vals_c = np.zeros(hi - off, dtype=np.float32 if tf16 is None
                              else np.uint16)
            lo_p, hi_p = off, min(hi, n_post)
            if hi_p > lo_p:
                slot_c[: hi_p - lo_p] = slot_real[lo_p:hi_p]
                vals_c[: hi_p - lo_p] = (tf16 if tf16 is not None
                                         else ltf_real)[lo_p:hi_p]
            if hi > p_pad:
                slot_c[max(p_pad - off, 0):] = s_pad
            slot_d = self._put(slot_c)
            vals_d = self._put(vals_c.astype(np.int32)
                               if tf16 is not None else vals_c)
            ltf = (torch.log(vals_d.to(torch.float32) + 1.0)
                   if tf16 is not None else vals_d)
            pack[off:hi, 0] = slot_d.to(torch.float32)
            pack[off:hi, 1] = ltf
            pack[off:hi, 2] = dlen_dev[torch.clamp(
                slot_d, max=s_pad - 1).to(torch.int64)]
        return pack, dlen_dev

    def _upload_slot_exact(self, slot_real, p_pad: int):
        """int32[p_pad] exact slot column on the device: the CSR
        postings' slots, then zeros, uploaded in pack-sized chunks."""
        col = torch.zeros(p_pad, dtype=torch.int32, device=self.device)
        for off in range(0, len(slot_real), _PACK_CHUNK):
            hi = min(off + _PACK_CHUNK, len(slot_real))
            col[off:hi] = self._put(slot_real[off:hi])
        return col

    def _build_dense_rows(self, pack, slot_exact, term_starts, counts,
                          s_pad: int) -> np.ndarray:
        """Dense rows for the heaviest terms (device-slot indexed),
        scattered from the pack's ltf by the exact slots: each (term,
        slot) occurs once, so the scatter-add is an exact copy.  Returns
        the terms that got a row."""
        dev = self.device
        heavy = np.nonzero(counts > s_pad // self.DENSE_DF_DIV)[0]
        row_cap = min(self.MAX_DENSE_ROWS,
                      max(int(self.DENSE_ROWS_MAX_BYTES // (4 * s_pad)), 1))
        if len(heavy) > row_cap:
            heavy = np.sort(
                heavy[np.argsort(-counts[heavy], kind="stable")[: row_cap]])
        self.dense_row_of = {int(t) + 1: i for i, t in enumerate(heavy)}
        lookup = np.full(self.base_nterms + 1, -1, dtype=np.int32)
        lookup[heavy + 1] = np.arange(len(heavy), dtype=np.int32)
        self.dense_row_lookup = lookup
        dense = torch.zeros((max(len(heavy), 1) * s_pad,),
                            dtype=torch.float32, device=dev)
        for r, t in enumerate(heavy):
            s, ln = int(term_starts[t]), int(counts[t])
            slots = (slot_exact[s: s + ln] if slot_exact is not None
                     else pack[s: s + ln, 0]).to(torch.int64)
            dense.index_add_(0, r * s_pad + slots, pack[s: s + ln, 1])
        self.dense_rows = dense.reshape(-1, s_pad)
        return heavy

    def _build_prefix(self, pack, wide, term_starts, counts, *, cap: int,
                      p_pad: int, adl_build: float) -> None:
        """Fill the pack's impact-prefix region in place and publish the
        planner's metadata: per 1-based term id the region offset
        (``prefix_start_lookup``, -1 for narrow terms), the tail bound
        (``prefix_tail``) and the tie-free cut (``prefix_len``), and the
        adl the impacts were ordered at (``adl_built``).  Wide terms
        take region slots in (tier, term) order and are built a tier at
        a time in chunks of at most 2**26 window lanes and 2**22 region
        rows; ``prefix_stats`` records the count, bytes and seconds."""
        from ..ops.scoring import BM25_B, BM25_K1

        t0 = time.perf_counter()
        lookup = np.full(self.base_nterms + 1, -1, dtype=np.int32)
        tails = np.zeros(self.base_nterms + 1, dtype=np.float32)
        plens = np.zeros(self.base_nterms + 1, dtype=np.int32)
        self.prefix_start_lookup = lookup
        self.prefix_tail = tails
        self.prefix_len = plens
        self.adl_built = adl_build
        self.prefix_cap = cap
        if len(wide):
            lens_w = counts[wide].astype(np.int64)
            tiers = np.asarray([_prefix_tier(int(x), cap) for x in lens_w],
                               dtype=np.int64)
            order = np.lexsort((wide, tiers))
            wide, lens_w, tiers = wide[order], lens_w[order], tiers[order]
            starts_w = term_starts[wide].astype(np.int64)
            dest = p_pad + np.arange(len(wide), dtype=np.int64) * cap
            tails_w = np.zeros(len(wide), dtype=np.float32)
            cuts_w = np.zeros(len(wide), dtype=np.int32)
            dev = pack.device
            c1 = torch.tensor(np.float32(BM25_K1 * (1.0 - BM25_B)),
                              device=dev)
            c2 = torch.tensor(np.float32(BM25_K1 * BM25_B
                                         / max(adl_build, 1e-9)),
                              device=dev)
            at = 0
            while at < len(wide):
                tier = int(tiers[at])
                hi = at + int(np.count_nonzero(tiers[at:] == tier))
                nt = max(1, min((1 << 26) // tier, (1 << 22) // cap))
                for g in range(at, hi, nt):
                    ge = min(g + nt, hi)
                    rows, t_d, c_d = _prefix_build(
                        pack, self._put(starts_w[g:ge]),
                        self._put(lens_w[g:ge]), c1, c2, tier=tier, cap=cap)
                    pack[int(dest[g]): int(dest[g]) + (ge - g) * cap] = \
                        rows.reshape(-1, 3)
                    tails_w[g:ge] = t_d.cpu().numpy()
                    cuts_w[g:ge] = c_d.cpu().numpy()
                at = hi
            lookup[wide + 1] = dest.astype(np.int32)
            tails[wide + 1] = tails_w
            plens[wide + 1] = cuts_w
        self.prefix_stats = {"wide_terms": int(len(wide)),
                             "bytes": int(len(wide) * cap * 12),
                             "seconds": time.perf_counter() - t0}

    @classmethod
    def from_arrays(cls, host: HostIndex, arrays: dict,
                    device) -> "DeviceIndex":
        """A snapshot of ``host`` at its current generation from given
        arrays -- the state carried across from another build of the
        same base snapshot (e.g. nxsearch_tpu's DeviceIndex, exported
        with np.asarray), so both executors read identical inputs.

        Device arrays: ``postings_pack`` f32[rows, 3], ``doc_len``
        f32[S_pad], ``alive_mask`` u32/int32[S_pad/32], ``dense_rows``
        f32[H, S_pad], and optionally the blockdense bounds cache
        ``bounds_cache`` int32[C, G+1] with its LRU ``bounds_map``
        (term id -> row, oldest first).  Host metadata: ``term_starts``,
        ``slot_perm``, ``dense_row_lookup``, ``prefix_start_lookup``
        (optionally ``prefix_tail`` / ``prefix_len``), and the ints
        ``n_postings`` and ``slice_t_cap``."""
        self = cls(host, device)
        put = self._put
        self.postings_pack = put(np.asarray(arrays["postings_pack"],
                                            dtype=np.float32))
        self.doc_len = put(np.asarray(arrays["doc_len"], dtype=np.float32))
        self.alive_mask = put(np.asarray(arrays["alive_mask"]).view(
            np.int32))
        self.dense_rows = put(np.asarray(arrays["dense_rows"],
                                         dtype=np.float32))
        self.term_starts = np.asarray(arrays["term_starts"])
        self.base_nterms = len(self.term_starts) - 1
        self.slot_perm = np.asarray(arrays["slot_perm"])
        lookup = np.asarray(arrays["dense_row_lookup"], dtype=np.int32)
        self.dense_row_lookup = lookup
        self.dense_row_of = {int(t): int(lookup[t])
                             for t in np.nonzero(lookup >= 0)[0]}
        self.prefix_start_lookup = np.asarray(
            arrays["prefix_start_lookup"], dtype=np.int32)
        n = self.base_nterms + 1
        self.prefix_tail = np.asarray(arrays.get(
            "prefix_tail", np.zeros(n, np.float32)), dtype=np.float32)
        self.prefix_len = np.asarray(arrays.get(
            "prefix_len", np.zeros(n, np.int32)), dtype=np.int32)
        self.prefix_cap = int(cls.PREFIX_CAP)
        self.adl_built = self.adl if host.doc_count else 1.0
        self.n_slots = int(self.doc_len.shape[0])
        self.n_postings = int(arrays["n_postings"])
        self._guard_len = int(arrays["slice_t_cap"])
        n_host = host.doc_ids.n
        self._alive_cached = host.doc_alive.view()[:n_host].copy()
        self._alive_all = bool(self._alive_cached.all())
        self._arrival_mark = host.p_term.n
        self._slots_mark = n_host
        if "bounds_cache" in arrays:
            cache = np.asarray(arrays["bounds_cache"], dtype=np.int32)
            self._bounds_cache = put(cache)
            self._bounds_map = OrderedDict(
                (int(t), int(r)) for t, r in arrays["bounds_map"].items())
            self._bounds_next = max(self._bounds_map.values(), default=0) + 1
        self.generation = host.generation
        return self

    # -- per-term bounds cache ---------------------------------------------

    def bounds_crows(self, term_ids) -> dict[int, int]:
        """Cache rows of the given base terms' block bounds; missing
        rows are computed in one csr_block_bounds call and written into
        the cache.  Terms without base postings map to row 0.
        Thread-safe; the rows stay valid only while the caller holds
        ``_bounds_lock`` (re-entrant) until it has enqueued the work
        that reads them: every thread enqueues on the device's one
        current stream, so a later eviction's write runs after that
        read."""
        with self._bounds_lock:
            return self._bounds_crows_locked(term_ids)

    def _bounds_crows_locked(self, term_ids) -> dict[int, int]:
        from ..ops.executor import csr_block_bounds
        from ..ops.kernels import BLOCK_SLOTS

        n_blocks = self.n_slots // BLOCK_SLOTS
        if self._bounds_map is None:
            self._bounds_map = OrderedDict()
        if self._bounds_cache is None:
            self._bounds_cache = torch.zeros(
                (self.BOUNDS_CACHE_ROWS, n_blocks + 1), dtype=torch.int32,
                device=self.device)
            self._bounds_next = 1
        out: dict[int, int] = {}
        missing: list[int] = []
        for t in term_ids:
            row = self._bounds_map.get(t)
            if row is not None:
                self._bounds_map.move_to_end(t)
                out[t] = row
            elif self.term_range(t)[1] > 0:
                if t not in out:
                    missing.append(t)
                    out[t] = -1         # assigned below
            else:
                out[t] = 0
        if not missing:
            return out

        rows = []
        pinned = set()
        for t in missing:
            if self._bounds_next < self.BOUNDS_CACHE_ROWS:
                row = self._bounds_next
                self._bounds_next += 1
            else:
                # LRU-evict a row not assigned by this very call.
                for old_t, old_row in self._bounds_map.items():
                    if old_row not in pinned:
                        del self._bounds_map[old_t]
                        row = old_row
                        break
                else:
                    raise RuntimeError("bounds cache exhausted")
            pinned.add(row)
            self._bounds_map[t] = row
            out[t] = row
            rows.append(row)

        ranges = np.asarray([self.term_range(t) for t in missing],
                            dtype=np.int32).reshape(-1, 2)
        ranges_d = self._put(ranges)
        new_rows = csr_block_bounds(self.postings_slot, ranges_d[:, 0],
                                    ranges_d[:, 1], n_blocks=n_blocks)
        self._bounds_cache[self._put(np.asarray(rows, dtype=np.int64))] = \
            new_rows
        return out

    # -- query-side metadata ----------------------------------------------

    def term_range(self, term_id: int) -> tuple[int, int]:
        """Base-CSR (start, length) of a 1-based term's postings (terms
        born after the base snapshot live in the delta)."""
        if term_id > self.base_nterms:
            return 0, 0
        start = int(self.term_starts[term_id - 1])
        end = int(self.term_starts[term_id])
        return start, end - start

    # -- delta (host-side postings past the base watermark) ---------------

    @property
    def has_delta(self) -> bool:
        return self.host.p_term.n > self._arrival_mark

    @property
    def delta_slot0(self) -> int:
        """First host doc slot not covered by the base snapshot."""
        return self._slots_mark

    def delta_postings(self):
        """(term_ids, counts, slots) numpy views of the delta."""
        host = self.host
        mark = self._arrival_mark
        return (host.p_term.a[mark: host.p_term.n],
                host.p_count.a[mark: host.p_count.n],
                host.p_slot.a[mark: host.p_slot.n])

    def delta_lookup(self, term_id: int):
        """(counts, slots) of the delta postings of one term, from a
        term-sorted index built once per delta watermark."""
        mark = self._arrival_mark
        n = self.host.p_term.n
        if getattr(self, "_dx_key", None) != (mark, n):
            d_term, d_count, d_slot = self.delta_postings()
            order = np.argsort(d_term, kind="stable")
            self._dx_terms = d_term[order]
            self._dx_count = d_count[order]
            self._dx_slot = d_slot[order]
            self._dx_key = (mark, n)
        lo = np.searchsorted(self._dx_terms, term_id, side="left")
        hi = np.searchsorted(self._dx_terms, term_id, side="right")
        return self._dx_count[lo:hi], self._dx_slot[lo:hi]
