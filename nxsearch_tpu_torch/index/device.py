"""Device snapshot of the host index with incremental refresh (torch).

Port of nxsearch_tpu/index/device.py:DeviceIndex onto an explicit
``torch.device``.  The host-authoritative :class:`HostIndex` is
transposed to term-grouped CSR (HostIndex.build_csr) and published as
device tensors:

    postings_pack f32[P_pad + guard, 3]  (slot, ltf, dl) rows, slots by
                                         value (exact below 2**24)
    doc_len       f32[S_pad]
    alive_mask    int32[S_pad/32]        packed little-bit-order bitmap
    dense_rows    f32[max(H, 1), S_pad]  ltf by device slot, heavy terms

Device slots ascend by document length; ``slot_perm`` maps a device
slot back to its host slot.  Removals flip alive bits; additions stay
on the host as the delta (scored by search._delta_results) until the
delta outgrows its budget and a full rebuild runs.  The CSR layout is
cached in ``csr_cache.npz`` beside the journals above 2**24 postings,
in the reference's format, so both packages can open one basedir.

The impact-prefix region (reference ``_build_prefix``) is not built:
it is read only by R > 0 prefix plans, which the planner never emits
while NXS_PREFIX_MAX_WIDE is 0 (the default).  The planner-side
metadata is still published so R = 0 prefix plans route exactly as in
the reference: wide terms keep a non-negative ``prefix_start_lookup``
entry (which sends their rows to the classic sliced planner), tails
and cut lengths are zero, and ``slice_t_cap`` equals the reference's
guard width.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..utils.log import get_logger
from .hostindex import HostIndex

_log = get_logger(__name__)


def _bucket(n: int, minimum: int) -> int:
    """Smallest power-of-two >= max(n, minimum)."""
    size = minimum
    while size < n:
        size <<= 1
    return size


# Padded array growth: powers of two up to this size, then 1 MiB-element
# granularity (slot counts must stay well below 2**24; see the
# reference's _POW2_LIMIT note).
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
    """Power-of-two read-window tier of the reference's impact-prefix
    build for a term of ``df`` postings (sizes its read overhang)."""
    t = _bucket(cap + 1, 2)
    while t < df:
        t <<= 1
    return t


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
        self._guard_len = 0
        self._adl_dev = None
        self._adl_dev_val = None

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
        cached = self._load_csr_cache()
        if cached is not None:
            return self._rebuild_from_cache(cached)
        # Device slots ascend by document length (stable), as in the
        # reference; build_csr emits postings in (term, device slot)
        # order directly.
        t_phase = time.monotonic()
        n_slots_host = self.host.doc_ids.n
        dl_host = np.asarray(self.host.doc_len.view()[:n_slots_host],
                             dtype=np.float32)
        perm = np.argsort(dl_host, kind="stable").astype(np.int64)
        inv = np.empty(n_slots_host, dtype=np.int64)
        inv[perm] = np.arange(n_slots_host)

        snap = self.host.build_csr(slot_remap=inv)
        _log.debug("rebuild: build_csr %.1fs (%d postings)",
                   time.monotonic() - t_phase, len(snap["postings_slot"]))
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
        t_phase = time.monotonic()
        dev = self.device
        self.term_starts = term_starts
        self.base_nterms = len(term_starts) - 1
        # Guard width: the reference's slice_t_cap (its pack rounds up
        # to whole build chunks past the prefix region); reads never
        # pass p_pad + guard, so the port allocates only that.
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

        # Pack rows: CSR postings, then zero rows up to p_pad, then
        # guard rows carrying the s_pad sentinel slot (as far as the
        # reference's chunked upload writes them; beyond, zero rows).
        rows = p_pad + guard_len
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
        _log.debug("rebuild: pack build %.1fs", time.monotonic() - t_phase)

        self._publish_prefix_metadata(wide, counts, cap=cap, p_pad=p_pad,
                                      doc_count=doc_count,
                                      token_count=token_count)

        # Dense rows for the heaviest terms (device-slot indexed),
        # scattered from the pack: each (term, slot) occurs once, so
        # the scatter-add is an exact copy.
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
            seg = pack[s: s + ln]
            dense.index_add_(0, r * s_pad + seg[:, 0].to(torch.int64),
                             seg[:, 1])
        self.dense_rows = dense.reshape(-1, s_pad)

        self.postings_pack = pack
        self._guard_len = guard_len
        self.doc_len = dlen_dev
        self.slot_perm = perm
        self._alive_cached = doc_alive
        self._alive_all = bool(self._alive_cached.all())
        self.alive_mask = self._put(
            _pack_alive(self._alive_cached[perm], s_pad))
        self.n_slots = s_pad
        self.n_postings = p_pad
        self._arrival_mark = self.host.p_term.n
        self._slots_mark = self.host.doc_ids.n
        self._removed_since_base = 0
        self.generation = generation
        _log.debug("rebuild: total %.1fs (%d dense rows)",
                   time.monotonic() - t_phase, len(heavy))
        return True

    def _publish_prefix_metadata(self, wide, counts, *, cap: int,
                                 p_pad: int, doc_count: int,
                                 token_count: int) -> None:
        """Planner-side impact-prefix metadata without the region: each
        wide term's lookup holds the pack offset the reference would
        give its region (in the reference's tier order), so its rows
        leave the prefix planner exactly as there; tails and cut
        lengths stay zero (read only by R > 0 plans, not ported)."""
        lookup = np.full(self.base_nterms + 1, -1, dtype=np.int32)
        if len(wide):
            tiers = np.asarray([_prefix_tier(int(x), cap)
                                for x in counts[wide]], dtype=np.int64)
            order = np.lexsort((wide, tiers))
            lookup[wide[order] + 1] = (
                p_pad + np.arange(len(wide), dtype=np.int64) * cap
            ).astype(np.int32)
        self.prefix_start_lookup = lookup
        self.prefix_tail = np.zeros(self.base_nterms + 1, dtype=np.float32)
        self.prefix_len = np.zeros(self.base_nterms + 1, dtype=np.int32)
        self.prefix_cap = cap
        self.adl_built = float((token_count // doc_count)
                               if doc_count else 1.0)

    @classmethod
    def from_arrays(cls, host: HostIndex, arrays: dict,
                    device) -> "DeviceIndex":
        """A snapshot of ``host`` at its current generation from given
        arrays -- the state carried across from another build of the
        same base snapshot (e.g. nxsearch_tpu's DeviceIndex, exported
        with np.asarray), so both executors read identical inputs.

        Device arrays: ``postings_pack`` f32[rows, 3], ``doc_len``
        f32[S_pad], ``alive_mask`` u32/int32[S_pad/32], ``dense_rows``
        f32[H, S_pad].  Host metadata: ``term_starts``, ``slot_perm``,
        ``dense_row_lookup``, ``prefix_start_lookup`` (optionally
        ``prefix_tail`` / ``prefix_len``), and the ints ``n_postings``
        and ``slice_t_cap``."""
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
        self.generation = host.generation
        return self

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
