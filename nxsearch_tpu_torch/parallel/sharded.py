"""Doc-sharded search over a mesh of torch devices.

Port of nxsearch_tpu/parallel/sharded.py.  A mesh is an ordered list of
``torch.device``s, repeats allowed (``[cpu] * 8`` in the tests, four
shards of one card with ``[cuda:0] * 4``).  The doc-slot space is
partitioned contiguously: shard ``d`` holds host slots
``[d * Ss, (d + 1) * Ss)`` on ``mesh[d]`` -- its rows of every term's
postings (its own CSR row pointers), its document lengths, alive bitmap
and dense rows.  A query batch runs as

    per shard: the single-device executor over the shard's snapshot
               (ops/executor.py), local top-k
    -> the per-shard (score, global slot) candidates moved to mesh[0],
       the merge device, and concatenated in shard order
    -> one stable top-k

One process drives every device, as in the reference (which runs the
shard body under ``shard_map`` and merges with ``all_gather`` +
``lax.top_k``); torch.distributed is not used.  The concatenation in
shard order followed by a stable top-k breaks ties toward the lowest
global slot, as ``lax.top_k`` over the gathered candidates does.

Shard bodies, as in the reference: pure-OR BM25 plans run the
impact-prefix executor with R = 0 (``sharded_search_prefix_batch``:
each shard windows its own rows of every term in full, so the plane is
complete and exact); windowed / masked / head / dense-row plans run
``sliced_topk`` (``sharded_search_sliced_batch``); the rest run
``sharded_search_batch``: the blockdense executor (``use_kernel``, the
segsum CUDA kernel once per shard and 8-term group), the dense executor
(``use_dense``) or the candidate executor.  Every shard reads its slots
from an f32 pack, exact while ``slots_per_shard < 2**24``; the merged
global slots are int32 and exact at any mesh size.

Refresh mirrors index.device.DeviceIndex: removals flip the per-shard
alive bitmaps, additions stay host-side as the delta until its budget
forces a full rebuild.  Global slot == host slot (no length ordering).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..index.device import DeviceIndex, _bucket
from ..index.hostindex import HostIndex
from ..ops.executor import (_i32, _take, _topk, blockdense_topk,
                            candidate_topk, dense_topk, pack_prefix_group,
                            pack_sliced_group, prefix_topk_packed,
                            sliced_topk_packed)


def make_mesh(devices: Optional[Sequence] = None) -> list[torch.device]:
    """A mesh: the given devices in order (repeats allowed), by default
    every visible CUDA device.  A CUDA device without a card raises
    (nxs.resolve_device)."""
    from ..nxs import resolve_device

    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device is available for the mesh "
                               "(pass devices, e.g. [torch.device('cpu')]"
                               " * n)")
    mesh = [resolve_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _put(a, device: torch.device) -> torch.Tensor:
    """One host->device copy of a numpy array (a CPU copy owns its
    memory)."""
    t = torch.from_numpy(np.require(a, requirements=["C", "W"]))
    return t.clone() if device.type == "cpu" else t.to(device)


def _adl(adl: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(adl, dtype=torch.float32, device=device)


def merge_topk(parts, mesh, slots_per_shard: int, k: int):
    """The cross-shard merge: per shard ``d`` its (scores f32[N, k_l],
    local slots [N, k_l]) on ``mesh[d]``; returns (scores f32[N, k'],
    global slots int32[N, k']) on ``mesh[0]``, k' = min(k, n_dev * k_l).
    Candidates are concatenated in shard order and ranked by a stable
    top-k, so equal scores keep the lowest global slot first.  Dead
    lanes (score 0) carry their shard's offset slot and are dropped by
    score downstream."""
    dev0 = mesh[0]
    scores, slots = [], []
    for d, (s, sl) in enumerate(parts):
        scores.append(s.to(dev0, non_blocking=True))
        slots.append((sl.to(torch.int64) + d * slots_per_shard)
                     .to(dev0, non_blocking=True))
    all_s = torch.cat(scores, dim=1)
    m_s, ix = _topk(all_s, min(k, all_s.shape[1]))
    return m_s, torch.cat(slots, dim=1).gather(1, ix).to(torch.int32)


def sharded_search_prefix_batch(postings_pack, alive_mask, q_start, q_len,
                                q_idf, adl, *, mesh, T: int, k: int,
                                algo: int, alive_all: bool, n_run: int,
                                k_ret: int = 0):
    """Impact-prefix executor per shard (ops/executor.prefix_topk, R =
    0: complete planes, exact by construction).  ``postings_pack`` /
    ``alive_mask``: per-shard tensors; ``q_start`` / ``q_len``
    int32[n_dev, N, Qs] and ``q_idf`` f32[N, Qs] numpy; ``adl`` a float.
    Returns (scores f32[N, k'], global slots int32[N, k']) on mesh[0]."""
    n_q, qs = q_idf.shape
    slots_per_shard = alive_mask[0].shape[0] * 32
    k_local = min(k, qs * T)
    col_bit = np.zeros((n_q, qs), np.int32)
    zf = np.zeros((n_q, 0), np.float32)
    zi = np.zeros((n_q, 0), np.int32)
    parts = []
    for d, device in enumerate(mesh):
        buf = pack_prefix_group(q_start[d], q_len[d], q_idf, col_bit,
                                zf, zi, zi, zf)
        packed = prefix_topk_packed(
            postings_pack[d], alive_mask[d], _put(buf, device),
            _adl(adl, device), qs=qs, R=0, T=T, k=k_local, algo=algo,
            n_slots=slots_per_shard, alive_all=alive_all, n_run=n_run,
            k_ret=k_ret)
        parts.append((packed[:, 0], packed[:, 1]))
    return merge_topk(parts, mesh, slots_per_shard, k)


def sharded_search_sliced_batch(
        postings_pack, alive_mask, doc_len, q_start, q_len, q_idf, adl,
        prog_ops, prog_args, sl_rows=None, h_start=None, h_len=None,
        h_idf=None, h_row=None, h_pass=None, dense_rows=None, d_row=None,
        d_idf=None, *, mesh, T: int, k: int, algo: int, use_mask: bool,
        single: bool, alive_all: bool, depth: int = 8, n_run: int = 0,
        T_head: int = 0, use_rows: bool = False):
    """Sliced executor per shard (ops/executor.sliced_topk): windowed
    plans (``n_run`` > 0), head-term merges (``T_head`` > 0, per-shard
    head ranges ``h_start`` / ``h_len`` int32[n_dev, N]) and the
    pure-OR dense-row hybrid (``use_rows``, per-shard ``dense_rows``)
    run per shard exactly as on one device.  Per-shard arrays:
    ``q_start`` / ``q_len`` int32[n_dev, N, Qs]; the rest replicated
    numpy.  Returns (scores f32[N, k'], global slots int32[N, k'])."""
    n_q, qs = q_idf.shape
    slots_per_shard = doc_len[0].shape[0]
    k_local = min(k, slots_per_shard) if use_rows \
        else min(k, qs * T + T_head)
    n_dense = d_row.shape[1] if use_rows else 0
    parts = []
    for d, device in enumerate(mesh):
        buf = pack_sliced_group(
            q_start[d], q_len[d], q_idf,
            prog_ops if use_mask else None,
            prog_args if use_mask else None,
            d_row if use_rows else None, d_idf if use_rows else None,
            h_start[d] if T_head else None, h_len[d] if T_head else None,
            h_idf if T_head else None, h_row if T_head else None,
            h_pass if T_head else None,
            sl_rows if (use_mask and n_run) else None)
        packed = sliced_topk_packed(
            postings_pack[d], alive_mask[d], doc_len[d], _put(buf, device),
            _adl(adl, device), dense_rows[d] if use_rows else None,
            qs=qs, L=prog_ops.shape[1], D=n_dense, T=T, k=k_local,
            algo=algo, n_slots=slots_per_shard, use_mask=use_mask,
            single=single, alive_all=alive_all, use_rows=use_rows,
            depth=depth, T_head=T_head, n_run=n_run)
        parts.append((packed[:, 0], packed[:, 1]))
    return merge_topk(parts, mesh, slots_per_shard, k)


def sharded_search_batch(postings_slot, postings_ltf, doc_len, alive_mask,
                         q_start, q_len, q_idf, adl, prog_ops, prog_args, *,
                         mesh, budget: int, k: int, algo: int,
                         use_mask: bool, depth: int = 8,
                         use_kernel: bool = False, use_dense: bool = False):
    """The other executors per shard over the slot / ltf columns:
    blockdense (``use_kernel``: every slot scored by the segsum kernel,
    bounds from the CSR ranges), dense (``use_dense``) or candidate.
    ``q_start`` / ``q_len`` int32[n_dev, N, Q] (per-shard CSR ranges),
    ``q_idf`` f32[N, Q], ``prog_ops`` / ``prog_args`` int32[N, L]
    numpy.  Returns (scores f32[N, k'], global slots int32[N, k'])."""
    n_q, n_terms = q_idf.shape
    prog_len = prog_ops.shape[1]
    slots_per_shard = doc_len[0].shape[0]
    k_local = min(k, slots_per_shard if (use_kernel or use_dense)
                  else budget)
    kw = dict(algo=algo, use_mask=use_mask, depth=depth)
    parts = []
    for d, device in enumerate(mesh):
        # One upload per shard: q_start | q_len | q_idf | prog_ops |
        # prog_args, row-major.
        buf = _put(np.concatenate([_i32(a) for a in (
            q_start[d], q_len[d], q_idf, prog_ops, prog_args)]), device)
        sizes = (n_terms, n_terms, n_terms, prog_len, prog_len)
        offs = np.cumsum((0,) + sizes) * n_q
        qs, ql, qi, po, pa = (
            _take(buf, int(offs[i]), n_q, m, (m,), i == 2)
            for i, m in enumerate(sizes))
        cols = (postings_slot[d], postings_ltf[d], doc_len[d],
                alive_mask[d], qs, ql, qi, _adl(adl, device), po, pa)
        if use_kernel:
            s, sl = blockdense_topk(*cols, k=k_local,
                                    n_slots=slots_per_shard, **kw)
        elif use_dense:
            s, sl = dense_topk(*cols, budget=budget, k=k_local,
                               n_slots=slots_per_shard,
                               term_lens=q_len[d].max(axis=0).tolist(),
                               **kw)
        else:
            s, sl = candidate_topk(*cols, budget=budget, k=k_local, **kw)
        parts.append((s, sl))
    return merge_topk(parts, mesh, slots_per_shard, k)


class ShardedDeviceIndex:
    """Doc-sharded device mirror of one HostIndex generation.

    Same refresh contract as index.device.DeviceIndex, and what the
    search layer reads of a device index (``n_slots``, ``adl``,
    ``alive_all``, ``doc_ids``, ``base_nterms``, ``slice_t_cap``,
    ``generation``, the delta), plus ``mesh`` (its presence makes the
    planner plan per shard), ``n_dev``, ``slots_per_shard``, per-shard
    CSR pointers ``shard_starts`` / ``term_ranges`` and ``device``, the
    merge device ``mesh[0]``.  Device arrays are tuples with one tensor
    per shard, on that shard's device:

        postings_slot int32[Ps_pad]   shard-local slots
        postings_ltf  f32[Ps_pad]
        postings_pack f32[Ps_pad + guard, 3]  (slot, ltf, dl) rows;
                      rows past the shard's postings carry slot Ss
        doc_len       f32[Ss]
        alive_mask    int32[Ss / 32]  little-bit-order bitmap
        dense_rows    f32[H, Ss]      heavy terms' ltf (None if H = 0)
    """

    _MIN_SLOTS = 1024       # per shard: whole 1024-slot kernel blocks
    _MIN_POSTINGS = 4096    # per shard: whole 1024-posting kernel chunks

    DELTA_MAX_POSTINGS = 65536
    DELTA_MAX_REMOVALS = 65536

    def __init__(self, host: HostIndex, mesh):
        self.host = host
        self.mesh = [torch.device(d) for d in mesh]
        self.n_dev = len(self.mesh)
        self.device = self.mesh[0]
        self.generation = -1
        self.n_slots = 0            # global padded slot count
        self.slots_per_shard = 0
        self.base_nterms = 0
        self.postings_slot = None
        self.postings_ltf = None
        self.postings_pack = None
        self.doc_len = None
        self.alive_mask = None
        self._alive_all = True
        self.shard_starts = None    # host int64[n_dev, T + 1]
        self._arrival_mark = 0      # host postings consumed into base
        self._slots_mark = 0        # host slot count at base build
        self._alive_cached = np.zeros(0, dtype=np.bool_)
        self._removed_since_base = 0
        # Dense score rows for heavy terms: GLOBAL df and slot count
        # choose the (shard-invariant) row set, as in DeviceIndex.
        self.dense_rows = None
        self.dense_row_of: dict = {}
        self.dense_row_lookup = None

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
    def adl(self) -> float:
        if self.doc_count == 0:
            return 0.0
        return float(self.token_count // self.doc_count)

    @property
    def slice_t_cap(self) -> int:
        """Largest window the per-shard guard rows absorb."""
        if self.postings_pack is None:
            return DeviceIndex.SLICE_MAX_T
        return (int(self.postings_pack[0].shape[0])
                - int(self.postings_slot[0].shape[0]))

    @property
    def alive_all(self) -> bool:
        """True when no base-snapshot document is tombstoned."""
        return self._alive_all

    def drop_legacy_cols(self) -> None:
        """No-op: the slot / ltf columns are built with the snapshot."""

    # -- refresh -------------------------------------------------------

    def refresh(self) -> bool:
        """Bring the mesh view up to the host generation.  Returns True
        when device state changed (rebuild or bitmap flip)."""
        if self.generation == self.host.generation:
            return False
        host = self.host
        if self.postings_slot is None:
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
            self.alive_mask = self._put_sharded(self._packed_alive())
        self.generation = host.generation
        return n_newly_dead > 0

    def _packed_alive(self) -> np.ndarray:
        padded = np.zeros(self.n_slots, dtype=np.bool_)
        padded[: len(self._alive_cached)] = self._alive_cached
        packed = np.packbits(padded, bitorder="little").view(np.int32)
        return packed.reshape(self.n_dev, self.slots_per_shard // 32)

    def _put_sharded(self, arr: np.ndarray) -> tuple:
        return tuple(_put(arr[d], dev) for d, dev in enumerate(self.mesh))

    def _full_rebuild(self) -> bool:
        snap = self.host.build_csr()
        nterms = len(snap["term_starts"]) - 1
        self.base_nterms = nterms
        n_live = len(snap["doc_ids"])
        ss = _bucket(-(-max(n_live, 1) // self.n_dev), self._MIN_SLOTS)
        self.slots_per_shard = ss
        self.n_slots = ss * self.n_dev

        slots = snap["postings_slot"].astype(np.int64)
        counts = np.diff(snap["term_starts"])
        term_of = np.repeat(np.arange(nterms, dtype=np.int64), counts)
        shard_of = slots // ss

        # Per-(shard, term) histogram -> per-shard CSR row pointers.
        per = np.zeros((self.n_dev, nterms), dtype=np.int64)
        np.add.at(per, (shard_of, term_of), 1)
        starts = np.zeros((self.n_dev, nterms + 1), dtype=np.int64)
        np.cumsum(per, axis=1, out=starts[:, 1:])
        self.shard_starts = starts

        ps_pad = _bucket(int(starts[:, -1].max()), self._MIN_POSTINGS)
        pslot = np.zeros((self.n_dev, ps_pad), dtype=np.int32)
        pltf = np.zeros((self.n_dev, ps_pad), dtype=np.float32)
        # ltf on the host in f64 rounded to f32, the reference's value.
        ltf_all = np.log(snap["postings_tf"].astype(np.float64) + 1.0)
        # A stable partition by shard keeps each shard's postings in
        # term order, so the per-shard CSR pointers index them directly.
        order = np.argsort(shard_of, kind="stable")
        sizes = starts[:, -1]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        for d in range(self.n_dev):
            sel = order[offs[d]: offs[d + 1]]
            pslot[d, : sizes[d]] = (slots[sel] - d * ss).astype(np.int32)
            pltf[d, : sizes[d]] = ltf_all[sel]

        dlen = np.ones((self.n_dev, ss), dtype=np.float32)
        dlen.reshape(-1)[:n_live] = snap["doc_len"]

        # The sliced executors' interleaved rows, per shard, with guard
        # rows past the postings so window starts never clamp.
        guard = min(DeviceIndex.SLICE_MAX_T,
                    max(int(per.max()) if per.size else 0, 1))
        pack = np.zeros((self.n_dev, ps_pad + guard, 3), dtype=np.float32)
        for d in range(self.n_dev):
            n_d = int(sizes[d])
            pack[d, :n_d, 0] = pslot[d, :n_d]
            pack[d, n_d:, 0] = float(ss)
            pack[d, :n_d, 1] = pltf[d, :n_d]
            pack[d, :n_d, 2] = dlen[d, pslot[d, :n_d]]
        self.postings_pack = self._put_sharded(pack)

        # Dense rows: terms whose GLOBAL df exceeds the global slot
        # count / DENSE_DF_DIV (highest df first up to the row cap; the
        # row mapping needs ascending term ids, hence the np.sort).
        heavy = np.nonzero(
            counts > self.n_slots // DeviceIndex.DENSE_DF_DIV)[0]
        row_cap = min(DeviceIndex.MAX_DENSE_ROWS,
                      max(int(DeviceIndex.DENSE_ROWS_MAX_BYTES
                              // (4 * max(self.n_slots, 1))), 1))
        if len(heavy) > row_cap:
            heavy = np.sort(
                heavy[np.argsort(-counts[heavy], kind="stable")[: row_cap]])
        self.dense_row_of = {int(t) + 1: i for i, t in enumerate(heavy)}
        lookup = np.full(nterms + 1, -1, dtype=np.int32)
        lookup[heavy + 1] = np.arange(len(heavy), dtype=np.int32)
        self.dense_row_lookup = lookup
        self.dense_rows = None
        if len(heavy):
            # Each shard scatters its own postings of the heavy terms
            # from its pack; each (term, slot) occurs once, so the
            # scatter-add is an exact copy.
            rows = []
            for d, pk in enumerate(self.postings_pack):
                dense = torch.zeros(len(heavy) * ss, dtype=torch.float32,
                                    device=pk.device)
                for r, t in enumerate(heavy):
                    s, ln = int(starts[d, t]), int(per[d, t])
                    seg = pk[s: s + ln]
                    dense.index_add_(0, r * ss + seg[:, 0].to(torch.int64),
                                     seg[:, 1])
                rows.append(dense.reshape(len(heavy), ss))
            self.dense_rows = tuple(rows)

        self.postings_slot = self._put_sharded(pslot)
        self.postings_ltf = self._put_sharded(pltf)
        self.doc_len = self._put_sharded(dlen)
        self._alive_cached = snap["doc_alive"].copy()
        self._alive_all = bool(self._alive_cached.all())
        self.alive_mask = self._put_sharded(self._packed_alive())
        self._arrival_mark = self.host.p_term.n
        self._slots_mark = self.host.doc_ids.n
        self._removed_since_base = 0
        self.generation = snap["generation"]
        return True

    # -- query-side metadata (per-shard ranges) -------------------------

    def term_ranges(self, term_id: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard (start, length) of a 1-based term's base postings.
        Terms born after the base snapshot live in the delta."""
        if term_id > self.base_nterms:
            z = np.zeros(self.n_dev, dtype=np.int64)
            return z, z
        start = self.shard_starts[:, term_id - 1]
        end = self.shard_starts[:, term_id]
        return start, end - start

    # -- delta (host-side postings past the base watermark) -------------

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
        """(counts, slots) of one term's delta postings, from a
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
