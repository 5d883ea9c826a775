"""Fuzzy term matching: Levenshtein tolerance 2 + popularity pick.

The reference resolves unmatched query tokens via a BK-tree over all
terms searched within Levenshtein tolerance 2 (src/index/idxterm.c:210-
249, src/algo/bktree.c:219, LEVDIST_TOLERANCE src/index/index.h:26) and
selects "the most popular term" among candidates by total occurrence
count (idxterm.c:236-242; only terms with a non-zero live total are
eligible).  Distances are measured over UTF-8 *bytes*, matching
src/algo/levdist.c operating on char.

Port of nxsearch_tpu/fuzzy.py.  Two execution paths, identical results:

- **Device** (vocabularies >= _DEVICE_THRESHOLD): bit-parallel Myers
  edit distance over a length-sorted vocabulary snapshot on the
  index's device (ops/levenshtein.py) -- the hand-written CUDA kernel
  on a card, its plain torch twin on the CPU.  Terms longer than 32
  bytes are excluded from the snapshot; they can only match queries
  >= 31 bytes, which are scanned on the host.
- **Host** (small vocabularies or >32-byte query tokens): length-pruned
  banded Wagner-Fischer, mirroring levdist.c.

Ties on the total count pick the lowest (oldest) term ID.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .index.hostindex import HostIndex

TOLERANCE = 2

_DEVICE_THRESHOLD = 4096   # below this, host DP beats a device dispatch
_MAX_DEVICE_BYTES = 32
# Query rows per kernel launch on a card; the CPU twin materializes
# [rows, W] int64 planes per step, so its chunk stays small.
_CHUNK_CUDA = 64
_CHUNK_CPU = 8


def levdist(a: bytes, b: bytes, cutoff: Optional[int] = None) -> int:
    """Levenshtein distance over bytes (levdist.c semantics).

    With ``cutoff``, returns cutoff+1 early once the distance provably
    exceeds it (band minimum test).
    """
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    if cutoff is not None and abs(n - m) > cutoff:
        return cutoff + 1
    # Single-row DP (Wagner-Fischer), row indexed by b.
    row = list(range(m + 1))
    for i in range(1, n + 1):
        prev_diag = row[0]
        row[0] = i
        best = row[0]
        ai = a[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ai == b[j - 1] else 1
            cur = min(row[j] + 1,          # deletion
                      row[j - 1] + 1,      # insertion
                      prev_diag + cost)    # substitution
            prev_diag = row[j]
            row[j] = cur
            if cur < best:
                best = cur
        if cutoff is not None and best > cutoff:
            return cutoff + 1
    return row[m]


class FuzzyMatcher:
    """Per-index fuzzy resolver over the term dictionary."""

    def __init__(self, host: HostIndex, device,
                 tolerance: int = TOLERANCE):
        self.host = host
        self.device = torch.device(device)
        self.tolerance = tolerance
        self._gen = -1
        self._encoded: list[bytes] = []
        self._lengths = np.zeros(0, dtype=np.int32)
        # Device snapshot (built lazily past the threshold).
        self._dev_gen = -1
        self._dev_bytes = None
        self._dev_len = None
        self._dev_total = None
        self._dev_ids = None
        self._vb_cache = None
        self._vl_cache = None
        self._vb_filled = 0
        self._memo_cache = None
        self._memo_gen = -1

    def _refresh(self) -> None:
        if self._gen == self.host.generation:
            return
        values = self.host.term_values
        start = len(self._encoded)
        if start > len(values):  # pragma: no cover - dictionary never shrinks
            start, self._encoded = 0, []
        self._encoded.extend(v.encode("utf-8") for v in values[start:])
        self._lengths = np.fromiter(
            (len(e) for e in self._encoded), dtype=np.int32,
            count=len(self._encoded))
        self._gen = self.host.generation

    def _refresh_device(self) -> None:
        """Refresh the device vocab snapshot for this generation.

        The snapshot is LENGTH-SORTED: rows ascend by byte length
        (excluded >32-byte terms sink past the end), with a per-length
        offsets table ``_len_off`` and an original-index column
        ``_dev_ids``, so a query's tolerance band sweeps ONE contiguous
        region (``_region``).  Rows are row-major uint8[n, 32], the
        layout the kernel reads with two 16-byte loads per term.  New
        rows are encoded incrementally into a host cache that grows
        geometrically; the sorted layout rebuilds only when terms were
        added, and the totals (clipped to u32 range, carried as int64)
        re-upload every generation."""
        if self._dev_gen == self._gen:
            return
        n = len(self._encoded)
        vb = self._vb_cache
        filled = self._vb_filled
        if vb is None or len(vb) < n:
            cap = max(n, 2 * len(vb) if vb is not None else 0)
            grown = np.zeros((cap, _MAX_DEVICE_BYTES), dtype=np.uint8)
            grown_l = np.zeros(cap, dtype=np.int32)
            if vb is not None:
                grown[: len(vb)] = vb
                grown_l[: len(vb)] = self._vl_cache
            self._vb_cache, self._vl_cache = grown, grown_l
            vb = grown
        for i in range(filled, n):
            enc = self._encoded[i]
            if len(enc) <= _MAX_DEVICE_BYTES:
                vb[i, : len(enc)] = np.frombuffer(enc, dtype=np.uint8)
                self._vl_cache[i] = len(enc)
        new_terms = n > filled
        self._vb_filled = n

        if new_terms or self._dev_bytes is None:
            lens = self._vl_cache[:n].astype(np.int64)
            key = np.where(lens > 0, lens, 99)
            order = np.argsort(key, kind="stable")
            # off[L] = first sorted row of length >= L (L in 0..34);
            # off[33] ends the device-eligible rows.
            self._len_off = np.searchsorted(key[order], np.arange(35))
            self._dev_order = order
            self._dev_bytes = self._put(vb[:n][order])
            self._dev_len = self._put(np.where(
                key[order] <= _MAX_DEVICE_BYTES, lens[order],
                0).astype(np.int32))
            self._dev_ids = self._put(order.astype(np.int32))
        totals = np.clip(self.host.term_total.view(), 0,
                         0xFFFFFFFF).astype(np.int64)
        self._dev_total = self._put(totals[self._dev_order])
        self._dev_gen = self._gen

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _region(self, q_len: int) -> tuple[int, int]:
        """Sorted-row region [lo, lo + W) holding exactly the terms
        within tolerance of a query length (W may be 0)."""
        tol = self.tolerance
        lo = int(self._len_off[max(q_len - tol, 1)])
        hi = int(self._len_off[min(q_len + tol, _MAX_DEVICE_BYTES) + 1])
        return lo, hi - lo

    def _pack_queries(self, qs: list[bytes]):
        qb = np.zeros((len(qs), _MAX_DEVICE_BYTES), dtype=np.uint8)
        ql = np.zeros(len(qs), dtype=np.int32)
        for i, q in enumerate(qs):
            qb[i, : len(q)] = np.frombuffer(q, dtype=np.uint8)
            ql[i] = len(q)
        return self._put(qb), self._put(ql)

    # -- host path ---------------------------------------------------------

    def _host_best(self, q: bytes, indexes) -> tuple[Optional[int], int]:
        """(best_term_id, best_total) over the given candidate rows."""
        tol = self.tolerance
        totals = self.host.term_total.view()
        best_id = None
        best_total = 0
        for idx in indexes:
            total = int(totals[idx])
            if total <= 0:
                continue  # no live occurrences: never selected
            if best_id is not None and (
                    total < best_total or
                    (total == best_total and idx + 1 > best_id)):
                continue  # cannot beat the current pick; skip the DP
            if levdist(q, self._encoded[idx], cutoff=tol) <= tol:
                best_id = int(idx) + 1
                best_total = total
        return best_id, best_total

    # -- public ------------------------------------------------------------

    def prefetch(self, values) -> None:
        """Resolve many tokens with batched device sweeps and ONE
        device->host copy; results land in a per-generation memo
        consulted by lookup().  Tokens outside the device snapshot's
        limits resolve through the host path as usual."""
        self._refresh()
        memo = self._memo()
        pending = []
        for value in values:
            if value in memo:
                continue
            q = value.encode("utf-8")
            if (len(self._encoded) >= _DEVICE_THRESHOLD
                    and 0 < len(q) <= _MAX_DEVICE_BYTES
                    and len(q) < _MAX_DEVICE_BYTES - self.tolerance + 1):
                pending.append((value, q))
            else:
                memo[value] = self.lookup(value)
        if not pending:
            return
        from .ops.levenshtein import fuzzy_best_region
        from .utils.trace import phase
        with phase("fuzzy.refresh_device"):
            self._refresh_device()
        chunk = _CHUNK_CUDA if self.device.type == "cuda" else _CHUNK_CPU
        # Group misses by their length band's sorted-row region: each
        # group sweeps only rows within tolerance of its query length.
        regions: dict[tuple[int, int], list] = {}
        for value, q in pending:
            regions.setdefault(self._region(len(q)), []).append(
                (value, q))
        parts: list = []
        idxs: list = []
        with phase("fuzzy.sweep"):
            for (lo, w), group in regions.items():
                if w == 0:           # no term within tolerance
                    for value, _ in group:
                        memo[value] = None
                    continue
                for at in range(0, len(group), chunk):
                    part = group[at: at + chunk]
                    qb, ql = self._pack_queries([q for _, q in part])
                    idxs.append(fuzzy_best_region(
                        self._dev_bytes, self._dev_len, self._dev_total,
                        self._dev_ids, qb, ql, lo, self.tolerance, W=w))
                    parts.append(part)
            if not idxs:
                return
            best = torch.cat(idxs).cpu().numpy()
        at = 0
        for part in parts:
            for value, _ in part:
                b = int(best[at])
                memo[value] = b + 1 if b >= 0 else None
                at += 1

    def _memo(self) -> dict:
        if self._memo_cache is None or self._memo_gen != self._gen:
            self._memo_cache = {}
            self._memo_gen = self._gen
        return self._memo_cache

    def lookup(self, value: str) -> Optional[int]:
        """Best term within tolerance, or None (idxterm_fuzzysearch)."""
        self._refresh()
        if not self._encoded:
            return None
        memo = self._memo()
        if value in memo:
            return memo[value]
        q = value.encode("utf-8")
        tol = self.tolerance

        if (len(self._encoded) >= _DEVICE_THRESHOLD
                and len(q) <= _MAX_DEVICE_BYTES):
            from .ops.levenshtein import fuzzy_best_region
            self._refresh_device()
            lo, w = self._region(len(q))
            best_idx = -1
            if w:
                qb, ql = self._pack_queries([q])
                best_idx = int(fuzzy_best_region(
                    self._dev_bytes, self._dev_len, self._dev_total,
                    self._dev_ids, qb, ql, lo, tol, W=w)[0])
            best_id = best_idx + 1 if best_idx >= 0 else None
            best_total = int(self.host.term_total.view()[best_idx]) \
                if best_idx >= 0 else 0
            # Terms wider than the device snapshot can only be within
            # tolerance of queries >= 31 bytes: host-scan just those.
            if len(q) >= _MAX_DEVICE_BYTES - tol + 1:
                long_rows = np.nonzero(
                    self._lengths > _MAX_DEVICE_BYTES)[0]
                if len(long_rows):
                    h_id, h_total = self._host_best(q, long_rows)
                    if h_id is not None and (
                            best_id is None or h_total > best_total or
                            (h_total == best_total and h_id < best_id)):
                        best_id = h_id
            memo[value] = best_id
            return best_id

        near = np.nonzero(np.abs(self._lengths - len(q)) <= tol)[0]
        best_id, _total = self._host_best(q, near)
        memo[value] = best_id
        return best_id
