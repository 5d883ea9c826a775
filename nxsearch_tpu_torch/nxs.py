"""Public engine API: instance + index lifecycle and operations.

Port of nxsearch_tpu/nxs.py onto PyTorch.  Mirrors the reference's
public C API surface (src/core/nxs.h:26-101, src/core/nxs.c): ``Nxs``
is the nxs_t instance (basedir resolution, filter registry,
open-index map); ``Index`` is nxs_index_t (add/remove/search over the
journals + device snapshot).  The journals, the filter pipeline and
the locking are the reference's host machinery; the snapshot and the
executors run on one explicit ``torch.device``, or doc-sharded over a
mesh of them (``mesh=``, parallel.make_mesh).
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional

import torch

from .errors import ErrorCode, NxsError
from .index.device import DeviceIndex
from .index.hostindex import HostIndex
from .ops.scoring import ALGO_BM25, ALGO_TFIDF
from .params import (DEFAULT_FILTERS, DEFAULT_LANGUAGE, DEFAULT_RANKING_ALGO,
                     Params)
from .resp import Response
from .search import get_search_params, search, search_many
from .text.filters import FilterPipeline, FilterRegistry
from .text.tokenizer import TOKENSET_STAGE, tokenize
from .utils.rwlock import RWLock
from .utils.trace import collector_hold
from .utils.validate import str_isalnumdu

_ALGO_IDS = {"BM25": ALGO_BM25, "TF-IDF": ALGO_TFIDF}


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` by default.  A CUDA device without
    a card raises -- the engine never drops to the CPU silently; pass
    ``device="cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available "
            "(pass device='cpu' to run on the CPU)")
    return dev


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class Index:
    """One open index (nxs_index_t equivalent).  With a ``mesh`` its
    snapshot is doc-sharded over the mesh's devices and ``device`` is
    the mesh's first (the merge device, where fuzzy resolution and the
    merged results live)."""

    def __init__(self, nxs: "Nxs", name: str, params: Params,
                 device: torch.device, mesh=None):
        self.nxs = nxs
        self.name = name
        self.params = params
        algo_name = params.get_str("algo") or DEFAULT_RANKING_ALGO
        if algo_name not in _ALGO_IDS:
            raise NxsError(ErrorCode.INVALID,
                           f"invalid algorithm `{algo_name}'")
        self.algo = _ALGO_IDS[algo_name]
        self.pipeline = FilterPipeline(nxs.filters, params)
        try:
            self.host = HostIndex(os.path.join(nxs.basedir, "data", name))
        except Exception:
            self.pipeline.close()
            raise
        if mesh is not None:
            from .parallel.sharded import ShardedDeviceIndex
            self.dev = ShardedDeviceIndex(self.host, mesh)
        else:
            self.dev = DeviceIndex(self.host, device)
        self._fuzzy = None  # lazily-built fuzzy matcher
        # Reader-writer semantics across threads sharing this handle:
        # journal-tail consumption, snapshot refresh, and mutation are
        # exclusive, while query EXECUTION is shared.
        self._rw = RWLock()
        # Fuzzy resolution mutates shared memo/snapshot state; guard
        # it separately so concurrent readers only serialize there.
        self._fuzzy_guard = threading.RLock()

    # -- operations (nxs.c:490-566) ---------------------------------------

    def add(self, doc_id: int, text: str,
            params: Optional[Params] = None) -> None:
        """Index a document (nxs_index_add)."""
        if doc_id == 0:
            raise NxsError(ErrorCode.INVALID,
                           "document ID must be non-zero")
        with self._rw.writing():
            if self.host.doc_lookup(doc_id) is not None:
                raise NxsError(ErrorCode.EXISTS,
                               f"document {doc_id} is already indexed")
            tokens = tokenize(self.pipeline, text)
            if tokens.count == 0:
                raise NxsError(
                    ErrorCode.MISSING,
                    "the text is empty or no meaningful tokens found")
            tokens.resolve(self.host.term_lookup, TOKENSET_STAGE)
            self.host.terms_add(tokens)
            self.host.dtmap_add(doc_id, tokens)

    def add_many(self, docs: list[tuple[int, str]],
                 params: Optional[Params] = None) -> None:
        """Bulk document add: one journal lock round-trip per batch.

        Same per-document semantics as add() (non-zero unique IDs,
        non-empty token sets), but the batch is atomic and the journal
        appends are amortized -- the high-throughput ingest path (no
        reference equivalent; the C engine locks per document).

        With the native pipeline, the whole batch tokenizes in one C++
        call and flows to the journals as numpy arrays; non-ASCII
        documents detour through the Python pipeline and are merged
        back so the batch stays atomic.
        """
        import numpy as np

        # Accept any iterable: the ID validation below would otherwise
        # silently exhaust a generator before the locked add.
        if not isinstance(docs, (list, tuple)):
            docs = list(docs)
        if not docs:
            return
        for doc_id, _ in docs:
            if doc_id == 0:
                raise NxsError(ErrorCode.INVALID,
                               "document ID must be non-zero")

        self._rw.write_acquire()
        try:
            return self._add_many_locked(docs)
        finally:
            self._rw.write_release()

    def _add_many_locked(self, docs):
        import numpy as np

        native = self.pipeline.native
        result = native.process_batch([t for _, t in docs]) \
            if native is not None else None
        if result is None:
            items = []
            for doc_id, text in docs:
                tokens = tokenize(self.pipeline, text)
                if tokens.count == 0:
                    raise NxsError(
                        ErrorCode.MISSING,
                        f"document {doc_id}: the text is empty or no "
                        "meaningful tokens found")
                items.append((doc_id, tokens))
            self.host.add_bulk(items)
            return

        values, pairs, doc_ptr, seen = result
        bad = np.nonzero(seen == 0xFFFFFFFF)[0]
        if len(bad):
            # Non-ASCII documents: Python pipeline, splice into the
            # batch table/pairs.
            table_index = {v: i for i, v in enumerate(values)}
            segments = [pairs[doc_ptr[d]: doc_ptr[d + 1]]
                        for d in range(len(docs))]
            for d in bad:
                tokens = tokenize(self.pipeline, docs[d][1])
                rows = np.zeros((len(tokens.tokens), 2), dtype=np.uint32)
                for r, token in enumerate(tokens.tokens):
                    ix = table_index.get(token.value)
                    if ix is None:
                        ix = len(values)
                        values.append(token.value)
                        table_index[token.value] = ix
                    rows[r] = (ix, token.count)
                segments[d] = rows
                seen[d] = tokens.seen
            pairs = np.concatenate(segments) if segments else pairs
            doc_ptr = np.zeros(len(docs) + 1, dtype=np.int64)
            np.cumsum([len(s) for s in segments], out=doc_ptr[1:])

        empty = np.nonzero(seen == 0)[0]
        if len(empty):
            raise NxsError(
                ErrorCode.MISSING,
                f"document {docs[int(empty[0])][0]}: the text is empty "
                "or no meaningful tokens found")
        self.host.add_bulk_arrays(
            np.asarray([d for d, _ in docs], dtype=np.int64),
            values, pairs, doc_ptr, seen)

    def remove(self, doc_id: int) -> None:
        """Remove a document (nxs_index_remove -> tombstone)."""
        with self._rw.writing():
            self.host.dtmap_remove(doc_id)

    def _read_synced(self):
        """Acquire the read lock with the index up to date.

        Fast path: nothing pending in the journals and the snapshot is
        current -- take the shared lock directly, so concurrent
        readers execute in parallel.  Otherwise upgrade to exclusive,
        consume the journal tails (search.c:309-310) and refresh the
        device snapshot, then downgrade atomically."""
        while True:
            self._rw.read_acquire()
            if (not self.host.has_pending()
                    and self.dev.generation == self.host.generation):
                return
            self._rw.read_release()
            self._rw.write_acquire()
            try:
                self.host.sync()
                self.dev.refresh()
            except BaseException:
                self._rw.write_release()
                raise
            self._rw.downgrade()
            return

    # The search entry points hold automatic cyclic collection off
    # around the search itself (utils/trace.collector_hold), after
    # _read_synced: a journal sync or snapshot build runs with the
    # collector as the application left it.

    def search(self, query: str, params: Optional[Params] = None) -> Response:
        """Search the index (nxs_index_search)."""
        sp = get_search_params(self.algo, params)
        self._read_synced()
        try:
            with collector_hold():
                fuzzy = self._fuzzy_lookup if sp.fuzzymatch else None
                return search(self.dev, self.pipeline, query, sp,
                              fuzzy_lookup=fuzzy)
        finally:
            self._rw.read_release()

    def search_many(self, queries: list[str],
                    params: Optional[Params] = None) -> list[Response]:
        """Batched search: many queries, one device dispatch per
        signature group.  Same results as per-query search; this is
        the high-QPS serving path (no reference equivalent -- the C
        engine is one-query-per-call)."""
        sp = get_search_params(self.algo, params)
        self._read_synced()
        try:
            with collector_hold():
                fuzzy = self._fuzzy_lookup if sp.fuzzymatch else None
                prefetch = self._fuzzy_prefetch if sp.fuzzymatch else None
                return search_many(self.dev, self.pipeline, queries, sp,
                                   fuzzy_lookup=fuzzy,
                                   fuzzy_prefetch=prefetch)
        finally:
            self._rw.read_release()

    def search_pipelined(self, batches: list[list[str]],
                         params: Optional[Params] = None
                         ) -> list[list[Response]]:
        """Streaming batched search: each batch's host prep and
        dispatch overlap the previous batch's device execution
        (search.search_many_pipelined).  The steady-state serving
        shape: a continuous query stream in fixed-size batches."""
        from .search import search_many_pipelined
        sp = get_search_params(self.algo, params)
        self._read_synced()
        try:
            with collector_hold():
                fuzzy = self._fuzzy_lookup if sp.fuzzymatch else None
                prefetch = self._fuzzy_prefetch if sp.fuzzymatch else None
                return search_many_pipelined(self.dev, self.pipeline,
                                             batches, sp,
                                             fuzzy_lookup=fuzzy,
                                             fuzzy_prefetch=prefetch)
        finally:
            self._rw.read_release()

    def prewarm(self, params: Optional[Params] = None, **_kw) -> int:
        """No-op: eager PyTorch has no per-shape compile to warm (the
        kernel library builds on its first launch).  Returns the number
        of warmup queries executed: 0."""
        return 0

    def stats(self) -> dict:
        """Live index statistics (observability; counts mirror the
        reference's idx_get_doc_count/token_count internals)."""
        with self._rw.writing():
            self.host.sync()
        return {
            "name": self.name,
            "doc_count": self.host.doc_count,
            "term_count": self.host.term_count,
            "token_count": self.host.token_count,
            "generation": self.host.generation,
            "algo": self.params.get_str("algo"),
            "filters": list(self.pipeline.names),
        }

    def _fuzzy_lookup(self, value: str) -> Optional[int]:
        with self._fuzzy_guard:
            return self._fuzzy_matcher().lookup(value)

    def _fuzzy_prefetch(self, values) -> None:
        with self._fuzzy_guard:
            self._fuzzy_matcher().prefetch(values)

    def _fuzzy_matcher(self):
        from .fuzzy import FuzzyMatcher
        if self._fuzzy is None:
            self._fuzzy = FuzzyMatcher(self.host, self.dev.device)
        return self._fuzzy

    def checkpoint(self) -> bool:
        """Write the fast-open snapshot cache (derived-state only; the
        journals remain the source of truth).  Also written on close."""
        return self.host.save_snapshot()

    def close(self) -> None:
        try:
            self.host.save_snapshot()
        except OSError:  # pragma: no cover - best-effort cache
            pass
        self.pipeline.close()
        self.host.close()


class Nxs:
    """Engine instance (nxs_t equivalent, nxs_open/nxs_close).

    ``basedir`` defaults to the NXS_BASEDIR environment variable
    (nxs.c:95-105); a ``data/`` subdirectory holds the indexes.
    ``device`` is the torch device every index of this instance lives
    on (default ``cuda``; see resolve_device).  ``mesh``, a list of
    devices (parallel.make_mesh), shards every index over them instead;
    ``device`` is then the mesh's first, and a ``device`` that names
    another raises.
    """

    def __init__(self, basedir: Optional[str] = None, device=None,
                 mesh=None):
        basedir = basedir or os.environ.get("NXS_BASEDIR")
        if not basedir:
            raise NxsError(ErrorCode.INVALID,
                           "base directory not specified")
        if mesh is not None:
            from .parallel.sharded import make_mesh
            mesh = make_mesh(mesh)
            if device is not None and not _same_device(
                    resolve_device(device), mesh[0]):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"first device {mesh[0]}")
            self.device = mesh[0]
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.basedir = basedir
        os.makedirs(os.path.join(basedir, "data"), exist_ok=True)
        self.filters = FilterRegistry(basedir)
        self._indexes: dict[str, Index] = {}

    # -- index lifecycle (nxs.c:219-487) ----------------------------------

    def _index_dir(self, name: str) -> str:
        if not name or not str_isalnumdu(name):
            raise NxsError(ErrorCode.INVALID, f"invalid index name `{name}'")
        return os.path.join(self.basedir, "data", name)

    def index_create(self, name: str,
                     params: Optional[Params] = None) -> Index:
        """Create a new index with params.db defaults (nxs.c:219-300)."""
        idxdir = self._index_dir(name)
        if os.path.exists(idxdir):
            raise NxsError(ErrorCode.EXISTS, f"index `{name}' already exists")
        p = params.copy() if params else Params()
        if p.get_strlist("filters") is None:
            p.set_strlist("filters", DEFAULT_FILTERS)
        if p.get_str("lang") is None:
            p.set_str("lang", DEFAULT_LANGUAGE)
        if p.get_str("algo") is None:
            p.set_str("algo", DEFAULT_RANKING_ALGO)
        os.makedirs(idxdir)
        p.serialize(os.path.join(idxdir, "params.db"))
        return self.index_open(name)

    def index_open(self, name: str) -> Index:
        """Open an existing index (nxs.c:374-467)."""
        idxdir = self._index_dir(name)
        if name in self._indexes:
            raise NxsError(ErrorCode.EXISTS, f"index `{name}' is already open")
        params_path = os.path.join(idxdir, "params.db")
        if not os.path.isfile(params_path):
            raise NxsError(ErrorCode.MISSING, f"index `{name}' does not exist")
        params = Params.fromfile(params_path)
        idx = Index(self, name, params, self.device, mesh=self.mesh)
        self._indexes[name] = idx
        return idx

    def index_get(self, name: str) -> Index:
        """Open-or-get, the service layer's LRU-miss path."""
        idx = self._indexes.get(name)
        return idx if idx is not None else self.index_open(name)

    def index_close(self, idx: Index) -> None:
        self._indexes.pop(idx.name, None)
        idx.close()

    def index_destroy(self, name: str) -> None:
        """Destroy an index and its files (nxs_index_destroy)."""
        idxdir = self._index_dir(name)
        idx = self._indexes.pop(name, None)
        if idx is not None:
            idx.close()
        if not os.path.isdir(idxdir):
            raise NxsError(ErrorCode.MISSING, f"index `{name}' does not exist")
        shutil.rmtree(idxdir)

    def close(self) -> None:
        for idx in list(self._indexes.values()):
            idx.close()
        self._indexes.clear()
        self.filters.close()

