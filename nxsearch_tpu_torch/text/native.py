"""ctypes bridge to the native text pipeline (native/nxstext.cpp).

The native library implements the ASCII subset of the default filter
pipeline (UAX#29 word break + lowercase + stopwords + Porter2) with
per-document aggregation; any non-ASCII text is rejected by the
library (-1) and handled by the Python implementation, so results are
identical on every input.  The library is built on demand with ``make``
(g++); if unavailable, everything silently runs in Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_FLAG_NORMALIZER = 1
_FLAG_STOPWORDS = 2
_FLAG_STEMMER = 4

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
# NXS_NATIVE_LIB overrides the library path (e.g. the sanitizer build,
# native/libnxstext_san.so, run under LD_PRELOAD'ed libasan).
_LIB_PATH = os.environ.get(
    "NXS_NATIVE_LIB", os.path.join(_NATIVE_DIR, "libnxstext.so"))

_lib = None
_lib_lock = threading.Lock()
_lib_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, "-s"],
                    check=True, capture_output=True, timeout=120)
            except Exception:
                _lib_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _lib_failed = True
            return None
        lib.nxs_text_ctx_new.restype = ctypes.c_void_p
        lib.nxs_text_ctx_new.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_long]
        lib.nxs_text_ctx_free.argtypes = [ctypes.c_void_p]
        lib.nxs_text_process.restype = ctypes.c_long
        lib.nxs_text_process.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
        lib.nxs_text_filter_token.restype = ctypes.c_long
        lib.nxs_text_filter_token.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long]
        lib.nxs_text_filter_tokens.restype = ctypes.c_long
        lib.nxs_text_filter_tokens.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long), ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_byte)]
        lib.nxs_text_process_batch.restype = ctypes.c_long
        lib.nxs_text_process_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long), ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_uint), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_uint)]
        _lib = lib
        return _lib


class NativeTextPipeline:
    """Native fast path for one filter-pipeline configuration.

    ``flags`` selects which of normalizer/stopwords/stemmer are active
    (they always run in the reference's default order); ``stopwords``
    is the active stopword set (empty disables the check).
    """

    def __init__(self, normalizer: bool, stopwords_set, stemmer: bool):
        self._ctx = None
        lib = _load()
        if lib is None:
            return
        flags = ((_FLAG_NORMALIZER if normalizer else 0)
                 | (_FLAG_STOPWORDS if stopwords_set else 0)
                 | (_FLAG_STEMMER if stemmer else 0))
        blob = "\n".join(sorted(stopwords_set)).encode("utf-8") \
            if stopwords_set else b""
        if stopwords_set and blob.decode("utf-8", "ignore") != blob.decode(
                "utf-8"):  # pragma: no cover - non-utf8 impossible here
            return
        if any(ord(c) >= 0x80 for w in (stopwords_set or ()) for c in w):
            # Non-ASCII stopwords cannot match ASCII-only native tokens
            # anyway, but normalization differences are conceivable:
            # stay on the Python path.
            return
        self._lib = lib
        self._ctx = lib.nxs_text_ctx_new(flags, blob, len(blob))
        self._buf = ctypes.create_string_buffer(1 << 20)
        self._counts = (ctypes.c_int * (1 << 16))()
        self._seen = ctypes.c_long(0)
        self._nbytes = ctypes.c_long(0)
        self._lock = threading.Lock()

    @property
    def available(self) -> bool:
        return self._ctx is not None

    def process(self, text: str) -> Optional[tuple[list[str], list[int], int]]:
        """(unique_tokens, counts, seen) or None to use the Python path."""
        if self._ctx is None or not text.isascii():
            return None
        raw = text.encode("ascii")
        with self._lock:
            while True:
                n = self._lib.nxs_text_process(
                    self._ctx, raw, len(raw),
                    self._buf, len(self._buf),
                    self._counts, len(self._counts),
                    ctypes.byref(self._seen), ctypes.byref(self._nbytes))
                if n == -2:  # grow buffers and retry
                    self._buf = ctypes.create_string_buffer(
                        len(self._buf) * 4)
                    self._counts = (ctypes.c_int * (len(self._counts) * 4))()
                    continue
                break
            if n < 0:  # pragma: no cover - ASCII checked above
                return None
            if n == 0:
                return [], [], self._seen.value
            # string_at copies only the written bytes; Array.raw would
            # materialize the WHOLE capacity per call (~100 us for the
            # 1 MB buffer -- measured dominating query preparation).
            values = ctypes.string_at(
                self._buf, self._nbytes.value - 1) \
                .decode("ascii").split("\0")
            return values, list(self._counts[:n]), self._seen.value

    def process_batch(self, texts: list[str]):
        """Tokenize a whole document batch in one native call.

        Returns (table_values, pairs, doc_ptr, seen) where
        ``table_values`` is the batch's unique filtered tokens in
        first-seen order, ``pairs`` is uint32[n, 2] of
        (table_index, count) rows, ``doc_ptr`` int64[n_docs+1] bounds
        each document's rows, and ``seen`` uint32[n_docs] is its
        surviving token count -- 0xFFFFFFFF marks a non-ASCII document
        the caller must run through the Python pipeline.  Returns None
        when the native library is unavailable.
        """
        import numpy as np

        if self._ctx is None:
            return None
        offs = [0]
        parts = []
        for text in texts:
            raw = text.encode("utf-8")
            parts.append(raw)
            offs.append(offs[-1] + len(raw))
        blob = b"".join(parts)
        doc_off = (ctypes.c_long * len(offs))(*offs)
        n_docs = len(texts)

        table_cap = max(1 << 20, len(blob) + 1024)
        pairs_cap = max(1 << 16, len(blob) // 2 + 1024)
        doc_ptr = (ctypes.c_long * (n_docs + 1))()
        seen = (ctypes.c_uint * max(n_docs, 1))()
        table_n = ctypes.c_long(0)
        table_bytes = ctypes.c_long(0)
        with self._lock:
            while True:
                table_buf = ctypes.create_string_buffer(table_cap)
                pairs_buf = (ctypes.c_uint * pairs_cap)()
                rc = self._lib.nxs_text_process_batch(
                    self._ctx, blob, doc_off, n_docs,
                    table_buf, table_cap,
                    ctypes.byref(table_n), ctypes.byref(table_bytes),
                    pairs_buf, pairs_cap, doc_ptr, seen)
                if rc == -2:
                    table_cap *= 4
                    pairs_cap *= 4
                    continue
                break
            n_table = table_n.value
            values = (ctypes.string_at(table_buf, table_bytes.value - 1)
                      .decode("ascii").split("\0") if n_table else [])
            doc_ptr_np = np.frombuffer(doc_ptr, dtype=np.int64).copy()
            n_pairs = int(doc_ptr_np[-1])
            pairs = np.frombuffer(pairs_buf, dtype=np.uint32,
                                  count=2 * n_pairs).reshape(-1, 2).copy()
            seen_np = np.frombuffer(seen, dtype=np.uint32,
                                    count=n_docs).copy()
        return values, pairs, doc_ptr_np, seen_np

    def filter_tokens(self, values: list[str]):
        """Batch filter_token: the whole list in ONE native call (the
        per-call ctypes overhead, ~8 us, dominates single-token work).
        Returns a list aligned with ``values`` of str (mutation), None
        (discard) or NotImplemented (non-ASCII: caller falls back to
        the Python pipeline); or None when the library is unavailable."""
        if self._ctx is None:
            return None
        offs = [0]
        parts = []
        for v in values:
            raw = v.encode("utf-8")
            parts.append(raw)
            offs.append(offs[-1] + len(raw))
        blob = b"".join(parts)
        n = len(values)
        in_offs = (ctypes.c_long * (n + 1))(*offs)
        out_offs = (ctypes.c_long * (n + 1))()
        status = (ctypes.c_byte * max(n, 1))()
        out_cap = len(blob) + 1024
        with self._lock:
            while True:
                out_buf = ctypes.create_string_buffer(out_cap)
                rc = self._lib.nxs_text_filter_tokens(
                    self._ctx, blob, in_offs, n, out_buf, out_cap,
                    out_offs, status)
                if rc == -2:  # pragma: no cover - chain never grows
                    out_cap *= 4
                    continue
                break
            data = ctypes.string_at(out_buf, out_offs[n])
        results: list = []
        for t in range(n):
            s = status[t]
            if s == 1:
                results.append(data[out_offs[t]: out_offs[t + 1]]
                               .decode("ascii"))
            elif s == 0:
                results.append(None)
            else:
                results.append(NotImplemented)
        return results

    def filter_token(self, value: str):
        """Run the chain on one whole token (no segmentation) -- the
        query-preparation path.  Returns the filtered token, None for
        a discard, or NotImplemented to use the Python pipeline."""
        if self._ctx is None or not value.isascii():
            return NotImplemented
        raw = value.encode("ascii")
        with self._lock:
            n = self._lib.nxs_text_filter_token(
                self._ctx, raw, len(raw), self._buf, len(self._buf))
            if n == 0:
                return None
            if n < 0:  # pragma: no cover - ascii + huge-buffer guarded
                return NotImplemented
            return ctypes.string_at(self._buf, n).decode("ascii")

    def close(self) -> None:
        if self._ctx is not None:
            self._lib.nxs_text_ctx_free(self._ctx)
            self._ctx = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
