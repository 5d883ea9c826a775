"""Minimal ctypes binding to the system ICU shared libraries.

PyICU is not installable in this offline image, but the runtime
libraries (libicuuc / libicui18n) are present -- this shim exposes
exactly the three ICU facilities the reference engine uses, so the
A/B parity sweeps (tests/test_icu_parity.py, tokenizer A/B) execute
against REAL ICU instead of being skipped:

- the transliterator ``NFKD; [:Nonspacing Mark:] Remove; Latin-ASCII;
  NFKC`` (utrans_*; reference: src/utils/utf8.c:30-31,268),
- the NFKC_Casefold normalizer (unorm2_*; utf8.c:69),
- UBRK_WORD segmentation with rule-status filtering (ubrk_*;
  reference: src/core/tokenizer.c:265-287).

ICU's C symbols carry a version suffix (e.g. utrans_openU_72); the
loader probes the installed major versions.

Runtime role (r4): ``icu_word_tokens`` doubles as the engine's
dictionary word-break provider for CJK/Thai text -- ICU UBRK_WORD
segments Japanese/Chinese/Thai via dictionaries
(src/core/tokenizer.c:265), which pure UAX#29 rules cannot (they
yield one word per ideograph).  The tokenizer routes texts containing
dictionary-segmented scripts here when the system ICU is present
(text/tokenizer.py); everything else keeps the Python UAX#29 path.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

UTRANS_FORWARD = 0
UBRK_WORD = 1
UBRK_DONE = -1
UBRK_WORD_NONE_LIMIT = 100      # rule statuses below this are "none"


def _load() -> Optional[tuple]:
    for ver in range(78, 58, -1):
        try:
            uc = ctypes.CDLL(f"libicuuc.so.{ver}")
            i18n = ctypes.CDLL(f"libicui18n.so.{ver}")
            # Probe a suffixed symbol to confirm the version tag.
            getattr(uc, f"unorm2_getNFKCCasefoldInstance_{ver}")
            return uc, i18n, ver
        except OSError:
            continue
        except AttributeError:
            continue
    return None


_LIBS = _load()


def available() -> bool:
    return _LIBS is not None


def _sym(lib, name):
    return getattr(lib, f"{name}_{_LIBS[2]}")


def _u16(s: str) -> ctypes.Array:
    data = s.encode("utf-16-le")
    n = len(data) // 2
    buf = (ctypes.c_uint16 * (n + 1))()
    ctypes.memmove(buf, data, len(data))
    return buf, n


class IcuTransliterator:
    """utrans_openU + utrans_transUChars over a compound transform."""

    def __init__(self, transform_id: str):
        uc, i18n, _ = _LIBS
        openu = _sym(i18n, "utrans_openU")
        openu.restype = ctypes.c_void_p
        tid, tid_len = _u16(transform_id)
        status = ctypes.c_int(0)
        self._trans = openu(tid, tid_len, UTRANS_FORWARD, None, 0,
                            None, ctypes.byref(status))
        if status.value > 0 or not self._trans:
            raise RuntimeError(f"utrans_openU failed: {status.value}")
        self._trans_fn = _sym(i18n, "utrans_transUChars")

    def transliterate(self, s: str) -> str:
        src, n = _u16(s)
        cap = 4 * n + 64
        buf = (ctypes.c_uint16 * cap)()
        ctypes.memmove(buf, src, n * 2)
        text_len = ctypes.c_int(n)
        limit = ctypes.c_int(n)
        status = ctypes.c_int(0)
        self._trans_fn(ctypes.c_void_p(self._trans), buf,
                       ctypes.byref(text_len), cap, 0,
                       ctypes.byref(limit), ctypes.byref(status))
        if status.value > 0:
            raise RuntimeError(f"utrans_transUChars: {status.value}")
        raw = ctypes.string_at(buf, text_len.value * 2)
        return raw.decode("utf-16-le")


class IcuNfkcCasefold:
    """unorm2_getNFKCCasefoldInstance + unorm2_normalize."""

    def __init__(self):
        uc, _, _ = _LIBS
        get = _sym(uc, "unorm2_getNFKCCasefoldInstance")
        get.restype = ctypes.c_void_p
        status = ctypes.c_int(0)
        self._norm = get(ctypes.byref(status))
        if status.value > 0 or not self._norm:
            raise RuntimeError(f"getNFKCCasefold: {status.value}")
        self._norm_fn = _sym(uc, "unorm2_normalize")

    def normalize(self, s: str) -> str:
        src, n = _u16(s)
        cap = 4 * n + 64
        buf = (ctypes.c_uint16 * cap)()
        status = ctypes.c_int(0)
        out_len = self._norm_fn(ctypes.c_void_p(self._norm), src, n,
                                buf, cap, ctypes.byref(status))
        if status.value > 0:
            raise RuntimeError(f"unorm2_normalize: {status.value}")
        raw = ctypes.string_at(buf, out_len * 2)
        return raw.decode("utf-16-le")


def icu_word_tokens(text: str, locale: bytes = b"") -> list[str]:
    """UBRK_WORD segmentation with the reference's filter: segments
    whose rule status is UBRK_WORD_NONE are dropped
    (src/core/tokenizer.c:273-287)."""
    uc, _, _ = _LIBS
    ubrk_open = _sym(uc, "ubrk_open")
    ubrk_open.restype = ctypes.c_void_p
    ubrk_first = _sym(uc, "ubrk_first")
    ubrk_next = _sym(uc, "ubrk_next")
    ubrk_status = _sym(uc, "ubrk_getRuleStatus")
    ubrk_close = _sym(uc, "ubrk_close")

    src, n = _u16(text)
    status = ctypes.c_int(0)
    it = ubrk_open(UBRK_WORD, locale, src, n, ctypes.byref(status))
    if status.value > 0 or not it:
        raise RuntimeError(f"ubrk_open: {status.value}")
    try:
        units = text.encode("utf-16-le")
        out = []
        start = ubrk_first(ctypes.c_void_p(it))
        while True:
            end = ubrk_next(ctypes.c_void_p(it))
            if end == UBRK_DONE:
                break
            if ubrk_status(ctypes.c_void_p(it)) != 0:  # != WORD_NONE
                out.append(units[start * 2: end * 2]
                           .decode("utf-16-le"))
            start = end
        return out
    finally:
        ubrk_close(ctypes.c_void_p(it))
