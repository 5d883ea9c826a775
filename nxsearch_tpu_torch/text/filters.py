"""Token filter framework and builtin filters.

Mirrors the reference filter machinery (src/core/filters.c,
src/core/filters_builtin.c):

- A *registry* of named filters lives on the engine instance
  (``nxs_filter_register``, filters.c:93).
- A per-index *pipeline* is built from the index params' ``filters``
  list (``filter_pipeline_create``, filters.c:125).
- Each filter exposes lifecycle hooks: ``sysinit/sysfini`` (instance
  wide), ``create/destroy`` (per pipeline) and ``filter(ctx, value)``
  which returns the (possibly mutated) token, ``None`` to discard it,
  or raises to signal an error (filters.h:16-45).
- An empty string result means DISCARD (filters.c:208).

Builtins: ``normalizer`` (casefold+NFKC+diacritics), ``stopwords``
(per-language hash set loaded from ``basedir/filters/stopwords/<lang>``)
and ``stemmer`` (Snowball/Porter2).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..errors import ErrorCode, NxsError
from ..params import Params
from . import porter2
from .normalize import normalize_token

# Distinguishes "memoized as discarded (None)" from "not memoized".
_MEMO_MISS = object()
_MEMO_CAP = 1 << 20


@dataclass
class FilterOps:
    """Filter entry: lifecycle hooks (reference: filters.h filter_ops_t)."""
    filter: Callable[[Any, str], Optional[str]]
    sysinit: Optional[Callable[["FilterRegistry"], Any]] = None
    sysfini: Optional[Callable[[Any], None]] = None
    create: Optional[Callable[[Params, Any], Any]] = None
    destroy: Optional[Callable[[Any], None]] = None


class FilterRegistry:
    """Named filter registry bound to an engine instance."""

    def __init__(self, basedir: str):
        self.basedir = basedir
        self._filters: dict[str, FilterOps] = {}
        self._sysctx: dict[str, Any] = {}
        register_builtin_filters(self)

    def register(self, name: str, ops: FilterOps) -> None:
        if name in self._filters:
            raise NxsError(ErrorCode.EXISTS, f"filter `{name}' already exists")
        self._filters[name] = ops
        self._sysctx[name] = ops.sysinit(self) if ops.sysinit else None

    def close(self) -> None:
        for name, ops in self._filters.items():
            if ops.sysfini:
                ops.sysfini(self._sysctx.get(name))
        self._filters.clear()
        self._sysctx.clear()

    def lookup(self, name: str) -> FilterOps:
        ops = self._filters.get(name)
        if ops is None:
            raise NxsError(ErrorCode.MISSING, f"filter `{name}' not found")
        return ops

    def sysctx(self, name: str) -> Any:
        return self._sysctx.get(name)


class FilterPipeline:
    """Per-index filter chain (filter_pipeline_t equivalent)."""

    def __init__(self, registry: FilterRegistry, params: Params):
        names = params.get_strlist("filters") or []
        self._entries: list[tuple[FilterOps, Any]] = []
        self.names = tuple(names)
        try:
            for name in names:
                ops = registry.lookup(name)
                ctx = (ops.create(params, registry.sysctx(name))
                       if ops.create else registry.sysctx(name))
                self._entries.append((ops, ctx))
        except Exception:
            self.close()
            raise
        self.native = self._make_native(params)
        # Token -> result memo for builtin-only chains (normalizer /
        # stopwords / stemmer are pure functions of the token value).
        # Query terms and corpus words repeat heavily; user plugin
        # filters may be stateful, so chains containing them are never
        # memoized.
        builtin = {"normalizer", "stopwords", "stemmer"}
        self._memo: dict[str, Optional[str]] | None = \
            {} if set(self.names) <= builtin else None

    def _make_native(self, params: Params):
        """Native fast path when the chain is a subsequence of the
        builtin normalizer -> stopwords -> stemmer order (ASCII text
        only; the library rejects anything else back to Python)."""
        order = ("normalizer", "stopwords", "stemmer")
        if len(set(self.names)) != len(self.names):
            return None
        if any(n not in order for n in self.names):
            return None
        positions = [order.index(n) for n in self.names]
        if positions != sorted(positions):
            return None
        lang = params.get_str("lang") or "en"
        stopwords_set = None
        for (ops, ctx), name in zip(self._entries, self.names):
            if name == "stopwords":
                stopwords_set = ctx
        if "stemmer" in self.names and lang != "en":
            from . import snowball
            if snowball.get_stemmer(lang) is not None:
                # A Python Snowball stemmer must run for this
                # language: the native path (which only implements
                # Porter2) would silently skip it.
                return None
            # Unknown language: stemming passes through (sb_stemmer_new
            # -> NULL parity), so the native path with the stemmer
            # flag off matches exactly.
            stem = False
        else:
            stem = "stemmer" in self.names
        from .native import NativeTextPipeline
        native = NativeTextPipeline("normalizer" in self.names,
                                    stopwords_set, stem)
        return native if native.available else None

    def prime(self, values) -> None:
        """Pre-fill the memo for a token batch with ONE native call;
        non-ASCII tokens and non-memoizable chains are left to the
        regular run() path (identical results either way)."""
        memo = self._memo
        if memo is None or self.native is None:
            return
        todo = [v for v in dict.fromkeys(values) if v not in memo]
        if not todo:
            return
        out = self.native.filter_tokens(todo)
        if out is None:
            return
        room = _MEMO_CAP - len(memo)
        for v, r in zip(todo, out):
            if r is NotImplemented:
                continue
            if room <= 0:
                break
            memo[v] = r
            room -= 1

    def run(self, value: str) -> Optional[str]:
        """Run the token through the chain.

        Returns the final token value, or None if any filter discarded
        it.  An empty result at any stage is a discard (filters.c:208).
        """
        memo = self._memo
        if memo is not None:
            hit = memo.get(value, _MEMO_MISS)
            if hit is not _MEMO_MISS:
                return hit
        result = self._run_uncached(value)
        if memo is not None and len(memo) < _MEMO_CAP:
            memo[value] = result
        return result

    def _run_uncached(self, value: str) -> Optional[str]:
        if self.native is not None:
            result = self.native.filter_token(value)
            if result is not NotImplemented:
                return result
        for ops, ctx in self._entries:
            value = ops.filter(ctx, value)
            if not value:  # None or empty string => DISCARD
                return None
        return value

    def close(self) -> None:
        for ops, ctx in self._entries:
            if ops.destroy:
                ops.destroy(ctx)
        self._entries.clear()
        if getattr(self, "native", None) is not None:
            self.native.close()
            self.native = None


# ---------------------------------------------------------------------------
# Builtin filters (filters_builtin.c)
# ---------------------------------------------------------------------------

def _normalizer_filter(_ctx: Any, value: str) -> Optional[str]:
    return normalize_token(value)


def _load_stopwords(basedir: str, lang: str) -> Optional[frozenset[str]]:
    path = os.path.join(basedir, "filters", "stopwords", lang)
    try:
        with open(path, "r", encoding="utf-8") as f:
            return frozenset(line.strip() for line in f if line.strip())
    except OSError:
        return None  # no stopwords for this language: not an error


def _stopwords_sysinit(registry: FilterRegistry) -> dict:
    # Lazily-populated per-language map; "en" eagerly like the reference
    # (filters_builtin.c:89,129-145).
    swdicts: dict[str, Optional[frozenset[str]]] = {}
    swdicts["en"] = _load_stopwords(registry.basedir, "en")
    swdicts["__basedir"] = registry.basedir  # type: ignore[assignment]
    return swdicts


def _stopwords_create(params: Params, sysctx: dict) -> Optional[frozenset]:
    lang = params.get_str("lang") or "en"
    if lang not in sysctx:
        sysctx[lang] = _load_stopwords(sysctx["__basedir"], lang)
    return sysctx[lang]


def _stopwords_filter(ctx: Optional[frozenset], value: str) -> Optional[str]:
    if ctx is not None and value in ctx:
        return None
    return value


class _Stemmer:
    """Per-language stemmer context (sb_stemmer_new equivalent,
    filters_builtin.c:206-245): Snowball algorithms from
    text/snowball.py; unknown languages pass through, mirroring
    sb_stemmer_new() failing for them."""

    def __init__(self, lang: str):
        from . import snowball
        fn = snowball.get_stemmer(lang or "en")
        self.fn: Callable[[str], str] = fn if fn is not None \
            else (lambda s: s)


def _stemmer_create(params: Params, _sysctx: Any) -> _Stemmer:
    return _Stemmer(params.get_str("lang") or "en")


def _stemmer_filter(ctx: _Stemmer, value: str) -> Optional[str]:
    return ctx.fn(value)


def register_builtin_filters(registry: FilterRegistry) -> None:
    registry.register("normalizer", FilterOps(filter=_normalizer_filter))
    registry.register("stopwords", FilterOps(
        filter=_stopwords_filter,
        sysinit=_stopwords_sysinit,
        create=_stopwords_create,
    ))
    registry.register("stemmer", FilterOps(
        filter=_stemmer_filter,
        create=_stemmer_create,
    ))
