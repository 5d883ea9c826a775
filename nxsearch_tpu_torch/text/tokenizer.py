"""Tokenizer: segmentation + filter pipeline + token set.

Mirrors src/core/tokenizer.c: the text is segmented with UAX#29 word
breaking (the reference uses ICU UBRK_WORD), each word runs through the
filter pipeline, and surviving tokens are collected into a TokenSet --
an insertion-ordered set of unique tokens with per-token counts and a
``seen`` total (the document length in tokens, including duplicates,
which feeds BM25's dl).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .filters import FilterPipeline
from .wordbreak import words

# Dictionary-segmented scripts: ICU UBRK_WORD breaks these via
# dictionaries (CJK ideographs, Kana, Thai, Lao, Khmer, Myanmar --
# src/core/tokenizer.c:265); pure UAX#29 rules cannot (one word per
# ideograph).  Texts containing them route through the system ICU
# binding when present (NXS_ICU_BREAK=0 forces the Python path).
import os as _os
import re as _re

_DICT_SCRIPTS = _re.compile(
    "[฀-໿က-႟ក-៿぀-ヿ"
    "㐀-䶿一-鿿豈-﫿]")
_ICU_BREAK = _os.environ.get("NXS_ICU_BREAK", "1") == "1"
_icu_words = None          # resolved lazily: False = unavailable


def _dictionary_words(text: str):
    """ICU word-break for dictionary-script text, or None to use the
    Python UAX#29 segmenter (ICU absent, disabled, or not needed)."""
    global _icu_words
    if not _ICU_BREAK or _DICT_SCRIPTS.search(text) is None:
        return None
    if _icu_words is None:
        try:
            from . import icu_ctypes
            _icu_words = icu_ctypes.icu_word_tokens \
                if icu_ctypes.available() else False
        except Exception:      # pragma: no cover - loader hard failure
            _icu_words = False
    return _icu_words(text) if _icu_words else None

# tokenset_resolve() flags (reference: src/core/tokenizer.h:20-22).
TOKENSET_STAGE = 0x01       # unresolved tokens go to the staging list
TOKENSET_TRIM = 0x02        # unresolved tokens are removed
TOKENSET_FUZZYMATCH = 0x04  # fuzzy-search unresolved tokens


@dataclass
class Token:
    """A unique filtered token (token_t equivalent)."""
    value: str
    count: int = 0
    term_id: Optional[int] = None  # resolved in-index term ID


@dataclass
class TokenSet:
    """Unique tokens in insertion order + counts (tokenset_t)."""
    tokens: list[Token] = field(default_factory=list)
    staging: list[Token] = field(default_factory=list)
    _map: dict[str, Token] = field(default_factory=dict)
    seen: int = 0        # total tokens incl. duplicates (=> doc_len)
    data_len: int = 0    # total unique bytes (UTF-8)

    @property
    def count(self) -> int:
        return len(self.tokens)

    @property
    def staged(self) -> int:
        return len(self.staging)

    def add(self, value: str) -> Token:
        """tokenset_add: dedupe + count (tokenizer.c:94-117)."""
        token = self._map.get(value)
        self.seen += 1
        if token is not None:
            token.count += 1
            return token
        token = Token(value=value, count=1)
        self._map[value] = token
        self.tokens.append(token)
        self.data_len += len(value.encode("utf-8"))
        return token

    def resolve(self, lookup, flags: int, fuzzy_lookup=None) -> None:
        """tokenset_resolve: map tokens to term IDs.

        ``lookup(value) -> term_id | None`` resolves a token value;
        ``fuzzy_lookup`` is consulted on miss when TOKENSET_FUZZYMATCH.
        STAGE moves unresolved tokens to the staging list; TRIM drops
        them (tokenizer.c:160-199).
        """
        stage = bool(flags & TOKENSET_STAGE)
        trim = bool(flags & TOKENSET_TRIM)
        fuzzy = bool(flags & TOKENSET_FUZZYMATCH)
        assert not (stage and trim)

        kept: list[Token] = []
        for token in self.tokens:
            term_id = lookup(token.value)
            if term_id is None and fuzzy and fuzzy_lookup is not None:
                term_id = fuzzy_lookup(token.value)
            if term_id is None:
                if stage:
                    self.staging.append(token)
                    continue
                if trim:
                    del self._map[token.value]
                    self.data_len -= len(token.value.encode("utf-8"))
                    self.seen -= token.count
                    continue
                kept.append(token)
            else:
                token.term_id = term_id
                kept.append(token)
        self.tokens = kept

    def moveback(self, token: Token) -> None:
        """tokenset_moveback: staged token is now resolved."""
        self.staging.remove(token)
        self.tokens.append(token)


def tokenize(pipeline: FilterPipeline, text: str) -> TokenSet:
    """Segment + filter + collect (tokenizer.c:234-302).

    ASCII documents under the builtin filter chain run through the
    native pipeline (text/native.py) which returns the aggregated
    token set directly; everything else uses the Python path.  The two
    are behaviorally identical (tests/test_native.py fuzzes parity).
    """
    native = pipeline.native
    if native is not None:
        result = native.process(text)
        if result is not None:
            values, counts, seen = result
            tset = TokenSet()
            for value, count in zip(values, counts):
                token = Token(value=value, count=count)
                tset._map[value] = token
                tset.tokens.append(token)
                tset.data_len += len(value)
            tset.seen = seen
            return tset

    # Dictionary-segmented scripts (CJK/Thai/...) use the system ICU
    # break iterator when present, matching the reference's UBRK_WORD
    # behavior; all other text keeps the Python UAX#29 segmenter.
    segmented = _dictionary_words(text)
    tset = TokenSet()
    for word in (words(text) if segmented is None else segmented):
        value = pipeline.run(word)
        if value is None:
            continue
        tset.add(value)
    return tset


def tokenize_value(pipeline: FilterPipeline, tset: TokenSet,
                   value: str) -> Optional[Token]:
    """Filter a single value and add it to the set (tokenizer.c:205-227).

    Used by query preparation, where each query leaf runs through the
    same pipeline as indexing (query/query.c:103).
    """
    filtered = pipeline.run(value)
    if filtered is None:
        return None
    return tset.add(filtered)
