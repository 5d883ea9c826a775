"""Unicode word-boundary segmentation (UAX #29, default rules).

The reference tokenizer delegates segmentation to ICU's UBRK_WORD break
iterator (src/core/tokenizer.c:234-302) and keeps only segments whose
rule status is not UBRK_WORD_NONE.  This module implements the UAX #29
default word-boundary rules over Python strings directly (code points,
not UTF-16 units -- the produced segments are identical).

Word-break property classes are derived from unicodedata categories
plus the explicit singleton sets from WordBreakProperty.txt that the
rules depend on.  The subset below covers the full rule set WB1-WB16
except the emoji-specific WB3c/WB15/WB16 (regional indicators and
ZWJ-emoji sequences are treated as non-word characters, which matches
what the engine does with them downstream: non-word segments are
dropped).
"""

from __future__ import annotations

import unicodedata
from typing import Iterator

# Word_Break property classes (enum-as-int for speed).
OTHER = 0
CR = 1
LF = 2
NEWLINE = 3
EXTEND = 4
ZWJ = 5
FORMAT = 6
KATAKANA = 7
HEBREW_LETTER = 8
ALETTER = 9
SINGLE_QUOTE = 10
DOUBLE_QUOTE = 11
MIDNUMLET = 12
MIDLETTER = 13
MIDNUM = 14
NUMERIC = 15
EXTENDNUMLET = 16
WSEGSPACE = 17
IDEOGRAPHIC = 18  # not a WB class; tracked so CJK chars count as words

_SKIP = (EXTEND, FORMAT, ZWJ)   # WB4 ignorable classes
_AHLETTER = (ALETTER, HEBREW_LETTER)
_MIDNUMLETQ = (MIDNUMLET, SINGLE_QUOTE)

# Explicit singleton sets from WordBreakProperty.txt (subset sufficient
# for the default rules over real-world text).
_MIDLETTER_SET = {0x003A, 0x00B7, 0x0387, 0x055F, 0x05F4, 0x2027, 0xFE13,
                  0xFE55, 0xFF1A}
_MIDNUMLET_SET = {0x002E, 0x2018, 0x2019, 0x2024, 0xFE52, 0xFF07, 0xFF0E}
_MIDNUM_SET = {0x002C, 0x003B, 0x037E, 0x0589, 0x060C, 0x060D, 0x066C,
               0x07F8, 0x2044, 0xFE10, 0xFE14, 0xFE50, 0xFE54, 0xFF0C,
               0xFF1B}
_NEWLINE_SET = {0x000B, 0x000C, 0x0085, 0x2028, 0x2029}

# Hebrew letters (category Lo within the Hebrew block + presentation forms).
_HEBREW_RANGES = ((0x05D0, 0x05EA), (0x05EF, 0x05F2),
                  (0xFB1D, 0xFB1D), (0xFB1F, 0xFB28), (0xFB2A, 0xFB4F))

# Katakana (including halfwidth and phonetic extensions).
_KATAKANA_RANGES = ((0x3031, 0x3035), (0x309B, 0x309C), (0x30A0, 0x30FA),
                    (0x30FC, 0x30FF), (0x31F0, 0x31FF), (0x32D0, 0x32FE),
                    (0x3300, 0x3357), (0xFF66, 0xFF9D),
                    (0x1B000, 0x1B000), (0x1B164, 0x1B167))

# CJK ideographs + Hiragana: UAX#29 treats them as Other (each code point
# becomes its own segment), but ICU assigns them a word status (IDEO /
# dictionary-based), so they must be *kept* as tokens.
_IDEO_RANGES = ((0x3005, 0x3007), (0x3041, 0x3096), (0x309D, 0x309F),
                (0x3400, 0x4DBF), (0x4E00, 0x9FFF), (0xF900, 0xFAD9),
                (0x20000, 0x2FA1F), (0x30000, 0x3134A))


def _in_ranges(cp: int, ranges) -> bool:
    for lo, hi in ranges:
        if lo <= cp <= hi:
            return True
    return False


def _classify(ch: str) -> int:
    cp = ord(ch)
    if cp == 0x000D:
        return CR
    if cp == 0x000A:
        return LF
    if cp in _NEWLINE_SET:
        return NEWLINE
    if cp == 0x200D:
        return ZWJ
    if cp == 0x0027:
        return SINGLE_QUOTE
    if cp == 0x0022:
        return DOUBLE_QUOTE
    if cp in _MIDNUMLET_SET:
        return MIDNUMLET
    if cp in _MIDLETTER_SET:
        return MIDLETTER
    if cp in _MIDNUM_SET:
        return MIDNUM
    cat = unicodedata.category(ch)
    if cat in ("Mn", "Mc", "Me"):
        return EXTEND
    if cat == "Cf":
        return FORMAT
    if cat == "Pc" or cp == 0x202F:
        return EXTENDNUMLET
    if cat == "Nd" or cat == "Nl" and cp in (0x16EE, 0x16EF, 0x16F0):
        return NUMERIC
    if cat == "Zs":
        # WSegSpace excludes no-break spaces; they are Other -> break.
        if cp in (0x00A0, 0x2007, 0x202F):
            return OTHER
        return WSEGSPACE
    if _in_ranges(cp, _KATAKANA_RANGES):
        return KATAKANA
    if _in_ranges(cp, _HEBREW_RANGES):
        return HEBREW_LETTER
    if _in_ranges(cp, _IDEO_RANGES):
        return IDEOGRAPHIC
    if cat.startswith("L") or cat == "Nl":
        return ALETTER
    # Circled/superscript alphanumerics etc. behave as ALetter per
    # Alphabetic=Yes (category No/So subset); keep the common ones.
    if cat == "No" and 0x24B6 <= cp <= 0x24E9:
        return ALETTER
    return OTHER


# Cache of per-codepoint classes (ASCII precomputed, rest memoized).
_cls_cache: dict[str, int] = {chr(c): _classify(chr(c)) for c in range(128)}


def _cls(ch: str) -> int:
    v = _cls_cache.get(ch)
    if v is None:
        v = _classify(ch)
        _cls_cache[ch] = v
    return v


def _is_break(classes: list[int], i: int) -> bool:
    """Decide whether there is a word boundary before position i.

    ``classes`` holds the WB class of every code point; i in [1, n-1].
    Implements WB3-WB13b with WB4 skipping.
    """
    right = classes[i]
    left = classes[i - 1]

    # WB3: CR x LF
    if left == CR and right == LF:
        return False
    # WB3a / WB3b: break around newlines.
    if left in (CR, LF, NEWLINE) or right in (CR, LF, NEWLINE):
        return True
    # WB3d: keep horizontal whitespace together.
    if left == WSEGSPACE and right == WSEGSPACE:
        return False
    # WB4: X (Extend | Format | ZWJ)* -> treat as X; never break before
    # ignorables (except after newlines handled above).
    if right in _SKIP:
        return False

    # Effective "left" after skipping ignorables (WB4).
    j = i - 1
    while j >= 0 and classes[j] in _SKIP:
        j -= 1
    if j < 0:
        return True  # sot followed by ignorables then right: break (WB999)
    lcls = classes[j]

    # Effective "left-left" (for WB7/WB11).
    k = j - 1
    while k >= 0 and classes[k] in _SKIP:
        k -= 1
    llcls = classes[k] if k >= 0 else OTHER

    # Effective "right-right" (for WB6/WB12): skip ignorables after i.
    m = i + 1
    n = len(classes)
    while m < n and classes[m] in _SKIP:
        m += 1
    rrcls = classes[m] if m < n else OTHER

    # WB5
    if lcls in _AHLETTER and right in _AHLETTER:
        return False
    # WB6: AHLetter x (MidLetter | MidNumLetQ) AHLetter
    if (lcls in _AHLETTER and right in (MIDLETTER,) + _MIDNUMLETQ
            and rrcls in _AHLETTER):
        return False
    # WB7: AHLetter (MidLetter | MidNumLetQ) x AHLetter
    if (lcls in (MIDLETTER,) + _MIDNUMLETQ and right in _AHLETTER
            and llcls in _AHLETTER):
        return False
    # WB7a: Hebrew_Letter x Single_Quote
    if lcls == HEBREW_LETTER and right == SINGLE_QUOTE:
        return False
    # WB7b: Hebrew_Letter x Double_Quote Hebrew_Letter
    if (lcls == HEBREW_LETTER and right == DOUBLE_QUOTE
            and rrcls == HEBREW_LETTER):
        return False
    # WB7c: Hebrew_Letter Double_Quote x Hebrew_Letter
    if (lcls == DOUBLE_QUOTE and right == HEBREW_LETTER
            and llcls == HEBREW_LETTER):
        return False
    # WB8 / WB9 / WB10
    if lcls == NUMERIC and right == NUMERIC:
        return False
    if lcls in _AHLETTER and right == NUMERIC:
        return False
    if lcls == NUMERIC and right in _AHLETTER:
        return False
    # WB11: Numeric (MidNum | MidNumLetQ) x Numeric
    if (lcls in (MIDNUM,) + _MIDNUMLETQ and right == NUMERIC
            and llcls == NUMERIC):
        return False
    # WB12: Numeric x (MidNum | MidNumLetQ) Numeric
    if (lcls == NUMERIC and right in (MIDNUM,) + _MIDNUMLETQ
            and rrcls == NUMERIC):
        return False
    # WB13: Katakana x Katakana
    if lcls == KATAKANA and right == KATAKANA:
        return False
    # WB13a: (AHLetter | Numeric | Katakana | ExtendNumLet) x ExtendNumLet
    if (lcls in _AHLETTER + (NUMERIC, KATAKANA, EXTENDNUMLET)
            and right == EXTENDNUMLET):
        return False
    # WB13b: ExtendNumLet x (AHLetter | Numeric | Katakana)
    if (lcls == EXTENDNUMLET
            and right in _AHLETTER + (NUMERIC, KATAKANA)):
        return False
    # WB999
    return True


_WORDY = frozenset((ALETTER, HEBREW_LETTER, NUMERIC, KATAKANA, IDEOGRAPHIC))


def segments(text: str) -> Iterator[tuple[int, int, bool]]:
    """Yield (start, end, is_word) segments of ``text``.

    ``is_word`` is True when the segment contains at least one letter,
    digit, katakana or ideographic code point -- the equivalent of ICU's
    ``ubrk_getRuleStatus() != UBRK_WORD_NONE`` check used by the
    reference tokenizer (tokenizer.c:280-282).
    """
    n = len(text)
    if n == 0:
        return
    classes = [_cls(ch) for ch in text]
    start = 0
    has_word = classes[0] in _WORDY
    for i in range(1, n):
        if _is_break(classes, i):
            yield (start, i, has_word)
            start = i
            has_word = classes[i] in _WORDY
        else:
            has_word = has_word or classes[i] in _WORDY
    yield (start, n, has_word)


def words(text: str) -> list[str]:
    """Return the word segments of ``text`` in order (with duplicates)."""
    return [text[s:e] for s, e, w in segments(text) if w]
