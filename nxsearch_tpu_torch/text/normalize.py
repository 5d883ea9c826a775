"""Token normalization: lowercase/casefold, NFKC, diacritic removal.

Mirrors the reference normalizer filter (src/core/filters_builtin.c:40-82)
which uses ICU's NFKC_Casefold normalizer (src/utils/utf8.c:69,268) and
the transliteration rule ``"NFKD; [:Nonspacing Mark:] Remove;
Latin-ASCII; NFKC"`` for diacritic substitution (src/utils/utf8.c:30-31).

Implemented host-side with unicodedata (NFKC/NFKD + casefold) plus the
vendored ICU Latin-ASCII table (latin_ascii_data.py, generated from
the real ICU transform by tools/gen_latin_ascii.py; ICU applies
Latin-ASCII to the NFKD/mark-stripped string and the transform is
per-character over that repertoire, so a table lookup per decomposed
character is equivalent -- verified by the executable A/B sweep in
tests/test_icu_parity.py against the system ICU libraries).
"""

from __future__ import annotations

import unicodedata

from .latin_ascii_data import LATIN_ASCII as _LATIN_ASCII


def _is_default_ignorable(ch: str) -> bool:
    # Approximation of Default_Ignorable_Code_Point: format controls and
    # zero-width characters that NFKC_Casefold removes.
    cp = ord(ch)
    if cp in (0x00AD, 0x034F, 0x061C, 0x17B4, 0x17B5, 0x180B, 0x180C,
              0x180D, 0x180E, 0x200B, 0x200C, 0x200D, 0x200E, 0x200F,
              0x2060, 0x2061, 0x2062, 0x2063, 0x2064, 0xFEFF):
        return True
    if 0x202A <= cp <= 0x202E or 0x2066 <= cp <= 0x206F:
        return True
    if 0xFE00 <= cp <= 0xFE0F or 0xE0100 <= cp <= 0xE01EF:
        return True
    if cp in (0x115F, 0x1160, 0x3164, 0xFFA0):  # hangul fillers
        return True
    if 0x1BCA0 <= cp <= 0x1BCA3 or 0x1D173 <= cp <= 0x1D17A:
        return True  # shorthand / musical format controls
    return False


def nfkc_casefold(s: str) -> str:
    """NFKC_Casefold equivalent: NFKC + casefold + drop ignorables."""
    if s.isascii():
        return s.lower()
    s = unicodedata.normalize("NFKC", s)
    s = "".join(ch for ch in s if not _is_default_ignorable(ch))
    return unicodedata.normalize("NFKC", s.casefold())


def strip_diacritics(s: str) -> str:
    """NFKD; remove nonspacing marks; Latin-ASCII; NFKC."""
    if s.isascii():
        return s
    decomposed = unicodedata.normalize("NFKD", s)
    out = []
    for ch in decomposed:
        if unicodedata.category(ch) == "Mn":
            continue
        out.append(_LATIN_ASCII.get(ch, ch))
    return unicodedata.normalize("NFKC", "".join(out))


def normalize_token(s: str) -> str:
    """The full normalizer filter: casefold + NFKC + diacritic fold."""
    return strip_diacritics(nfkc_casefold(s))
