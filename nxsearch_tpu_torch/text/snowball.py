"""Snowball stemming algorithms for non-English languages.

The reference stems via libstemmer: ``sb_stemmer_new(lang)`` for
whatever language the index params name (filters_builtin.c:206-245).
This module re-implements the published Snowball algorithms
(snowballstem.org) in Python for the major languages; English keeps
the existing Porter2 implementation (text/porter2.py, with its C++
fast path).  Unknown languages pass tokens through unchanged,
mirroring ``sb_stemmer_new`` returning NULL.

Each stemmer is a pure ``str -> str`` function over lowercase input
(the pipeline's normalizer lowercases first).  The standard Snowball
region machinery:

- R1: the region after the first non-vowel following a vowel.
- R2: the same definition applied within R1.
- RV (language-specific): a smaller region used by Romance/Russian
  algorithms.

Scandinavian languages and German additionally clamp R1 so at least
three letters precede it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional

from . import porter2

# ---------------------------------------------------------------------------
# Region helpers


def _r1(word: str, vowels: str) -> int:
    for i in range(1, len(word)):
        if word[i] not in vowels and word[i - 1] in vowels:
            return i + 1
    return len(word)


def _r1r2(word: str, vowels: str) -> tuple[int, int]:
    r1 = _r1(word, vowels)
    r2 = r1 + _r1(word[r1:], vowels) if r1 < len(word) else len(word)
    return r1, min(r2, len(word))


def _longest(word: str, suffixes) -> str:
    """Longest suffix of ``word`` among ``suffixes`` ('' if none).
    Snowball ``[substring] among(...)`` semantics: the longest raw
    match wins; its branch condition may still fail (no backtrack)."""
    best = ""
    for s in suffixes:
        if len(s) > len(best) and word.endswith(s):
            best = s
    return best


def _in_r(word: str, suffix: str, r: int) -> bool:
    return len(word) - len(suffix) >= r


def _longest_in(word: str, suffixes, r: int) -> str:
    """Longest suffix that lies entirely within the region starting at
    ``r`` -- Snowball ``setlimit tomark p for ([substring]) among``
    semantics: suffixes crossing the region boundary are not match
    candidates at all, so a shorter in-region suffix can win."""
    best = ""
    for s in suffixes:
        if len(s) > len(best) and word.endswith(s) \
                and len(word) - len(s) >= r:
            best = s
    return best


# ---------------------------------------------------------------------------
# Danish (snowballstem.org/algorithms/danish/stemmer.html)

_DA_V = "aeiouyæåø"
_DA_S_END = "abcdfghjklmnoprtvyzå"
_DA_STEP1 = (
    "hed", "ethed", "ered", "e", "erede", "ende", "erende", "ene",
    "erne", "ere", "en", "heden", "eren", "er", "heder", "erer",
    "heds", "es", "endes", "erendes", "enes", "ernes", "eres", "ens",
    "hedens", "erens", "ers", "ets", "erets", "et", "eret",
)


def stem_da(word: str) -> str:
    if len(word) <= 3:
        return word
    r1 = max(_r1(word, _DA_V), 3)

    # Step 1 (one among, matched within R1: setlimit semantics).
    suf = _longest_in(word, _DA_STEP1 + ("s",), r1)
    if suf == "s":
        if len(word) >= 2 and word[-2] in _DA_S_END:
            word = word[:-1]
    elif suf:
        word = word[: -len(suf)]

    def consonant_pair(w: str) -> str:
        if _longest_in(w, ("gd", "dt", "gt", "kt"), r1):
            return w[:-1]
        return w

    word = consonant_pair(word)

    # Step 3.
    if word.endswith("igst"):
        word = word[:-2]
    suf = _longest_in(word, ("ig", "lig", "elig", "els", "løst"), r1)
    if suf == "løst":
        word = word[:-1]
    elif suf:
        word = consonant_pair(word[: -len(suf)])

    # Step 4, undouble: final double consonant in R1 -> single.
    if (len(word) >= 2 and word[-1] == word[-2]
            and word[-1] not in _DA_V and _in_r(word, word[-1], r1)):
        word = word[:-1]
    return word


# ---------------------------------------------------------------------------
# Swedish

_SV_V = "aeiouyäåö"
_SV_S_END = "bcdfghjklmnoprtvy"
_SV_STEP1 = (
    "a", "arna", "erna", "heterna", "orna", "ad", "e", "ade", "ande",
    "arne", "are", "aste", "en", "anden", "aren", "heten", "ern",
    "ar", "er", "heter", "or", "as", "arnas", "ernas", "ornas", "es",
    "ades", "andes", "ens", "arens", "hetens", "erns", "at", "andet",
    "het", "ast",
)


def stem_sv(word: str) -> str:
    if len(word) <= 3:
        return word
    r1 = max(_r1(word, _SV_V), 3)

    suf = _longest_in(word, _SV_STEP1 + ("s",), r1)
    if suf == "s":
        if len(word) >= 2 and word[-2] in _SV_S_END:
            word = word[:-1]
    elif suf:
        word = word[: -len(suf)]

    if _longest_in(word, ("dd", "gd", "nn", "dt", "gt", "kt", "tt"), r1):
        word = word[:-1]

    suf = _longest_in(word, ("lig", "ig", "els", "löst", "fullt"), r1)
    if suf in ("löst", "fullt"):
        word = word[:-1]
    elif suf:
        word = word[: -len(suf)]
    return word


# ---------------------------------------------------------------------------
# Norwegian

_NO_V = "aeiouyæåø"
_NO_S_END = "bcdfghjlmnoprtvyz"
_NO_STEP1 = (
    "a", "e", "ede", "ande", "ende", "ane", "ene", "hetene", "en",
    "heten", "ar", "er", "heter", "as", "es", "edes", "endes", "enes",
    "hetenes", "ens", "hetens", "ers", "ets", "et", "het", "ast",
)


def stem_no(word: str) -> str:
    if len(word) <= 3:
        return word
    r1 = max(_r1(word, _NO_V), 3)

    suf = _longest_in(word, _NO_STEP1 + ("ert", "erte", "s"), r1)
    if suf in ("ert", "erte"):
        word = word[: len(word) - len(suf)] + "er"
    elif suf == "s":
        if len(word) >= 2 and (word[-2] in _NO_S_END
                               or (word[-2] == "k"
                                   and (len(word) < 3
                                        or word[-3] not in _NO_V))):
            word = word[:-1]
    elif suf:
        word = word[: -len(suf)]

    if _longest_in(word, ("dt", "vt"), r1):
        word = word[:-1]

    suf = _longest_in(word, ("leg", "eleg", "ig", "eig", "lig", "elig",
                             "els", "lov", "elov", "slov", "hetslov"),
                      r1)
    if suf:
        word = word[: -len(suf)]
    return word


# ---------------------------------------------------------------------------
# German

_DE_V = "aeiouyäöü"
_DE_S_END = "bdfghklmnrt"
_DE_ST_END = "bdfghklmnt"


def stem_de(word: str) -> str:
    word = word.replace("ß", "ss")
    if len(word) <= 2:
        return word
    # Protect u/y between vowels from being treated as vowels.
    chars = list(word)
    for i in range(1, len(chars) - 1):
        if chars[i] in "uy" and word[i - 1] in _DE_V \
                and word[i + 1] in _DE_V:
            chars[i] = chars[i].upper()
    w = "".join(chars)
    r1, r2 = _r1r2(w, _DE_V)
    r1 = max(r1, 3)

    # Step 1.
    suf = _longest(w, ("em", "ern", "er"))
    if suf and _in_r(w, suf, r1):
        w = w[: -len(suf)]
    else:
        suf = _longest(w, ("e", "en", "es"))
        if suf and _in_r(w, suf, r1):
            w = w[: -len(suf)]
            if w.endswith("niss"):
                w = w[:-1]
        elif w.endswith("s") and _in_r(w, "s", r1) and len(w) >= 2 \
                and w[-2] in _DE_S_END:
            w = w[:-1]

    # Step 2.
    suf = _longest(w, ("en", "er", "est"))
    if suf and _in_r(w, suf, r1):
        w = w[: -len(suf)]
    elif w.endswith("st") and _in_r(w, "st", r1) and len(w) >= 6 \
            and w[-3] in _DE_ST_END:
        w = w[:-2]

    # Step 3: d-suffixes.
    suf = _longest(w, ("end", "ung", "ig", "ik", "isch", "lich",
                       "heit", "keit"))
    if suf in ("end", "ung"):
        if _in_r(w, suf, r2):
            w = w[: -len(suf)]
            if w.endswith("ig") and _in_r(w, "ig", r2) \
                    and not w.endswith("eig"):
                w = w[:-2]
    elif suf in ("ig", "ik", "isch"):
        if _in_r(w, suf, r2) and not w[: -len(suf)].endswith("e"):
            w = w[: -len(suf)]
    elif suf in ("lich", "heit"):
        if _in_r(w, suf, r2):
            w = w[: -len(suf)]
            for pre in ("er", "en"):
                if w.endswith(pre) and _in_r(w, pre, r1):
                    w = w[:-2]
                    break
    elif suf == "keit":
        if _in_r(w, suf, r2):
            w = w[: -len(suf)]
            if w.endswith("lich") and _in_r(w, "lich", r2):
                w = w[:-4]
            elif w.endswith("ig") and _in_r(w, "ig", r2):
                w = w[:-2]

    w = w.replace("U", "u").replace("Y", "y")
    return (w.replace("ä", "a").replace("ö", "o").replace("ü", "u"))


# ---------------------------------------------------------------------------
# Russian

_RU_V = "аеиоуыэюя"

_RU_PERF_GERUND_1 = ("в", "вши", "вшись")
_RU_PERF_GERUND_2 = ("ив", "ивши", "ившись", "ыв", "ывши", "ывшись")
_RU_ADJECTIVE = (
    "ее", "ие", "ые", "ое", "ими", "ыми", "ей", "ий", "ый", "ой",
    "ем", "им", "ым", "ом", "его", "ого", "ему", "ому", "их", "ых",
    "ую", "юю", "ая", "яя", "ою", "ею",
)
_RU_PARTICIPLE_1 = ("ем", "нн", "вш", "ющ", "щ")
_RU_PARTICIPLE_2 = ("ивш", "ывш", "ующ")
_RU_VERB_1 = (
    "ла", "на", "ете", "йте", "ли", "й", "л", "ем", "н", "ло", "но",
    "ет", "ют", "ны", "ть", "ешь", "нно",
)
_RU_VERB_2 = (
    "ила", "ыла", "ена", "ейте", "уйте", "ите", "или", "ыли", "ей",
    "уй", "ил", "ыл", "им", "ым", "ен", "ило", "ыло", "ено", "ят",
    "ует", "уют", "ит", "ыт", "ены", "ить", "ыть", "ишь", "ую", "ю",
)
_RU_NOUN = (
    "а", "ев", "ов", "ие", "ье", "е", "иями", "ями", "ами", "еи",
    "ии", "и", "ией", "ей", "ой", "ий", "й", "иям", "ям", "ием",
    "ем", "ам", "ом", "о", "у", "ах", "иях", "ях", "ы", "ь", "ию",
    "ью", "ю", "ия", "ья", "я",
)


def _ru_among(w: str, rv: int, plain, aya) -> Optional[str]:
    """One Snowball among within RV: longest raw in-region match
    across both groups; ``aya`` suffixes additionally require а/я
    immediately before (inside RV, kept).  A failed condition fails
    the whole among -- no backtracking to shorter suffixes."""
    best, kind = "", None
    for s in plain:
        if len(s) > len(best) and w.endswith(s) and _in_r(w, s, rv):
            best, kind = s, "plain"
    for s in aya:
        if len(s) > len(best) and w.endswith(s) and _in_r(w, s, rv):
            best, kind = s, "aya"
    if not best:
        return None
    if kind == "aya":
        i = len(w) - len(best) - 1
        if i < rv or w[i] not in "ая":
            return None
    return w[: -len(best)]


def stem_ru(word: str) -> str:
    word = word.replace("ё", "е")
    rv = len(word)
    for i, ch in enumerate(word):
        if ch in _RU_V:
            rv = i + 1
            break
    _, r2 = _r1r2(word, _RU_V)
    if rv >= len(word):
        return word
    w = word

    # Step 1.
    res = _ru_among(w, rv, _RU_PERF_GERUND_2, _RU_PERF_GERUND_1)
    if res is not None:
        w = res
    else:
        for s in ("ся", "сь"):
            if w.endswith(s) and _in_r(w, s, rv):
                w = w[:-2]
                break
        res = _ru_among(w, rv, _RU_ADJECTIVE, ())
        if res is not None:
            w = res
            res = _ru_among(w, rv, _RU_PARTICIPLE_2, _RU_PARTICIPLE_1)
            if res is not None:
                w = res
        else:
            res = _ru_among(w, rv, _RU_VERB_2, _RU_VERB_1)
            if res is not None:
                w = res
            else:
                res = _ru_among(w, rv, _RU_NOUN, ())
                if res is not None:
                    w = res

    # Step 2: trailing и.
    if w.endswith("и") and _in_r(w, "и", rv):
        w = w[:-1]

    # Step 3: derivational, in R2.
    for s in ("ость", "ост"):
        if w.endswith(s) and _in_r(w, s, r2):
            w = w[: -len(s)]
            break

    # Step 4 (within RV): undouble нн; or remove superlative ейш(е)
    # then undouble нн; or drop trailing ь.
    if w.endswith("нн") and _in_r(w, "нн", rv):
        w = w[:-1]
    elif w.endswith("ейше") and _in_r(w, "ейше", rv) \
            or w.endswith("ейш") and _in_r(w, "ейш", rv):
        w = w[:-4] if w.endswith("ейше") else w[:-3]
        if w.endswith("нн") and _in_r(w, "нн", rv):
            w = w[:-1]
    elif w.endswith("ь") and _in_r(w, "ь", rv):
        w = w[:-1]
    return w



# ---------------------------------------------------------------------------
# Dutch

_NL_V = "aeiouyè"


def _nl_undouble(w: str) -> str:
    for d in ("kk", "dd", "tt"):
        if w.endswith(d):
            return w[:-1]
    return w


def stem_nl(word: str) -> str:
    for a, b in (("ä", "a"), ("ë", "e"), ("ï", "i"), ("ö", "o"),
                 ("ü", "u"), ("á", "a"), ("é", "e"), ("í", "i"),
                 ("ó", "o"), ("ú", "u")):
        word = word.replace(a, b)
    if len(word) <= 2:
        return word
    # Protect y (initial or after vowel) and i between vowels.
    chars = list(word)
    if chars[0] == "y":
        chars[0] = "Y"
    for i in range(1, len(chars)):
        if chars[i] == "y" and word[i - 1] in _NL_V:
            chars[i] = "Y"
        elif (chars[i] == "i" and i + 1 < len(chars)
              and word[i - 1] in _NL_V and word[i + 1] in _NL_V):
            chars[i] = "I"
    w = "".join(chars)
    r1, r2 = _r1r2(w, _NL_V)
    r1 = max(r1, 3)

    def en_ok(x: str, n: int) -> bool:
        """valid en-ending: preceded by a non-vowel, and not gem."""
        stem = x[:-n]
        return (bool(stem) and stem[-1] not in _NL_V
                and not stem.endswith("gem"))

    # Step 1.
    suf = _longest(w, ("heden", "ene", "en", "se", "s"))
    if suf == "heden":
        if _in_r(w, suf, r1):
            w = w[:-5] + "heid"
    elif suf in ("ene", "en"):
        if _in_r(w, suf, r1) and en_ok(w, len(suf)):
            w = _nl_undouble(w[: -len(suf)])
    elif suf in ("se", "s"):
        if _in_r(w, suf, r1) and len(w) > len(suf) \
                and w[-len(suf) - 1] not in _NL_V + "j":
            w = w[: -len(suf)]

    # Step 2.
    e_found = False
    if w.endswith("e") and _in_r(w, "e", r1) and len(w) >= 2 \
            and w[-2] not in _NL_V:
        e_found = True
        w = _nl_undouble(w[:-1])

    # Step 3a: heid.
    if w.endswith("heid") and _in_r(w, "heid", r2) \
            and not w[:-4].endswith("c"):
        w = w[:-4]
        if w.endswith("en") and _in_r(w, "en", r1) and en_ok(w, 2):
            w = _nl_undouble(w[:-2])

    # Step 3b: d-suffixes.
    suf = _longest(w, ("end", "ing", "ig", "lijk", "baar", "bar"))
    if suf in ("end", "ing"):
        if _in_r(w, suf, r2):
            w = w[:-3]
            if w.endswith("ig") and _in_r(w, "ig", r2) \
                    and not w[:-2].endswith("e"):
                w = w[:-2]
            else:
                w = _nl_undouble(w)
    elif suf == "ig":
        if _in_r(w, suf, r2) and not w[:-2].endswith("e"):
            w = w[:-2]
    elif suf == "lijk":
        if _in_r(w, suf, r2):
            w = w[:-4]
            if w.endswith("e") and _in_r(w, "e", r1) and len(w) >= 2 \
                    and w[-2] not in _NL_V:
                w = _nl_undouble(w[:-1])
    elif suf == "baar":
        if _in_r(w, suf, r2):
            w = w[:-4]
    elif suf == "bar":
        if _in_r(w, suf, r2) and e_found:
            w = w[:-3]

    # Step 4: undouble vowel (C + aa/ee/oo/uu + C, last C != I).
    if len(w) >= 4 and w[-1] not in _NL_V and w[-1] != "I" \
            and w[-2] == w[-3] and w[-2] in "aeou" \
            and w[-4] not in _NL_V:
        w = w[:-2] + w[-1]

    return w.replace("I", "i").replace("Y", "y")


# ---------------------------------------------------------------------------
# French

_FR_V = "aeiouyâàëéêèïîôûù"


def _fr_prelude(word: str) -> str:
    chars = list(word)
    n = len(chars)
    for i in range(n):
        c = chars[i]
        prev_v = i > 0 and word[i - 1] in _FR_V
        next_v = i + 1 < n and word[i + 1] in _FR_V
        if c in "ui" and prev_v and next_v:
            chars[i] = c.upper()
        elif c == "y" and (prev_v or next_v):
            chars[i] = "Y"
        elif c == "u" and i > 0 and word[i - 1] == "q":
            chars[i] = "U"
    return "".join(chars)


def _fr_rv(w: str) -> int:
    if len(w) >= 3 and w[0] in _FR_V and w[1] in _FR_V:
        return 3
    if w[:3] in ("par", "col", "tap"):
        return 3
    for i in range(1, len(w)):
        if w[i] in _FR_V:
            return i + 1
    return len(w)


def stem_fr(word: str) -> str:
    if len(word) <= 2:
        return word
    w = _fr_prelude(word)
    rv = _fr_rv(w)
    r1, r2 = _r1r2(w, _FR_V)

    orig = w
    found = False         # a suffix was removed in step 1
    do_2a = True          # step 1 found nothing, or found *ment*

    # ---- Step 1: standard suffixes (longest raw match, then rules).
    s1 = _longest(w, (
        "ance", "iqUe", "isme", "able", "iste", "eux", "ances",
        "iqUes", "ismes", "ables", "istes",
        "atrice", "ateur", "ation", "atrices", "ateurs", "ations",
        "logie", "logies", "usion", "ution", "usions", "utions",
        "ence", "ences", "ement", "ements", "ité", "ités",
        "if", "ive", "ifs", "ives", "eaux", "aux", "euse", "euses",
        "issement", "issements", "amment", "emment", "ment", "ments",
    ))
    if s1:
        base = w[: -len(s1)]
        if s1 in ("ance", "iqUe", "isme", "able", "iste", "eux",
                  "ances", "iqUes", "ismes", "ables", "istes"):
            if _in_r(w, s1, r2):
                w, found = base, True
        elif s1 in ("atrice", "ateur", "ation", "atrices", "ateurs",
                    "ations"):
            if _in_r(w, s1, r2):
                w, found = base, True
                if w.endswith("ic"):
                    if _in_r(w, "ic", r2):
                        w = w[:-2]
                    else:
                        w = w[:-2] + "iqU"
        elif s1 in ("logie", "logies"):
            if _in_r(w, s1, r2):
                w, found = base + "log", True
        elif s1 in ("usion", "ution", "usions", "utions"):
            if _in_r(w, s1, r2):
                w, found = base + "u", True
        elif s1 in ("ence", "ences"):
            if _in_r(w, s1, r2):
                w, found = base + "ent", True
        elif s1 in ("ement", "ements"):
            if _in_r(w, s1, rv):
                w, found = base, True
                if w.endswith("iv") and _in_r(w, "iv", r2):
                    w = w[:-2]
                    if w.endswith("at") and _in_r(w, "at", r2):
                        w = w[:-2]
                elif w.endswith("eus"):
                    if _in_r(w, "eus", r2):
                        w = w[:-3]
                    elif _in_r(w, "eus", r1):
                        w = w[:-1] + "x"
                elif w.endswith("abl") and _in_r(w, "abl", r2):
                    w = w[:-3]
                elif w.endswith("iqU") and _in_r(w, "iqU", r2):
                    w = w[:-3]
                elif w.endswith("ièr") and _in_r(w, "ièr", rv):
                    w = w[:-3] + "i"
                elif w.endswith("Ièr") and _in_r(w, "Ièr", rv):
                    w = w[:-3] + "i"
        elif s1 in ("ité", "ités"):
            if _in_r(w, s1, r2):
                w, found = base, True
                if w.endswith("abil"):
                    if _in_r(w, "abil", r2):
                        w = w[:-4]
                    else:
                        w = w[:-2] + "l"
                elif w.endswith("ic"):
                    if _in_r(w, "ic", r2):
                        w = w[:-2]
                    else:
                        w = w[:-2] + "iqU"
                elif w.endswith("iv") and _in_r(w, "iv", r2):
                    w = w[:-2]
        elif s1 in ("if", "ive", "ifs", "ives"):
            if _in_r(w, s1, r2):
                w, found = base, True
                if w.endswith("at") and _in_r(w, "at", r2):
                    w = w[:-2]
                    if w.endswith("ic"):
                        if _in_r(w, "ic", r2):
                            w = w[:-2]
                        else:
                            w = w[:-2] + "iqU"
        elif s1 == "eaux":
            w, found = base + "eau", True
        elif s1 == "aux":
            if _in_r(w, s1, r1):
                w, found = base + "al", True
        elif s1 in ("euse", "euses"):
            if _in_r(w, s1, r2):
                w, found = base, True
            elif _in_r(w, s1, r1):
                w, found = base + "eux", True
        elif s1 in ("issement", "issements"):
            if _in_r(w, s1, r1) and base and base[-1] not in _FR_V:
                w, found = base, True
        elif s1 == "amment":
            if _in_r(w, s1, rv):
                w = base + "ant"   # not counted as removed
        elif s1 == "emment":
            if _in_r(w, s1, rv):
                w = base + "ent"   # not counted as removed
        elif s1 in ("ment", "ments"):
            if _in_r(w, s1, rv) and len(base) >= 1 \
                    and base[-1] in _FR_V and len(base) >= rv:
                w = base           # not counted as removed

    if found and s1 not in ("amment", "emment", "ment", "ments"):
        do_2a = False

    # ---- Step 2a: verb suffixes beginning i (in RV, after non-vowel).
    altered_2 = False
    if do_2a:
        s2a = _longest_in(w, (
            "îmes", "ît", "îtes", "i", "ie", "ies", "ir", "ira",
            "irai", "iraIent", "irais", "irait", "iras", "irent",
            "irez", "iriez", "irions", "irons", "iront", "is",
            "issaIent", "issais", "issait", "issant", "issante",
            "issantes", "issants", "isse", "issent", "isses", "issez",
            "issiez", "issions", "issons", "it",
        ), rv)
        base = w[: -len(s2a)] if s2a else ""
        if s2a and base and base[-1] not in _FR_V \
                and len(base) >= rv:
            w, altered_2 = base, True
        else:
            # ---- Step 2b: other verb suffixes.
            s2b = _longest_in(w, (
                "ions", "é", "ée", "ées", "és", "èrent", "er", "era",
                "erai", "eraIent", "erais", "erait", "eras", "erez",
                "eriez", "erions", "erons", "eront", "ez", "iez",
                "âmes", "ât", "âtes", "a", "ai", "aIent", "ais",
                "ait", "ant", "ante", "antes", "ants", "as", "asse",
                "assent", "asses", "assiez", "assions",
            ), rv)
            if s2b == "ions":
                if _in_r(w, s2b, r2):
                    w, altered_2 = w[:-4], True
            elif s2b in ("é", "ée", "ées", "és", "èrent", "er", "era",
                         "erai", "eraIent", "erais", "erait", "eras",
                         "erez", "eriez", "erions", "erons", "eront",
                         "ez", "iez"):
                w, altered_2 = w[: -len(s2b)], True
            elif s2b:
                w, altered_2 = w[: -len(s2b)], True
                if w.endswith("e") and _in_r(w, "e", rv):
                    w = w[:-1]

    if found or altered_2:
        # ---- Step 3.
        if w.endswith("Y"):
            w = w[:-1] + "i"
        elif w.endswith("ç"):
            w = w[:-1] + "c"
    else:
        # ---- Step 4.
        if w.endswith("s") and len(w) >= 2 \
                and w[-2] not in "aiouès" and w[-2] != "s":
            w = w[:-1]
        s4 = _longest_in(w, ("ion", "ier", "ière", "Ier", "Ière", "e",
                             "ë"), rv)
        if s4 == "ion":
            if _in_r(w, s4, r2) and len(w) >= 4 and w[-4] in "st":
                w = w[:-3]
        elif s4 in ("ier", "ière", "Ier", "Ière"):
            w = w[: -len(s4)] + "i"
        elif s4 == "e":
            w = w[:-1]
        elif s4 == "ë":
            if w[:-1].endswith("gu"):
                w = w[:-1]

    # ---- Step 5: undouble.
    for d in ("enn", "onn", "ett", "ell", "eill"):
        if w.endswith(d):
            w = w[:-1]
            break

    # ---- Step 6: un-accent final syllable.
    i = len(w) - 1
    seen_nonv = False
    while i >= 0 and w[i] not in _FR_V:
        seen_nonv = True
        i -= 1
    if seen_nonv and i >= 0 and w[i] in "éè":
        w = w[:i] + "e" + w[i + 1:]

    return (w.replace("I", "i").replace("U", "u").replace("Y", "y"))


# ---------------------------------------------------------------------------
# Spanish

_ES_V = "aeiouáéíóúü"


def _es_rv(w: str) -> int:
    if len(w) < 3:
        return len(w)
    if w[1] not in _ES_V:
        for i in range(2, len(w)):
            if w[i] in _ES_V:
                return i + 1
        return len(w)
    if w[0] in _ES_V and w[1] in _ES_V:
        for i in range(2, len(w)):
            if w[i] not in _ES_V:
                return i + 1
        return len(w)
    return 3


_ES_PRONOUNS = ("me", "se", "sela", "selo", "selas", "selos", "la",
                "le", "lo", "las", "les", "los", "nos")
_ES_STEP1_DEL_R2 = (
    "anza", "anzas", "ico", "ica", "icos", "icas", "ismo", "ismos",
    "able", "ables", "ible", "ibles", "ista", "istas", "oso", "osa",
    "osos", "osas", "amiento", "amientos", "imiento", "imientos",
)
_ES_STEP1_ADOR = ("adora", "ador", "ación", "adoras", "adores",
                  "aciones", "ante", "antes", "ancia", "ancias")
_ES_STEP2B_GU = ("en", "es", "éis", "emos")
_ES_STEP2B = (
    "arían", "arías", "arán", "arás", "aríais", "aría", "aréis",
    "aríamos", "aremos", "ará", "aré", "erían", "erías", "erán",
    "erás", "eríais", "ería", "eréis", "eríamos", "eremos", "erá",
    "eré", "irían", "irías", "irán", "irás", "iríais", "iría",
    "iréis", "iríamos", "iremos", "irá", "iré", "aba", "ada", "ida",
    "ía", "ara", "iera", "ad", "ed", "id", "ase", "iese", "aste",
    "iste", "an", "aban", "ían", "aran", "ieran", "asen", "iesen",
    "aron", "ieron", "ado", "ido", "ando", "iendo", "ió", "ar", "er",
    "ir", "as", "abas", "adas", "idas", "ías", "aras", "ieras",
    "ases", "ieses", "ís", "áis", "abais", "íais", "arais", "ierais",
    "aseis", "ieseis", "asteis", "isteis", "ados", "idos", "amos",
    "ábamos", "íamos", "imos", "áramos", "iéramos", "iésemos",
    "ásemos",
)


def stem_es(word: str) -> str:
    if len(word) <= 2:
        return word
    w = word
    rv = _es_rv(w)
    r1, r2 = _r1r2(w, _ES_V)

    # Step 0: attached pronoun.
    pron = _longest_in(w, _ES_PRONOUNS, rv)
    if pron:
        base = w[: -len(pron)]
        g = _longest(base, ("iéndo", "ándo", "ár", "ér", "ír",
                            "ando", "iendo", "ar", "er", "ir"))
        if g and len(base) - len(g) >= rv:
            if g in ("iéndo", "ándo", "ár", "ér", "ír"):
                fix = {"iéndo": "iendo", "ándo": "ando", "ár": "ar",
                       "ér": "er", "ír": "ir"}[g]
                w = base[: -len(g)] + fix
            else:
                w = base
        elif base.endswith("yendo") and "uyendo" in base[-6:]:
            w = base

    # Step 1: standard suffixes.
    found = False
    s1 = _longest(w, _ES_STEP1_DEL_R2 + _ES_STEP1_ADOR + (
        "logía", "logías", "ución", "uciones", "encia", "encias",
        "amente", "mente", "idad", "idades", "iva", "ivo", "ivas",
        "ivos"))
    if s1:
        base = w[: -len(s1)]
        if s1 in _ES_STEP1_DEL_R2:
            if _in_r(w, s1, r2):
                w, found = base, True
        elif s1 in _ES_STEP1_ADOR:
            if _in_r(w, s1, r2):
                w, found = base, True
                if w.endswith("ic") and _in_r(w, "ic", r2):
                    w = w[:-2]
        elif s1 in ("logía", "logías"):
            if _in_r(w, s1, r2):
                w, found = base + "log", True
        elif s1 in ("ución", "uciones"):
            if _in_r(w, s1, r2):
                w, found = base + "u", True
        elif s1 in ("encia", "encias"):
            if _in_r(w, s1, r2):
                w, found = base + "ente", True
        elif s1 == "amente":
            if _in_r(w, s1, r1):
                w, found = base, True
                if w.endswith("iv") and _in_r(w, "iv", r2):
                    w = w[:-2]
                    if w.endswith("at") and _in_r(w, "at", r2):
                        w = w[:-2]
                else:
                    for pre in ("os", "ic", "ad"):
                        if w.endswith(pre) and _in_r(w, pre, r2):
                            w = w[:-2]
                            break
        elif s1 == "mente":
            if _in_r(w, s1, r2):
                w, found = base, True
                for pre in ("ante", "able", "ible"):
                    if w.endswith(pre) and _in_r(w, pre, r2):
                        w = w[: -len(pre)]
                        break
        elif s1 in ("idad", "idades"):
            if _in_r(w, s1, r2):
                w, found = base, True
                for pre in ("abil", "ic", "iv"):
                    if w.endswith(pre) and _in_r(w, pre, r2):
                        w = w[: -len(pre)]
                        break
        elif s1 in ("iva", "ivo", "ivas", "ivos"):
            if _in_r(w, s1, r2):
                w, found = base, True
                if w.endswith("at") and _in_r(w, "at", r2):
                    w = w[:-2]

    if not found:
        # Step 2a: verb suffixes beginning y (preceded by u).
        s2a = _longest_in(w, ("ya", "ye", "yan", "yen", "yeron",
                              "yendo", "yo", "yó", "yas", "yes",
                              "yais", "yamos"), rv)
        if s2a and w[: -len(s2a)].endswith("u"):
            w = w[: -len(s2a)]
        else:
            # Step 2b: other verb suffixes.
            s2b = _longest_in(w, _ES_STEP2B_GU + _ES_STEP2B, rv)
            if s2b in _ES_STEP2B_GU:
                w = w[: -len(s2b)]
                if w.endswith("gu"):
                    w = w[:-1]
            elif s2b:
                w = w[: -len(s2b)]

    # Step 3: residual suffix.
    s3 = _longest_in(w, ("os", "a", "o", "á", "í", "ó", "e", "é"), rv)
    if s3 in ("os", "a", "o", "á", "í", "ó"):
        w = w[: -len(s3)]
    elif s3 in ("e", "é"):
        w = w[:-1]
        if w.endswith("gu") and _in_r(w, "u", rv):
            w = w[:-1]

    for a, b in (("á", "a"), ("é", "e"), ("í", "i"), ("ó", "o"),
                 ("ú", "u")):
        w = w.replace(a, b)
    return w


# ---------------------------------------------------------------------------
# Italian

_IT_V = "aeiouàèìòù"

_IT_PRONOUNS = (
    "ci", "gli", "la", "le", "li", "lo", "mi", "ne", "si", "ti",
    "vi", "sene", "gliela", "gliele", "glieli", "glielo", "gliene",
    "mela", "mele", "meli", "melo", "mene", "tela", "tele", "teli",
    "telo", "tene", "cela", "cele", "celi", "celo", "cene", "vela",
    "vele", "veli", "velo", "vene",
)
_IT_STEP1_DEL_R2 = (
    "anza", "anze", "ico", "ici", "ica", "ice", "iche", "ichi",
    "ismo", "ismi", "abile", "abili", "ibile", "ibili", "ista",
    "iste", "isti", "istà", "istè", "istì", "oso", "osi", "osa",
    "ose", "mente", "atrice", "atrici", "ante", "anti",
)
_IT_STEP2 = (
    "ammo", "ando", "ano", "are", "arono", "asse", "assero", "assi",
    "assimo", "ata", "ate", "ati", "ato", "ava", "avamo", "avano",
    "avate", "avi", "avo", "emmo", "enda", "ende", "endi", "endo",
    "erà", "erai", "eranno", "ere", "erebbe", "erebbero", "erei",
    "eremmo", "eremo", "ereste", "eresti", "erete", "erò", "erono",
    "essero", "ete", "eva", "evamo", "evano", "evate", "evi", "evo",
    "Yamo", "iamo", "immo", "irà", "irai", "iranno", "ire", "irebbe",
    "irebbero", "irei", "iremmo", "iremo", "ireste", "iresti",
    "irete", "irò", "irono", "isca", "iscano", "isce", "isci",
    "isco", "iscono", "issero", "ita", "ite", "iti", "ito", "iva",
    "ivamo", "ivano", "ivate", "ivi", "ivo", "ono", "uta", "ute",
    "uti", "uto", "ar", "ir",
)


def stem_it(word: str) -> str:
    if len(word) <= 2:
        return word
    for a, b in (("á", "à"), ("é", "è"), ("í", "ì"), ("ó", "ò"),
                 ("ú", "ù")):
        word = word.replace(a, b)
    chars = list(word)
    n = len(chars)
    for i in range(n):
        c = chars[i]
        prev_v = i > 0 and word[i - 1] in _IT_V
        next_v = i + 1 < n and word[i + 1] in _IT_V
        if c in "ui" and prev_v and next_v:
            chars[i] = c.upper()
        elif c == "u" and i > 0 and word[i - 1] == "q":
            chars[i] = "U"
    w = "".join(chars)
    rv = _es_rv_generic(w, _IT_V)
    r1, r2 = _r1r2(w, _IT_V)

    # Step 0: attached pronoun.
    pron = _longest_in(w, _IT_PRONOUNS, rv)
    if pron:
        base = w[: -len(pron)]
        g = _longest(base, ("ando", "endo", "ar", "er", "ir"))
        if g and len(base) - len(g) >= rv:
            if g in ("ando", "endo"):
                w = base
            else:
                w = base + "e"

    found = False
    s1 = _longest(w, _IT_STEP1_DEL_R2 + (
        "azione", "azioni", "atore", "atori", "logia", "logie",
        "uzione", "uzioni", "usione", "usioni", "enza", "enze",
        "amento", "amenti", "imento", "imenti", "amente", "ità",
        "ivo", "ivi", "iva", "ive"))
    if s1:
        base = w[: -len(s1)]
        if s1 == "amente":
            if _in_r(w, s1, r1):
                w, found = base, True
                if w.endswith("iv") and _in_r(w, "iv", r2):
                    w = w[:-2]
                    if w.endswith("at") and _in_r(w, "at", r2):
                        w = w[:-2]
                else:
                    for pre in ("os", "ic", "abil"):
                        if w.endswith(pre) and _in_r(w, pre, r2):
                            w = w[: -len(pre)]
                            break
        elif s1 in _IT_STEP1_DEL_R2:
            if _in_r(w, s1, r2):
                w, found = base, True
        elif s1 in ("azione", "azioni", "atore", "atori"):
            if _in_r(w, s1, r2):
                w, found = base, True
                if w.endswith("ic") and _in_r(w, "ic", r2):
                    w = w[:-2]
        elif s1 in ("logia", "logie"):
            if _in_r(w, s1, r2):
                w, found = base + "log", True
        elif s1 in ("uzione", "uzioni", "usione", "usioni"):
            if _in_r(w, s1, r2):
                w, found = base + "u", True
        elif s1 in ("enza", "enze"):
            if _in_r(w, s1, r2):
                w, found = base + "ente", True
        elif s1 in ("amento", "amenti", "imento", "imenti"):
            if _in_r(w, s1, rv):
                w, found = base, True
        elif s1 == "ità":
            if _in_r(w, s1, r2):
                w, found = base, True
                for pre in ("abil", "ic", "iv"):
                    if w.endswith(pre) and _in_r(w, pre, r2):
                        w = w[: -len(pre)]
                        break
        elif s1 in ("ivo", "ivi", "iva", "ive"):
            if _in_r(w, s1, r2):
                w, found = base, True
                if w.endswith("at") and _in_r(w, "at", r2):
                    w = w[:-2]
                    if w.endswith("ic") and _in_r(w, "ic", r2):
                        w = w[:-2]

    if not found:
        s2 = _longest_in(w, _IT_STEP2, rv)
        if s2:
            w = w[: -len(s2)]

    # Step 3a: final vowel (and then a following i).
    if w and w[-1] in "aeioàèìò" and _in_r(w, w[-1], rv):
        w = w[:-1]
        if w.endswith("i") and _in_r(w, "i", rv):
            w = w[:-1]
    # Step 3b.
    if _in_r(w, "ch", rv) and w.endswith("ch"):
        w = w[:-1]
    elif _in_r(w, "gh", rv) and w.endswith("gh"):
        w = w[:-1]

    return w.replace("U", "u").replace("I", "i")


def _es_rv_generic(w: str, vowels: str) -> int:
    if len(w) < 3:
        return len(w)
    if w[1] not in vowels:
        for i in range(2, len(w)):
            if w[i] in vowels:
                return i + 1
        return len(w)
    if w[0] in vowels and w[1] in vowels:
        for i in range(2, len(w)):
            if w[i] not in vowels:
                return i + 1
        return len(w)
    return 3


# ---------------------------------------------------------------------------
# Portuguese

_PT_V = "aeiouáéíóúâêô"

_PT_STEP1_DEL_R2 = (
    "eza", "ezas", "ico", "ica", "icos", "icas", "ismo", "ismos",
    "ável", "ível", "ista", "istas", "oso", "osa", "osos", "osas",
    "amento", "amentos", "imento", "imentos",
)
_PT_STEP1_ADOR = ("adora", "ador", "aça~o", "adoras", "adores",
                  "aço~es", "ante", "antes", "ância")
_PT_STEP2 = (
    "ada", "ida", "ia", "aria", "eria", "iria", "ará", "ara", "erá",
    "era", "irá", "ava", "asse", "esse", "isse", "aste", "este",
    "iste", "ei", "arei", "erei", "irei", "am", "iam", "ariam",
    "eriam", "iriam", "aram", "eram", "iram", "avam", "em", "arem",
    "erem", "irem", "assem", "essem", "issem", "ado", "ido", "ando",
    "endo", "indo", "ara~o", "era~o", "ira~o", "ar", "er", "ir",
    "as", "adas", "idas", "ias", "arias", "erias", "irias", "arás",
    "aras", "erás", "eras", "irás", "avas", "es", "ardes", "erdes",
    "irdes", "ares", "eres", "ires", "asses", "esses", "isses",
    "astes", "estes", "istes", "is", "ais", "eis", "íeis", "aríeis",
    "eríeis", "iríeis", "áreis", "areis", "éreis", "ereis", "íreis",
    "ireis", "ásseis", "ésseis", "ísseis", "áveis", "aveis", "ados",
    "idos", "ámos", "amos", "íamos", "aríamos", "eríamos", "iríamos",
    "áramos", "éramos", "íramos", "ávamos", "emos", "aremos",
    "eremos", "iremos", "ássemos", "êssemos", "íssemos", "imos",
    "armos", "ermos", "irmos", "eu", "iu", "ou", "ira", "iras",
)


def stem_pt(word: str) -> str:
    if len(word) <= 2:
        return word
    w = word.replace("ã", "a~").replace("õ", "o~")
    rv = _es_rv_generic(w, _PT_V)
    r1, r2 = _r1r2(w, _PT_V)

    found = False
    s1 = _longest(w, _PT_STEP1_DEL_R2 + _PT_STEP1_ADOR + (
        "logia", "logias", "uça~o", "uço~es", "ência", "ências",
        "amente", "mente", "idade", "idades", "iva", "ivo", "ivas",
        "ivos", "ira", "iras"))
    if s1:
        base = w[: -len(s1)]
        if s1 in _PT_STEP1_DEL_R2:
            if _in_r(w, s1, r2):
                w, found = base, True
        elif s1 in _PT_STEP1_ADOR:
            if _in_r(w, s1, r2):
                w, found = base, True
                if w.endswith("ic") and _in_r(w, "ic", r2):
                    w = w[:-2]
        elif s1 in ("logia", "logias"):
            if _in_r(w, s1, r2):
                w, found = base + "log", True
        elif s1 in ("uça~o", "uço~es"):
            if _in_r(w, s1, r2):
                w, found = base + "u", True
        elif s1 in ("ência", "ências"):
            if _in_r(w, s1, r2):
                w, found = base + "ente", True
        elif s1 == "amente":
            if _in_r(w, s1, r1):
                w, found = base, True
                if w.endswith("iv") and _in_r(w, "iv", r2):
                    w = w[:-2]
                    if w.endswith("at") and _in_r(w, "at", r2):
                        w = w[:-2]
                else:
                    for pre in ("os", "ic", "ad"):
                        if w.endswith(pre) and _in_r(w, pre, r2):
                            w = w[:-2]
                            break
        elif s1 == "mente":
            if _in_r(w, s1, r2):
                w, found = base, True
                for pre in ("ante", "avel", "ível"):
                    if w.endswith(pre) and _in_r(w, pre, r2):
                        w = w[: -len(pre)]
                        break
        elif s1 in ("idade", "idades"):
            if _in_r(w, s1, r2):
                w, found = base, True
                for pre in ("abil", "ic", "iv"):
                    if w.endswith(pre) and _in_r(w, pre, r2):
                        w = w[: -len(pre)]
                        break
        elif s1 in ("iva", "ivo", "ivas", "ivos"):
            if _in_r(w, s1, r2):
                w, found = base, True
                if w.endswith("at") and _in_r(w, "at", r2):
                    w = w[:-2]
        elif s1 in ("ira", "iras"):
            if _in_r(w, s1, rv) and base.endswith("e"):
                w, found = base + "ir", True

    if not found:
        s2 = _longest_in(w, _PT_STEP2, rv)
        if s2:
            w = w[: -len(s2)]
            found = True

    if found:
        # Step 3: delete i after c.
        if w.endswith("i") and _in_r(w, "i", rv) and w[:-1].endswith("c"):
            w = w[:-1]
    else:
        # Step 4: residual suffix.
        s4 = _longest_in(w, ("os", "a", "i", "o", "á", "í", "ó"), rv)
        if s4:
            w = w[: -len(s4)]

    # Step 5.
    if w and w[-1] in "eéê" and _in_r(w, w[-1], rv):
        w = w[:-1]
        if w.endswith("gu") and _in_r(w, "u", rv):
            w = w[:-1]
        elif w.endswith("ci") and _in_r(w, "i", rv):
            w = w[:-1]
    elif w.endswith("ç"):
        w = w[:-1] + "c"

    return w.replace("a~", "ã").replace("o~", "õ")

# ---------------------------------------------------------------------------
# Hindi -- Snowball's hindi stemmer implements "A Lightweight Stemmer
# for Hindi" (Ramanathan & Rao 2003): strip the longest matching
# suffix from the published list, keeping at least one character
# before it.  The reference stems hi via libstemmer
# (filters_builtin.c:206-245).

_HI_SUFFIXES = sorted(
    [
        # 1 character (matras)
        "ा", "ि", "ी", "ु", "ू", "ृ", "े", "ै", "ो", "ौ",
        # 2 characters
        "कर", "ाओ", "िए", "ाई", "ाए", "ने", "नी", "ना", "ते", "ीं",
        "ती", "ता", "ाँ", "ां", "ों", "ें",
        # 3 characters
        "ाकर", "ाइए", "ाईं", "ाया", "ेगी", "ेगा", "ोगी", "ोगे", "ाने",
        "ाना", "ाते", "ाती", "ाता", "तीं", "ाओं", "ाएं", "ुओं", "ुएं",
        "ुआं",
        # 4 characters
        "ाएगी", "ाएगा", "ाओगी", "ाओगे", "एंगी", "ेंगी", "एंगे", "ेंगे",
        "ूंगी", "ूंगा", "ातीं", "नाओं", "नाएं", "ताओं", "ताएं", "ियाँ",
        "ियों", "ियां",
        # 5 characters
        "ाएंगी", "ाएंगे", "ाऊंगी", "ाऊंगा", "ाइयाँ", "ाइयों", "ाइयां",
    ],
    key=len, reverse=True)


def stem_hi(word: str) -> str:
    for suf in _HI_SUFFIXES:
        if len(word) > len(suf) and word.endswith(suf):
            return word[: -len(suf)]
    return word


# ---------------------------------------------------------------------------
# Indonesian -- Snowball's indonesian stemmer implements the published
# Porter-style stemmer for Bahasa Indonesia (Tala 2003): particle and
# possessive-pronoun suffixes, then derivational prefixes/suffixes
# with the paper's confix restrictions.  ``measure`` is the word's
# vowel count; nothing is removed once it would drop to 2.

_ID_V = "aeiou"


def _id_measure(w: str) -> int:
    return sum(1 for c in w if c in _ID_V)


# Confix restrictions (Tala 2003, table of disallowed combinations):
#   di-/meN-/ter-  may not combine with -an   (class 1)
#   ber-/be-       may not combine with -i    (class 2)
#   ke-/se-        may not combine with -i or -kan  (class 3)
_ID_NO_AN = 1
_ID_NO_I = 2
_ID_NO_I_KAN = 3


def _id_first_order_prefix(w: str) -> tuple[str, int, bool]:
    """Remove one first-order derivational prefix.  Returns
    (word, prefix_class, removed)."""
    if w.startswith("meny") and len(w) > 4 and w[4] in _ID_V:
        # meny+V: the stem-initial 's' elides under nasalisation.
        return "s" + w[4:], _ID_NO_AN, True
    if w.startswith("peny") and len(w) > 4 and w[4] in _ID_V:
        return "s" + w[4:], 0, True
    for p, cls in (("meng", _ID_NO_AN), ("peng", 0)):
        if w.startswith(p):
            return w[4:], cls, True
    for p, cls in (("men", _ID_NO_AN), ("pen", 0),
                   ("mem", _ID_NO_AN), ("pem", 0)):
        if w.startswith(p):
            return w[3:], cls, True
    for p, cls in (("di", _ID_NO_AN), ("ter", _ID_NO_AN),
                   ("ke", _ID_NO_I_KAN), ("se", _ID_NO_I_KAN),
                   ("me", _ID_NO_AN), ("pe", 0)):
        if w.startswith(p):
            return w[len(p):], cls, True
    return w, 0, False


def _id_second_order_prefix(w: str) -> tuple[str, int, bool]:
    """Remove one second-order derivational prefix."""
    # bel-/pel- only before 'ajar' (belajar/pelajar -> ajar).
    for p, cls in (("bel", _ID_NO_I), ("pel", 0)):
        if w.startswith(p) and w[3:].startswith("ajar"):
            return w[3:], cls, True
    for p, cls in (("ber", _ID_NO_I), ("per", 0)):
        if w.startswith(p):
            return w[3:], cls, True
    # be- only before consonant+'er' (bekerja -> kerja).
    if (w.startswith("be") and len(w) > 4 and w[2] not in _ID_V
            and w[3:5] == "er"):
        return w[2:], _ID_NO_I, True
    if w.startswith("pe"):
        return w[2:], 0, True
    return w, 0, False


def _id_suffix(w: str, cls: int) -> str:
    if cls != _ID_NO_I_KAN and w.endswith("kan"):
        return w[:-3]
    if cls != _ID_NO_AN and w.endswith("an"):
        return w[:-2]
    if (cls not in (_ID_NO_I, _ID_NO_I_KAN) and w.endswith("i")
            and not w.endswith("si")):
        # -si is protected (the published implementation's guard
        # against stripping the -i of lexical -si endings).
        return w[:-1]
    return w


def stem_id(word: str) -> str:
    w = word
    if _id_measure(w) <= 2:
        return w
    for suf in ("kah", "lah", "pun"):        # inflectional particle
        if w.endswith(suf):
            w = w[:-3]
            break
    if _id_measure(w) <= 2:
        return w
    for suf in ("nya", "ku", "mu"):          # possessive pronoun
        if w.endswith(suf):
            w = w[: -len(suf)]
            break
    if _id_measure(w) <= 2:
        return w
    w1, cls, removed = _id_first_order_prefix(w)
    if removed:
        if _id_measure(w1) <= 2:
            return w1
        w2 = _id_suffix(w1, cls)
        if w2 != w1 and _id_measure(w2) > 2:
            w3, _, rem2 = _id_second_order_prefix(w2)
            if rem2 and _id_measure(w3) > 2:
                return w3
        return w2
    w1, cls, removed = _id_second_order_prefix(w)
    if removed and _id_measure(w1) <= 2:
        return w1
    w2 = _id_suffix(w1, cls)
    return w2


# ---------------------------------------------------------------------------
# Turkish -- affix stripping per the Snowball "turkish" stemmer
# (Kapusuz Cilden, after Eryigit & Adali): strips nominal-verb
# (copular) suffixes, then noun inflection suffixes, each validated by
# vowel harmony between the word's last two vowels and by the
# buffer-letter rules (consonant buffers y/n/s appear only after
# vowels; the buffer vowel U = i/u/etc only after consonants), then
# restores the final consonant (b->p, c->c-cedilla, d->t, g-breve->k).
# The published algorithm encodes the legal suffix chains as a fixed
# grammar; this implementation strips iteratively over the same suffix
# classes with the same per-suffix validation, which produces the same
# stems on inflected nominals.  The append-U-to-d/g-final-stems quirk
# (proper nouns) is deliberately omitted.  Only stems words with more
# than one syllable, like the original.

# The default pipeline folds Turkish letters to ASCII in the
# normalizer BEFORE the stemmer runs (same filter order as the
# reference: ICU Latin-ASCII then libstemmer), so indexed tokens
# arrive as "kitaplari", not "kitapları".  All matching therefore
# happens in FOLDED space -- rules are written in proper orthography
# and folded at module init; input words fold once per call and
# suffixes strip from the original by length (folds are 1:1).  Vowel
# harmony uses folded classes (the union of the proper classes that
# collide under folding), so both orthographies validate identically.

_TR_FOLD = str.maketrans("ıöüçğş", "ioucgs")
_TR_VOWELS_F = "aeiou"     # folded vowels
_TR_U_F = "iu"             # folded U = ı i u ü
# Folded check_vowel_harmony: the word's last vowel -> folded vowels
# allowed as the nearest vowel before it (proper classes a:aıou,
# e:eiöü, ı:aı, i:ei, o/u:ou, ö/ü:öü, unioned under folding).
_TR_HARMONY_F = {
    "a": "aiou", "e": "eiou", "i": "aei", "o": "ou", "u": "ou",
}


def _tr_harmony_ok(wf: str) -> bool:
    i = len(wf) - 1
    while i >= 0 and wf[i] not in _TR_VOWELS_F:
        i -= 1
    if i < 0:
        return False
    v1 = wf[i]
    j = i - 1
    while j >= 0 and wf[j] not in _TR_VOWELS_F:
        j -= 1
    if j < 0:
        return False
    return wf[j] in _TR_HARMONY_F[v1]


# Suffix rule: (variants tuple, buffer, harmony).  ``buffer`` is the
# optional buffer letter preceding the matched variant:
#   'y'/'n'/'s': consume it when present (requiring a vowel before
#     it); when absent the stem must end with a consonant.
#   'U': consume a U vowel when present (requiring a consonant before
#     it); when absent the stem must end with a vowel.
#   None: no constraint on the stem-final letter.
# Variants that embed their buffer (e.g. "nda") use buffer None.
# Each rule group applies AT MOST ONCE per chain (the published
# algorithm encodes legal suffix chains, not a fixpoint loop --
# looping case suffixes would eat roots like "oda").

# Copular person endings (-sUnUz, -nUz, -sUn, -(y)Um, -(y)Uz, -lAr).
_TR_VERB_PERSON = [
    (("sınız", "siniz", "sunuz", "sünüz"), None, True),
    (("nız", "niz", "nuz", "nüz"), None, True),
    (("sın", "sin", "sun", "sün"), None, True),
    (("ım", "im", "um", "üm"), "y", True),
    (("ız", "iz", "uz", "üz"), "y", True),
    (("lar", "ler"), None, True),
]
# Copular tense/mood (-(y)mUş, -(y)DU, -(y)sA, -(y)ken, -cAsInA).
_TR_VERB_TENSE = [
    (("casına", "cesine", "çasına", "çesine"), None, True),
    (("mış", "miş", "muş", "müş"), "y", True),
    (("ken",), "y", True),
    (("dı", "di", "du", "dü", "tı", "ti", "tu", "tü"), "y", True),
    (("sa", "se"), "y", True),
]
_TR_VERB_DUR = [
    (("dır", "dir", "dur", "dür", "tır", "tir", "tur", "tür"),
     None, True),
]
# Case / adverbial suffixes (outermost nominal layer; at most one).
_TR_NOUN_CASE = [
    (("casına", "cesine", "çasına", "çesine"), None, True),  # cAsInA
    (("ndan", "nden"), None, True),                      # (n)DAn
    (("dan", "den", "tan", "ten"), None, True),          # DAn
    (("nda", "nde"), None, True),                        # (n)DA
    (("da", "de", "ta", "te"), None, True),              # DA
    (("nın", "nin", "nun", "nün"), None, True),          # (n)Un
    (("ın", "in", "un", "ün"), "n", True),               # (n)Un bare
    (("la", "le"), "y", True),                           # (y)lA
    (("nca", "nce"), None, True),                        # (n)cA
    (("ca", "ce", "ça", "çe"), None, True),              # cA
    (("na", "ne"), None, True),                          # (n)A
    (("a", "e"), "y", True),                             # (y)A
    (("nı", "ni", "nu", "nü"), None, True),              # (n)U
    (("yı", "yi", "yu", "yü"), None, True),              # (y)U
]
# Possessives (incl. lArI = plural + 3rd possessive; at most one).
_TR_NOUN_POSS = [
    (("ları", "leri"), None, False),                     # lArI
    (("mız", "miz", "muz", "müz"), "U", True),           # (U)mUz
    (("nız", "niz", "nuz", "nüz"), "U", True),           # (U)nUz
    (("sı", "si", "su", "sü"), None, True),              # (s)U
    (("ı", "i", "u", "ü"), None, True),                  # bare U (poss/acc)
    (("m",), "U", True),                                 # (U)m
    (("n",), "U", True),                                 # (U)n
]
_TR_NOUN_PLURAL = [
    (("lar", "ler"), None, True),                        # lAr
]


def _tr_folded(rules):
    """Fold a rule table's variants to ASCII (matching space)."""
    return [(tuple(dict.fromkeys(v.translate(_TR_FOLD) for v in vs)),
             buffer, harmony) for vs, buffer, harmony in rules]


_TR_VERB_PERSON = _tr_folded(_TR_VERB_PERSON)
_TR_VERB_TENSE = _tr_folded(_TR_VERB_TENSE)
_TR_VERB_DUR = _tr_folded(_TR_VERB_DUR)
_TR_NOUN_CASE = _tr_folded(_TR_NOUN_CASE)
_TR_NOUN_POSS = _tr_folded(_TR_NOUN_POSS)
_TR_NOUN_PLURAL = _tr_folded(_TR_NOUN_PLURAL)


def _tr_try_strip(wf: str, rules) -> int:
    """One stripping step over the folded word.  Returns the number of
    characters to strip (0 when no rule applies or the stem would drop
    under two characters / lose its last vowel)."""
    for variants, buffer, harmony in rules:
        if harmony and not _tr_harmony_ok(wf):
            continue
        for suf in variants:
            if not wf.endswith(suf) or len(wf) <= len(suf):
                continue
            stem = wf[: -len(suf)]
            n = 0
            if buffer is None:
                n = len(suf)
            elif buffer == "U":
                # -(U)X: U present after a consonant, absent after a
                # vowel.
                if stem[-1] in _TR_U_F and len(stem) >= 2 \
                        and stem[-2] not in _TR_VOWELS_F:
                    n = len(suf) + 1
                elif stem[-1] in _TR_VOWELS_F:
                    n = len(suf)
            else:
                # Consonant buffer: present after a vowel, absent
                # after a consonant.
                if stem[-1] in buffer and len(stem) >= 2 \
                        and stem[-2] in _TR_VOWELS_F:
                    n = len(suf) + 1
                elif stem[-1] not in _TR_VOWELS_F \
                        and stem[-1] not in buffer:
                    n = len(suf)
            if n:
                out = wf[:-n]
                if len(out) < 2 or not any(
                        c in _TR_VOWELS_F for c in out):
                    continue
                return n
    return 0


def _tr_ki(wf: str, depth: int) -> bool:
    """A -ki relative restarts the nominal chain ("evdeki",
    "evdekilerden"), like stem_suffix_chain_after_ki.  Requires two
    vowels in the remainder so roots that merely end in "ki" ("iki",
    "eski") survive."""
    return (depth < 4 and wf.endswith("ki") and len(wf) > 3
            and sum(1 for c in wf[:-2] if c in _TR_VOWELS_F) >= 2)


def _tr_noun_chain(w: str, wf: str, depth: int = 0) -> str:
    """One legal nominal suffix chain, outermost first: [case]
    [possessive] [plural], with -ki restarting the chain."""
    if _tr_ki(wf, depth):
        return _tr_noun_chain(w[:-2], wf[:-2], depth + 1)
    for stage in (_TR_NOUN_CASE, _TR_NOUN_POSS, _TR_NOUN_PLURAL):
        n = _tr_try_strip(wf, stage)
        if n:
            w, wf = w[:-n], wf[:-n]
        if _tr_ki(wf, depth):
            return _tr_noun_chain(w[:-2], wf[:-2], depth + 1)
    return w


# Final-consonant restoration: suffixation voices a stem-final stop
# (kitap -> kitabı), so stripped stems devoice back to match the bare
# form.  In folded space c/ç and g/ğ already collide, so only b/d
# need mapping there; proper orthography restores all four.
_TR_LAST_PROPER = {"b": "p", "c": "ç", "d": "t", "ğ": "k"}
_TR_LAST_FOLDED = {"b": "p", "d": "t"}


def stem_tr(word: str) -> str:
    # remove_proper_noun_suffix: drop everything from an apostrophe on
    # ("istanbul'da" -> "istanbul").
    for apo in ("'", "’"):
        cut = word.find(apo)
        if cut > 1:
            word = word[:cut]
            break
    wf = word.translate(_TR_FOLD)
    # more_than_one_syllable guard.
    if sum(1 for c in wf if c in _TR_VOWELS_F) <= 1:
        return word
    w = word
    # Copular (nominal verb) layer: person / tense / -DUr, each at
    # most once, in whichever surface order they appear
    # ("evdeymişsiniz", "evdedirler", "evdelerdi").
    stages = [_TR_VERB_PERSON, _TR_VERB_TENSE, _TR_VERB_DUR]
    for _ in range(len(stages)):
        for stage in list(stages):
            n = _tr_try_strip(wf, stage)
            if n:
                w, wf = w[:-n], wf[:-n]
                stages.remove(stage)
                break
        else:
            break
    w = _tr_noun_chain(w, wf)
    if w != word:
        table = _TR_LAST_PROPER if w != w.translate(_TR_FOLD) \
            else _TR_LAST_FOLDED
        last = table.get(w[-1:])
        if last is not None:
            w = w[:-1] + last
    return w


# ---------------------------------------------------------------------------
# Dispatch

# ---------------------------------------------------------------------------
# Finnish (snowballstem.org/algorithms/finnish/stemmer.html)
#
# Tables and branch semantics mirror the published algorithm as ported
# by NLTK (the oracle tests/test_snowball.py checks against); regions
# are kept as indexes rather than string slices.

_FI_V = "aeiouyäö"
_FI_RESTR_V = "aeiouäö"
_FI_LONG_V = ("aa", "ee", "ii", "oo", "uu", "ää", "öö")
_FI_C = "bcdfghjklmnpqrstvwxz"
_FI_DOUBLE_C = ("bb", "cc", "dd", "ff", "gg", "hh", "jj", "kk", "ll",
                "mm", "nn", "pp", "qq", "rr", "ss", "tt", "vv", "ww",
                "xx", "zz")
_FI_STEP1 = ("kaan", "kään", "sti", "kin", "han", "hän", "ko", "kö",
             "pa", "pä")
_FI_STEP2 = ("nsa", "nsä", "mme", "nne", "si", "ni", "an", "än", "en")
_FI_STEP3 = ("siin", "tten", "seen", "han", "hen", "hin", "hon", "hän",
             "hön", "den", "tta", "ttä", "ssa", "ssä", "sta", "stä",
             "lla", "llä", "lta", "ltä", "lle", "ksi", "ine", "ta",
             "tä", "na", "nä", "a", "ä", "n")
_FI_STEP4 = ("impi", "impa", "impä", "immi", "imma", "immä", "mpi",
             "mpa", "mpä", "mmi", "mma", "mmä", "eja", "ejä")
_FI_H_VOWEL = {"han": "a", "hen": "e", "hin": "i", "hon": "o",
               "hän": "ä", "hön": "ö"}


def stem_fi(word: str) -> str:
    r1, r2 = _r1r2(word, _FI_V)
    step3_ok = False

    # Step 1: particles (first match in table order; a failed branch
    # condition still ends the step).
    for suf in _FI_STEP1:
        if not _in_r(word, suf, r1) or not word.endswith(suf):
            continue
        if suf == "sti":
            if _in_r(word, suf, r2):
                word = word[:-3]
        elif word[-len(suf) - 1] in "ntaeiouyäö":
            word = word[: -len(suf)]
        break

    # Step 2: possessives.
    for suf in _FI_STEP2:
        if not _in_r(word, suf, r1) or not word.endswith(suf):
            continue
        if suf == "si":
            if word[-3] != "k":
                word = word[:-2]
        elif suf == "ni":
            word = word[:-2]
            if word.endswith("kse"):
                word = word[:-3] + "ksi"
        elif suf == "an":
            if word[-4:-2] in ("ta", "na") \
                    or word[-5:-2] in ("ssa", "sta", "lla", "lta"):
                word = word[:-2]
        elif suf == "än":
            if word[-4:-2] in ("tä", "nä") \
                    or word[-5:-2] in ("ssä", "stä", "llä", "ltä"):
                word = word[:-2]
        elif suf == "en":
            if word[-5:-2] in ("lle", "ine"):
                word = word[:-2]
        else:
            word = word[:-3]
        break

    # Step 3: cases.
    for suf in _FI_STEP3:
        if not _in_r(word, suf, r1) or not word.endswith(suf):
            continue
        if suf in _FI_H_VOWEL:
            if word[-4] == _FI_H_VOWEL[suf]:
                word = word[:-3]
                step3_ok = True
        elif suf in ("siin", "den", "tten"):
            if (word[-len(suf) - 1] == "i"
                    and word[-len(suf) - 2] in _FI_RESTR_V):
                word = word[: -len(suf)]
                step3_ok = True
            else:
                continue
        elif suf == "seen":
            if word[-6:-4] in _FI_LONG_V:
                word = word[:-4]
                step3_ok = True
            else:
                continue
        elif suf in ("a", "ä"):
            if word[-2] in _FI_V and word[-3] in _FI_C:
                word = word[:-1]
                step3_ok = True
        elif suf in ("tta", "ttä"):
            if word[-4] == "e":
                word = word[:-3]
                step3_ok = True
        elif suf == "n":
            word = word[:-1]
            step3_ok = True
            if word[-2:] == "ie" or word[-2:] in _FI_LONG_V:
                word = word[:-1]
        else:
            word = word[: -len(suf)]
            step3_ok = True
        break

    # Step 4: other endings (matched within R2).
    for suf in _FI_STEP4:
        if not _in_r(word, suf, r2) or not word.endswith(suf):
            continue
        if suf in ("mpi", "mpa", "mpä", "mmi", "mma", "mmä"):
            if word[-5:-3] != "po":
                word = word[:-3]
        else:
            word = word[: -len(suf)]
        break

    # Step 5: plurals.
    if step3_ok and len(word) > r1 and word[-1] in "ij":
        word = word[:-1]
    elif (not step3_ok and len(word) - r1 >= 2
          and word[-1] == "t" and word[-2] in _FI_V):
        word = word[:-1]
        if _in_r(word, "imma", r2) and word.endswith("imma"):
            word = word[:-4]
        elif (_in_r(word, "mma", r2) and word.endswith("mma")
              and word[-5:-3] != "po"):
            word = word[:-3]

    # Step 6: tidying.
    if len(word) - r1 >= 2 and word[-2:] in _FI_LONG_V:
        word = word[:-1]
    if (len(word) - r1 >= 2 and word[-2] in _FI_C
            and word[-1] in "aäei"):
        word = word[:-1]
    if len(word) - r1 >= 2 and word[-2:] in ("oj", "uj"):
        word = word[:-1]
    if len(word) - r1 >= 2 and word[-2:] == "jo":
        word = word[:-1]

    # Final double consonant followed by zero or more vowels -> single.
    for i in range(1, len(word)):
        if word[-i] in _FI_V:
            continue
        if i == 1:
            if word[-2:] in _FI_DOUBLE_C:
                word = word[:-1]
        elif word[-i - 1: -i + 1] in _FI_DOUBLE_C:
            word = word[:-i] + word[-i + 1:]
        break
    return word


# ---------------------------------------------------------------------------
# Hungarian (snowballstem.org/algorithms/hungarian/stemmer.html)

_HU_V = "aeiouöüáéíóõúû"
_HU_DIGRAPHS = ("cs", "dz", "dzs", "gy", "ly", "ny", "ty", "zs")
_HU_DOUBLE_C = ("bb", "cc", "ccs", "dd", "ff", "gg", "ggy", "jj", "kk",
                "ll", "lly", "mm", "nn", "nny", "pp", "rr", "ss",
                "ssz", "tt", "tty", "vv", "zz", "zzs")
_HU_STEP2 = ("képpen", "onként", "enként", "anként", "képp", "ként",
             "ban", "ben", "nak", "nek", "val", "vel", "tól", "tõl",
             "ról", "rõl", "ból", "bõl", "hoz", "hez", "höz", "nál",
             "nél", "ért", "kor", "ba", "be", "ra", "re", "ig", "at",
             "et", "ot", "öt", "ul", "ül", "vá", "vé", "en", "on",
             "an", "ön", "n", "t")
_HU_STEP3 = ("ánként", "án", "én")
_HU_STEP4 = ("astul", "estül", "ástul", "éstül", "stul", "stül")
_HU_STEP6 = ("oké", "öké", "aké", "eké", "áké", "áéi", "éké", "ééi",
             "ké", "éi", "éé", "é")
_HU_STEP7 = ("ájuk", "éjük", "ünk", "unk", "juk", "jük", "ánk", "énk",
             "nk", "uk", "ük", "em", "om", "am", "od", "ed", "ad",
             "öd", "ja", "je", "ám", "ád", "ém", "éd", "m", "d", "a",
             "e", "o", "á", "é")
_HU_STEP8 = ("jaitok", "jeitek", "jaink", "jeink", "aitok", "eitek",
             "áitok", "éitek", "jaim", "jeim", "jaid", "jeid", "eink",
             "aink", "itek", "jeik", "jaik", "áink", "éink", "aim",
             "eim", "aid", "eid", "jai", "jei", "ink", "aik", "eik",
             "áim", "áid", "áik", "éim", "éid", "éik", "im", "id",
             "ai", "ei", "ik", "ái", "éi", "i")
_HU_STEP9 = ("ák", "ék", "ök", "ok", "ek", "ak", "k")


def _hu_r1(word: str) -> int:
    """Hungarian R1: after the first consonant/digraph if the word
    begins with a vowel, else after the first vowel.  Digraph scan
    semantics follow the oracle port (first digraph in table order
    anywhere past position 0; region starts after the first
    occurrence of its final letter)."""
    if not word:
        return 0
    if word[0] in _HU_V:
        for d in _HU_DIGRAPHS:
            if d in word[1:]:
                return word.index(d[-1]) + 1
        for i in range(1, len(word)):
            if word[i] not in _HU_V:
                return i + 1
        return len(word)
    for i in range(1, len(word)):
        if word[i] in _HU_V:
            return i + 1
    return len(word)


def stem_hu(word: str) -> str:
    r1 = _hu_r1(word)

    # Step 1: instrumental case (undouble before 'al'/'el' in R1).
    if word.endswith(("al", "el")) and len(word) - 2 >= r1:
        for dc in _HU_DOUBLE_C:
            if word[-2 - len(dc): -2] == dc:
                word = word[:-4] + word[-3]
                break

    # Step 2: frequent cases; final á/é in R1 shortens.
    for suf in _HU_STEP2:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word = word[: -len(suf)]
                if word.endswith("á") and len(word) - 1 >= r1:
                    word = word[:-1] + "a"
                elif word.endswith("é") and len(word) - 1 >= r1:
                    word = word[:-1] + "e"
            break

    # Step 3: special cases.
    for suf in _HU_STEP3:
        if word.endswith(suf) and len(word) - len(suf) >= r1:
            word = word[: -len(suf)] + ("e" if suf == "én" else "a")
            break

    # Step 4: other cases.
    for suf in _HU_STEP4:
        if word.endswith(suf) and len(word) - len(suf) >= r1:
            if suf == "ástul":
                word = word[:-5] + "a"
            elif suf == "éstül":
                word = word[:-5] + "e"
            else:
                word = word[: -len(suf)]
            break

    # Step 5: factive case (undouble before final á/é in R1).
    if word.endswith(("á", "é")) and len(word) - 1 >= r1:
        for dc in _HU_DOUBLE_C:
            if word[-1 - len(dc): -1] == dc:
                word = word[:-3] + word[-2]
                break

    # Step 6: owned.
    for suf in _HU_STEP6:
        if word.endswith(suf) and len(word) - len(suf) >= r1:
            if suf in ("áké", "áéi"):
                word = word[:-3] + "a"
            elif suf in ("éké", "ééi", "éé"):
                word = word[: -len(suf)] + "e"
            else:
                word = word[: -len(suf)]
            break

    # Step 7: singular owner suffixes.
    for suf in _HU_STEP7:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                if suf in ("ánk", "ájuk", "ám", "ád", "á"):
                    word = word[: -len(suf)] + "a"
                elif suf in ("énk", "éjük", "ém", "éd", "é"):
                    word = word[: -len(suf)] + "e"
                else:
                    word = word[: -len(suf)]
            break

    # Step 8: plural owner suffixes.
    for suf in _HU_STEP8:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                if suf in ("áim", "áid", "ái", "áink", "áitok", "áik"):
                    word = word[: -len(suf)] + "a"
                elif suf in ("éim", "éid", "éi", "éink", "éitek",
                             "éik"):
                    word = word[: -len(suf)] + "e"
                else:
                    word = word[: -len(suf)]
            break

    # Step 9: plural suffixes.
    for suf in _HU_STEP9:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                if suf == "ák":
                    word = word[:-2] + "a"
                elif suf == "ék":
                    word = word[:-2] + "e"
                else:
                    word = word[: -len(suf)]
            break
    return word


# ---------------------------------------------------------------------------
# Romanian (snowballstem.org/algorithms/romanian/stemmer.html)

_RO_V = "aeiouăâî"
_RO_STEP0 = ("iilor", "ului", "elor", "iile", "ilor", "atei", "aţie",
             "aţia", "aua", "ele", "iua", "iei", "ile", "ul", "ea",
             "ii")
_RO_STEP1 = ("abilitate", "abilitati", "abilităţi", "ibilitate",
             "abilităi", "ivitate", "ivitati", "ivităţi", "icitate",
             "icitati", "icităţi", "icatori", "ivităi", "icităi",
             "icator", "aţiune", "atoare", "ătoare", "iţiune",
             "itoare", "iciva", "icive", "icivi", "icivă", "icala",
             "icale", "icali", "icală", "ativa", "ative", "ativi",
             "ativă", "atori", "ători", "itiva", "itive", "itivi",
             "itivă", "itori", "iciv", "ical", "ativ", "ator", "ător",
             "itiv", "itor")
_RO_STEP1_MAP = {}
for _s in ("abilitate", "abilitati", "abilităi", "abilităţi"):
    _RO_STEP1_MAP[_s] = "abil"
for _s in ("ivitate", "ivitati", "ivităi", "ivităţi"):
    _RO_STEP1_MAP[_s] = "iv"
for _s in ("icitate", "icitati", "icităi", "icităţi", "icator",
           "icatori", "iciv", "iciva", "icive", "icivi", "icivă",
           "ical", "icala", "icale", "icali", "icală"):
    _RO_STEP1_MAP[_s] = "ic"
for _s in ("ativ", "ativa", "ative", "ativi", "ativă", "aţiune",
           "atoare", "ator", "atori", "ătoare", "ător", "ători"):
    _RO_STEP1_MAP[_s] = "at"
for _s in ("itiv", "itiva", "itive", "itivi", "itivă", "iţiune",
           "itoare", "itor", "itori"):
    _RO_STEP1_MAP[_s] = "it"
del _s
_RO_STEP2 = ("abila", "abile", "abili", "abilă", "ibila", "ibile",
             "ibili", "ibilă", "atori", "itate", "itati", "ităţi",
             "abil", "ibil", "oasa", "oasă", "oase", "anta", "ante",
             "anti", "antă", "ator", "ităi", "iune", "iuni", "isme",
             "ista", "iste", "isti", "istă", "işti", "ata", "ată",
             "ati", "ate", "uta", "ută", "uti", "ute", "ita", "ită",
             "iti", "ite", "ica", "ice", "ici", "ică", "osi", "oşi",
             "ant", "iva", "ive", "ivi", "ivă", "ism", "ist", "at",
             "ut", "it", "ic", "os", "iv")
_RO_STEP3 = ("seserăţi", "aserăţi", "iserăţi", "âserăţi", "userăţi",
             "seserăm", "aserăm", "iserăm", "âserăm", "userăm",
             "serăţi", "seseşi", "seseră", "ească", "arăţi", "urăţi",
             "irăţi", "ârăţi", "aseşi", "aseră", "iseşi", "iseră",
             "âseşi", "âseră", "useşi", "useră", "serăm", "sesem",
             "indu", "ându", "ează", "eşti", "eşte", "ăşti", "ăşte",
             "eaţi", "iaţi", "arăm", "urăm", "irăm", "ârăm", "asem",
             "isem", "âsem", "usem", "seşi", "seră", "sese", "are",
             "ere", "ire", "âre", "ind", "ând", "eze", "ezi", "esc",
             "ăsc", "eam", "eai", "eau", "iam", "iai", "iau", "aşi",
             "ară", "uşi", "ură", "işi", "iră", "âşi", "âră", "ase",
             "ise", "âse", "use", "aţi", "eţi", "iţi", "âţi", "sei",
             "ez", "am", "ai", "au", "ea", "ia", "ui", "âi", "ăm",
             "em", "im", "âm", "se")
_RO_STEP3_SIMPLE = ("seserăţi", "seserăm", "serăţi", "seseşi",
                    "seseră", "serăm", "sesem", "seşi", "seră",
                    "sese", "aţi", "eţi", "iţi", "âţi", "sei", "ăm",
                    "em", "im", "âm", "se")


def _ro_rv(word: str) -> int:
    """Standard RV as an index (oracle semantics: '' when the pattern
    never completes)."""
    n = len(word)
    if n < 2:
        return n
    if word[1] not in _RO_V:
        for i in range(2, n):
            if word[i] in _RO_V:
                return i + 1
        return n
    if word[0] in _RO_V and word[1] in _RO_V:
        for i in range(2, n):
            if word[i] not in _RO_V:
                return i + 1
        return n
    return min(3, n)


def stem_ro(word: str) -> str:
    # i/u between vowels mark as consonants (restored at the end).
    w = list(word)
    for i in range(1, len(w) - 1):
        if w[i - 1] in _RO_V and w[i + 1] in _RO_V:
            if w[i] == "u":
                w[i] = "U"
            elif w[i] == "i":
                w[i] = "I"
    word = "".join(w)
    r1, r2 = _r1r2(word, _RO_V)
    rv = _ro_rv(word)
    step1_ok = False
    step2_ok = False

    # Step 0: plurals and simplifications.
    for suf in _RO_STEP0:
        if word.endswith(suf):
            if _in_r(word, suf, r1):
                if suf in ("ul", "ului"):
                    word = word[: -len(suf)]
                elif (suf in ("aua", "atei")
                      or (suf == "ile" and word[-5:-3] != "ab")):
                    word = word[:-2]
                elif suf in ("ea", "ele", "elor"):
                    word = word[: -len(suf)] + "e"
                elif suf in ("ii", "iua", "iei", "iile", "iilor",
                             "ilor"):
                    word = word[: -len(suf)] + "i"
                elif suf in ("aţie", "aţia"):
                    word = word[:-1]
            break

    # Step 1: combining suffixes, repeated until nothing matches.
    while True:
        replaced = False
        for suf in _RO_STEP1:
            if word.endswith(suf):
                if _in_r(word, suf, r1):
                    step1_ok = True
                    replaced = True
                    if suf == "ibilitate":
                        word = word[:-5]
                    else:
                        word = word[: -len(suf)] + _RO_STEP1_MAP[suf]
                else:
                    step1_ok = False
                break
        if not replaced:
            break

    # Step 2: standard suffixes (within R2).
    for suf in _RO_STEP2:
        if word.endswith(suf):
            if _in_r(word, suf, r2):
                step2_ok = True
                if suf in ("iune", "iuni"):
                    if word[-5] == "ţ":
                        word = word[:-5] + "t"
                elif suf in ("ism", "isme", "ist", "ista", "iste",
                             "isti", "istă", "işti"):
                    word = word[: -len(suf)] + "ist"
                else:
                    word = word[: -len(suf)]
            break

    # Step 3: verb suffixes (within RV), only when steps 1-2 did
    # nothing.  The non-simple group also needs a non-vowel (or word
    # start is rejected) before the suffix's first in-RV occurrence --
    # oracle semantics preserved.
    if not step1_ok and not step2_ok:
        rv_str = word[rv:]
        for suf in _RO_STEP3:
            if word.endswith(suf):
                if suf in rv_str:
                    if suf in _RO_STEP3_SIMPLE:
                        word = word[: -len(suf)]
                        rv_str = rv_str[: -len(suf)]
                    else:
                        at = rv_str.index(suf)
                        if at > 0 and rv_str[at - 1] not in "aeioăâî":
                            word = word[: -len(suf)]
                    break

    # Step 4: final vowel (within RV).
    rv_str = word[rv:]
    for suf in ("ie", "a", "e", "i", "ă"):
        if word.endswith(suf):
            if suf in rv_str:
                word = word[: -len(suf)]
            break

    return word.replace("I", "i").replace("U", "u")


# ---------------------------------------------------------------------------
# Arabic (the Snowball Arabic light stemmer, stem_Unicode.sbl)

import re as _re

# NOTE: the published stemmer's character classes include a literal
# ASCII hyphen (an artifact of how its ranges are written); kept for
# bit-parity with the oracle.
_AR_DIACRITICS = _re.compile("[ً-ْ-]")
_AR_KASHEEDA = _re.compile("[ـ]")
_AR_PUNCT = _re.compile("[،-؛؟-]")
_AR_LAST_HAMZAT = ("أ", "إ", "آ", "ؤ", "ئ")
_AR_INITIAL_HAMZAT = _re.compile("^[آأإ]")
_AR_ALEFAT = _re.compile("[أآإ]")

_AR_ARTICLES_3 = ("كال", "بال")
_AR_ARTICLES_2 = ("ال", "لل")

_AR_SUF_VERB_1 = ("ه", "ك", "ني", "نا",
                  "ها", "هم", "هن",
                  "كم", "كن",
                  "هما", "كما",
                  "كمو")
_AR_CONJ_VERB_1 = ("ه", "ك")
_AR_CONJ_VERB_2 = ("ني", "نا", "ها",
                   "هم", "هن", "كم",
                   "كن")
_AR_CONJ_VERB_3 = ("هما", "كما",
                   "كمو")
_AR_SUF_VERB_2A = ("ت", "ا", "ن", "ي",
                   "نا", "تا", "تن",
                   "ان", "ون", "ين",
                   "تما")
_AR_CONJ_VERB_4 = ("ا", "ن", "ي")
_AR_CONJ_PAST = ("نا", "تا", "تن")
_AR_CONJ_PRESENT = ("ان", "ون", "ين")
_AR_SUF_VERB_2B = ("وا", "تم")
_AR_SUF_VERB_2C = ("و", "تمو")
_AR_SUF_NOUN_1A = ("ي", "ك", "ه", "نا",
                   "كم", "ها", "هن",
                   "هم", "كما",
                   "هما")
_AR_CONJ_NOUN_1 = ("ي", "ك", "ه")
_AR_CONJ_NOUN_2 = ("نا", "كم", "ها",
                   "هن", "هم")
_AR_CONJ_NOUN_3 = ("كما", "هما")
_AR_SUF_NOUN_2A = ("ا", "ي", "و")
_AR_PFX_STEP1 = {
    "أأ": "أ", "أآ": "آ",
    "أؤ": "ؤ", "أا": "ا",
    "أإ": "إ",
}
_AR_PFX_2A = ("فال", "وال")
_AR_PFX_2B = ("ف", "و")
_AR_PFX_1 = ("وا", "فا")
_AR_PFX_3A = _AR_ARTICLES_2 + _AR_ARTICLES_3
_AR_PREP_1 = ("ك", "ل")
_AR_PREP_2 = ("بب", "كك")
_AR_PFX_3B = ("ب",) + _AR_PREP_1 + _AR_PREP_2
_AR_PFX_3_VERB = ("سي", "ست", "سن",
                  "سأ")
_AR_PFX_4_VERB = ("يست", "نست",
                  "تست")


def stem_ar(word: str) -> str:
    is_verb = True
    is_noun = True
    is_defined = False

    # Type guesses on the raw token.
    for p in (_AR_ARTICLES_3 + _AR_ARTICLES_2):
        if word.startswith(p):
            if p in _AR_ARTICLES_3 and len(word) > 4:
                is_noun, is_verb, is_defined = True, False, True
                break
            if p in _AR_ARTICLES_2 and len(word) > 3:
                is_noun, is_verb, is_defined = True, False, True
                break
    if word.endswith("ة") and len(word) > 2:
        is_noun, is_verb = True, False
    elif word.endswith("ات") and len(word) > 3:
        is_noun, is_verb = True, False

    # Pre-normalization: strip diacritics, kasheeda, punctuation.
    w = _AR_DIACRITICS.sub("", word)
    w = _AR_KASHEEDA.sub("", w)
    w = _AR_PUNCT.sub("", w)
    if len(w) <= 2:
        return w

    verb1_ok = verb2a_ok = verb2b_ok = False
    noun2c2_ok = noun2a_ok = noun2b_ok = noun1b_ok = False

    def verb_step2a(w):
        nonlocal verb2a_ok
        for suf in _AR_SUF_VERB_2A:
            if w.endswith(suf) and len(w) > 3:
                if suf == "ت" and len(w) >= 4:
                    verb2a_ok = True
                    return w[:-1]
                if suf in _AR_CONJ_VERB_4 and len(w) >= 4:
                    verb2a_ok = True
                    return w[:-1]
                if suf in _AR_CONJ_PAST and len(w) >= 5:
                    verb2a_ok = True
                    return w[:-2]
                if suf in _AR_CONJ_PRESENT and len(w) > 5:
                    verb2a_ok = True
                    return w[:-2]
                if suf == "تما" and len(w) >= 6:
                    verb2a_ok = True
                    return w[:-3]
        return w

    def noun_step2a(w):
        nonlocal noun2a_ok
        for suf in _AR_SUF_NOUN_2A:
            if w.endswith(suf) and len(w) > 4:
                noun2a_ok = True
                return w[:-1]
        return w

    def noun_step2b(w):
        # Oracle quirk (kept for parity): the ات table is iterated
        # per CHARACTER, so a final ا or ت matches -- and the
        # removal is still two characters.
        nonlocal noun2b_ok
        for ch in ("ا", "ت"):
            if w.endswith(ch) and len(w) >= 5:
                noun2b_ok = True
                return w[:-2]
        return w

    def noun_step2c1(w):
        if w.endswith("ت") and len(w) >= 4:
            return w[:-1]
        return w

    if is_verb:
        for suf in _AR_SUF_VERB_1:
            if w.endswith(suf):
                if suf in _AR_CONJ_VERB_1 and len(w) >= 4:
                    w = w[:-1]
                    verb1_ok = True
                    break
                if suf in _AR_CONJ_VERB_2 and len(w) >= 5:
                    w = w[:-2]
                    verb1_ok = True
                    break
                if suf in _AR_CONJ_VERB_3 and len(w) >= 6:
                    w = w[:-3]
                    verb1_ok = True
                    break
        if verb1_ok:
            w = verb_step2a(w)
            if not verb2a_ok:
                # step 2c
                if w.endswith("تمو") and len(w) >= 6:
                    w = w[:-3]
                elif w.endswith("و") and len(w) >= 4:
                    w = w[:-1]
        else:
            for suf in _AR_SUF_VERB_2B:
                if w.endswith(suf) and len(w) >= 5:
                    w = w[:-2]
                    verb2b_ok = True
                    break
            if not verb2b_ok:
                w = verb_step2a(w)

    if is_noun:
        if w.endswith("ة") and len(w) >= 3:
            w = w[:-1]
            noun2c2_ok = True
        if not noun2c2_ok:
            if not is_defined:
                for suf in _AR_SUF_NOUN_1A:
                    if w.endswith(suf):
                        if suf in _AR_CONJ_NOUN_1 and len(w) >= 4:
                            w = w[:-1]
                            break
                        if suf in _AR_CONJ_NOUN_2 and len(w) >= 5:
                            w = w[:-2]
                            break
                        if suf in _AR_CONJ_NOUN_3 and len(w) >= 6:
                            w = w[:-3]
                            break
                w = noun_step2a(w)
                if not noun2a_ok:
                    w = noun_step2b(w)
                if not noun2b_ok and not noun2a_ok:
                    w = noun_step2c1(w)
            else:
                if w.endswith("ن") and len(w) > 5:
                    w = w[:-1]
                    noun1b_ok = True
                if noun1b_ok:
                    w = noun_step2a(w)
                    if not noun2a_ok:
                        w = noun_step2b(w)
                    if not noun2b_ok and not noun2a_ok:
                        w = noun_step2c1(w)
                else:
                    if not is_defined:
                        w = noun_step2a(w)
                    w = noun_step2b(w)
        if w.endswith("ي") and len(w) >= 3:
            w = w[:-1]                      # ya' nisbiya
    if not is_noun and is_verb:
        if w.endswith("ى"):
            w = w[:-1] + "ي"           # alef maqsura -> yeh

    # Prefixes.
    for p, rep in _AR_PFX_STEP1.items():
        if w.startswith(p) and len(w) > 3:
            w = rep + w[len(p):]
            break
    pfx2a_ok = False
    for p in _AR_PFX_2A:
        if w.startswith(p) and len(w) > 5:
            w = w[len(p):]
            pfx2a_ok = True
            break
    if not pfx2a_ok:
        for p in _AR_PFX_2B:
            if w.startswith(p) and len(w) > 3:
                if w[:2] not in _AR_PFX_1:
                    w = w[len(p):]
                break
    pfx3a_ok = False
    for p in _AR_PFX_3A:
        if w.startswith(p):
            if p in _AR_ARTICLES_2 and len(w) > 4:
                w = w[len(p):]
                pfx3a_ok = True
                break
            if p in _AR_ARTICLES_3 and len(w) > 5:
                w = w[len(p):]
                break
    pfx3b_ok = False
    if not pfx3a_ok and is_noun:
        for p in _AR_PFX_3B:
            if w.startswith(p):
                if len(w) > 3:
                    if p == "ب":
                        w = w[len(p):]
                        pfx3b_ok = True
                        break
                    if p in _AR_PREP_2:
                        w = p[1] + w[len(p):]
                        pfx3b_ok = True
                        break
                if p in _AR_PREP_1 and len(w) > 4:
                    w = w[len(p):]
                    pfx3b_ok = True
                    break
    elif not pfx3b_ok and is_verb:
        for p in _AR_PFX_3_VERB:
            if w.startswith(p) and len(w) > 4:
                w = p[1] + w[len(p):]
                break
        for p in _AR_PFX_4_VERB:
            if w.startswith(p) and len(w) > 4:
                w = "است" + w[len(p):]
                break

    # Post-normalization: hamza forms.
    for h in _AR_LAST_HAMZAT:
        if w.endswith(h):
            w = w[: -len(h)] + "ء"
            break
    w = _AR_INITIAL_HAMZAT.sub("ا", w)
    w = w.replace("ؤ", "و").replace("ئ", "ي")
    w = _AR_ALEFAT.sub("ا", w)
    return w


_STEMMERS: dict[str, Callable[[str], str]] = {
    "en": porter2.stem,
    "da": stem_da,
    "sv": stem_sv,
    "no": stem_no,
    "nb": stem_no,
    "nn": stem_no,
    "de": stem_de,
    "ru": stem_ru,
    "nl": stem_nl,
    "fr": stem_fr,
    "es": stem_es,
    "it": stem_it,
    "pt": stem_pt,
    "hi": stem_hi,
    "id": stem_id,
    "tr": stem_tr,
    "fi": stem_fi,
    "hu": stem_hu,
    "ro": stem_ro,
    "ar": stem_ar,
}

_ALIASES = {
    "danish": "da", "swedish": "sv", "norwegian": "no", "german": "de",
    "russian": "ru", "english": "en", "dutch": "nl", "french": "fr",
    "spanish": "es", "italian": "it", "portuguese": "pt",
    "finnish": "fi", "hungarian": "hu", "romanian": "ro", "arabic": "ar",
    "hindi": "hi", "indonesian": "id", "turkish": "tr",
}

def get_stemmer(lang: str) -> Optional[Callable[[str], str]]:
    """Stemmer for a language code/name, or None when unsupported
    (the caller passes tokens through, like sb_stemmer_new -> NULL)."""
    lang = (lang or "").lower()
    lang = _ALIASES.get(lang, lang)
    fn = _STEMMERS.get(lang)
    if fn is None:
        return None
    # Tokens repeat heavily within and across documents: memoize.
    return lru_cache(maxsize=65536)(fn)
