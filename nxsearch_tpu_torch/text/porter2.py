"""Porter2 (Snowball "english") stemming algorithm.

The reference stems via libstemmer's Snowball ``english`` stemmer
(src/core/filters_builtin.c:206-245).  This is a from-scratch
implementation of the published Porter2 algorithm
(https://snowballstem.org/algorithms/english/stemmer.html), producing
identical stems for the language the tests exercise.

The stemmer expects lowercase input (the default filter pipeline runs
the normalizer first, matching the reference pipeline ordering).
"""

from __future__ import annotations

_VOWELS = frozenset("aeiouy")
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_ENDING = frozenset("cdeghkmnrt")

# Word-level exceptional forms (applied before the algorithm).
_EXCEPTIONS = {
    "skis": "ski", "skies": "sky",
    "dying": "die", "lying": "lie", "tying": "tie",
    "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl",
    "sky": "sky", "news": "news", "howe": "howe",
    "atlas": "atlas", "cosmos": "cosmos", "bias": "bias", "andes": "andes",
}

# Invariant forms after step 1a.
_EXCEPTIONS_1A = frozenset((
    "inning", "outing", "canning", "herring", "earring",
    "proceed", "exceed", "succeed",
))


def _is_vowel(word: str, i: int) -> bool:
    return word[i] in _VOWELS and word[i] != "Y"


def _regions(word: str) -> tuple[int, int]:
    """Compute (R1, R2) start offsets."""
    n = len(word)
    r1 = n
    # Special prefixes fix R1 (per the algorithm definition).
    for prefix in ("gener", "commun", "arsen"):
        if word.startswith(prefix):
            r1 = len(prefix)
            break
    else:
        for i in range(1, n):
            if not _is_vowel(word, i) and _is_vowel(word, i - 1):
                r1 = i + 1
                break
    r2 = n
    for i in range(r1 + 1, n):
        if not _is_vowel(word, i) and _is_vowel(word, i - 1):
            r2 = i + 1
            break
    return r1, r2


def _ends_short_syllable(word: str) -> bool:
    """True if the word ends in a short syllable."""
    n = len(word)
    if n == 2:
        # (b) vowel at the beginning followed by a non-vowel.
        return _is_vowel(word, 0) and not _is_vowel(word, 1)
    if n >= 3:
        # (a) non-vowel, vowel, non-vowel other than w/x/Y.
        return (not _is_vowel(word, n - 3)
                and _is_vowel(word, n - 2)
                and not _is_vowel(word, n - 1)
                and word[n - 1] not in "wxY")
    return False


def _is_short(word: str, r1: int) -> bool:
    return r1 >= len(word) and _ends_short_syllable(word)


def _has_vowel(word: str, end: int) -> bool:
    """True if word[:end] contains a vowel."""
    for i in range(end):
        if _is_vowel(word, i):
            return True
    return False


def stem(word: str) -> str:
    if len(word) <= 2:
        return word

    exceptional = _EXCEPTIONS.get(word)
    if exceptional is not None:
        return exceptional

    # Prelude: strip an initial apostrophe; mark consonant-y as Y.
    if word.startswith("'"):
        word = word[1:]
        if len(word) <= 2:
            return word
    chars = list(word)
    if chars[0] == "y":
        chars[0] = "Y"
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS and chars[i - 1] != "Y":
            chars[i] = "Y"
    word = "".join(chars)

    r1, r2 = _regions(word)

    # --- Step 0: longest among ' 's 's' --------------------------------
    for suf in ("'s'", "'s", "'"):
        if word.endswith(suf):
            word = word[: -len(suf)]
            break

    # --- Step 1a ---------------------------------------------------------
    if word.endswith("sses"):
        word = word[:-2]
    elif word.endswith("ied") or word.endswith("ies"):
        word = word[:-3] + ("i" if len(word) > 4 else "ie")
    elif word.endswith("us") or word.endswith("ss"):
        pass
    elif word.endswith("s"):
        # Delete if the preceding word part contains a vowel not
        # immediately before the s.
        if _has_vowel(word, len(word) - 2):
            word = word[:-1]

    if word in _EXCEPTIONS_1A:
        return word

    # --- Step 1b ---------------------------------------------------------
    suffix = None
    for suf in ("eedly", "ingly", "edly", "eed", "ing", "ed"):
        if word.endswith(suf):
            suffix = suf
            break
    if suffix in ("eed", "eedly"):
        if len(word) - len(suffix) >= r1:
            word = word[: -len(suffix)] + "ee"
    elif suffix is not None:
        stemmed = word[: -len(suffix)]
        if _has_vowel(stemmed, len(stemmed)):
            word = stemmed
            if word.endswith(("at", "bl", "iz")):
                word += "e"
            elif word.endswith(_DOUBLES):
                word = word[:-1]
            elif _is_short(word, r1):
                word += "e"

    # --- Step 1c ---------------------------------------------------------
    if (len(word) > 2 and word[-1] in "yY"
            and word[-2] not in _VOWELS):
        word = word[:-1] + "i"

    # Regions are offsets into the (possibly shortened) word; recompute
    # lazily via a helper closure checking against current length.
    def in_r1(suf_len: int) -> bool:
        return len(word) - suf_len >= r1

    def in_r2(suf_len: int) -> bool:
        return len(word) - suf_len >= r2

    # --- Step 2 ------------------------------------------------------------
    step2 = (
        ("ational", "ate"), ("fulness", "ful"), ("iveness", "ive"),
        ("ization", "ize"), ("ousness", "ous"), ("biliti", "ble"),
        ("lessli", "less"), ("tional", "tion"), ("alism", "al"),
        ("aliti", "al"), ("ation", "ate"), ("entli", "ent"),
        ("fulli", "ful"), ("iviti", "ive"), ("ousli", "ous"),
        ("abli", "able"), ("alli", "al"), ("anci", "ance"),
        ("ator", "ate"), ("enci", "ence"), ("izer", "ize"),
        ("bli", "ble"), ("ogi", None), ("li", None),
    )
    for suf, repl in step2:
        if word.endswith(suf):
            if suf == "ogi":
                if in_r1(3) and len(word) > 3 and word[-4] == "l":
                    word = word[:-1]
            elif suf == "li":
                if in_r1(2) and len(word) > 2 and word[-3] in _LI_ENDING:
                    word = word[:-2]
            elif in_r1(len(suf)):
                word = word[: -len(suf)] + repl
            break

    # --- Step 3 ------------------------------------------------------------
    step3 = (
        ("ational", "ate"), ("tional", "tion"), ("alize", "al"),
        ("icate", "ic"), ("iciti", "ic"), ("ative", ""),
        ("ical", "ic"), ("ness", ""), ("ful", ""),
    )
    for suf, repl in step3:
        if word.endswith(suf):
            if suf == "ative":
                if in_r2(5):
                    word = word[:-5]
            elif in_r1(len(suf)):
                word = word[: -len(suf)] + repl
            break

    # --- Step 4 ------------------------------------------------------------
    step4 = ("ement", "ance", "ence", "able", "ible", "ment",
             "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
             "ion", "al", "er", "ic")
    for suf in step4:
        if word.endswith(suf):
            if in_r2(len(suf)):
                if suf == "ion":
                    if len(word) > 3 and word[-4] in "st":
                        word = word[:-3]
                else:
                    word = word[: -len(suf)]
            break

    # --- Step 5 ------------------------------------------------------------
    if word.endswith("e"):
        if in_r2(1) or (in_r1(1)
                        and not _ends_short_syllable(word[:-1])):
            word = word[:-1]
    elif word.endswith("l"):
        if in_r2(1) and len(word) > 1 and word[-2] == "l":
            word = word[:-1]

    return word.replace("Y", "y")
