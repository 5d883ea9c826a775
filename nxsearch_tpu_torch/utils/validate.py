"""Name validation (reference: src/utils/utils.c:24 str_isalnumdu)."""

from __future__ import annotations


def str_isalnumdu(name: str) -> bool:
    """True if the string contains only ASCII alnum, dash or underscore.

    This is the index-name validation rule used by the reference
    (alphanumeric / dash / underscore, non-empty).
    """
    if not name:
        return False
    for ch in name:
        if not (ch.isascii() and (ch.isalnum() or ch in "-_")):
            return False
    return True
