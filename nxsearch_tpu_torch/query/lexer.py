"""Query lexer (reference: src/query/scan.re).

Tokens: AND (``&`` or case-insensitive ``AND``), OR (``|`` / ``OR``),
NOT, parentheses, quoted strings (single or double quotes, backslash
escapes retained verbatim -- the reference copies the inner bytes
without unescaping, scan.re:106-111) and free-form strings (any run of
characters that is not whitespace, NUL or a parenthesis).

Matching follows re2c longest-match semantics: a free-form run that
happens to be exactly ``AND``/``OR``/``NOT``/``&``/``|`` is the
operator; a longer run (e.g. ``ANDy``, ``&&``) is a string.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import ErrorCode, NxsError

# Token kinds (grammar.h equivalents).
TOKEN_EOF = 0
TOKEN_AND = 1
TOKEN_OR = 2
TOKEN_NOT = 3
TOKEN_BR_OPEN = 4
TOKEN_BR_CLOSE = 5
TOKEN_QUOTED_STRING = 6
TOKEN_FF_STRING = 7

_WSP = " \t\v\f\r\n"


class QuerySyntaxError(NxsError):
    """Query parse failure; surfaced as NXS_ERR_INVALID like the
    reference's query error path (search.c construct_query -> nxs
    error slot)."""

    def __init__(self, line: int, offset: int, near: str):
        self.line = line
        self.offset = offset
        # Message format mirrors query_set_error (query.c:56-57).
        super().__init__(
            ErrorCode.INVALID,
            f'syntax error near {line}:{offset}: "{near[:50]} ..."')


@dataclass
class LexToken:
    kind: int
    value: str = ""
    line: int = 1
    offset: int = 0


def tokenize_query(text: str) -> list[LexToken]:
    tokens: list[LexToken] = []
    i, n = 0, len(text)
    line = 1
    line_start = 0

    while i < n:
        ch = text[i]
        if ch == "\x00":
            raise QuerySyntaxError(line, i - line_start, text[i:])
        if ch == "\n":
            line += 1
            i += 1
            line_start = i
            continue
        if ch in _WSP:
            i += 1
            continue
        offset = i - line_start
        if ch == "(":
            tokens.append(LexToken(TOKEN_BR_OPEN, "(", line, offset))
            i += 1
            continue
        if ch == ")":
            tokens.append(LexToken(TOKEN_BR_CLOSE, ")", line, offset))
            i += 1
            continue
        if ch in "'\"":
            end = _scan_quoted(text, i, ch)
            if end >= 0:
                # Inner bytes verbatim, escapes retained (scan.re:109).
                tokens.append(LexToken(TOKEN_QUOTED_STRING,
                                       text[i + 1: end], line, offset))
                i = end + 1
                continue
            # No closing quote: falls through to a free-form run.
        j = i
        while j < n and text[j] not in _WSP and text[j] not in "()\x00":
            j += 1
        run = text[i:j]
        upper = run.upper()
        if run == "&" or upper == "AND":
            tokens.append(LexToken(TOKEN_AND, run, line, offset))
        elif run == "|" or upper == "OR":
            tokens.append(LexToken(TOKEN_OR, run, line, offset))
        elif upper == "NOT":
            tokens.append(LexToken(TOKEN_NOT, run, line, offset))
        else:
            tokens.append(LexToken(TOKEN_FF_STRING, run, line, offset))
        i = j
    return tokens


def _scan_quoted(text: str, start: int, quote: str) -> int:
    """Return the index of the closing quote, or -1.

    Mirrors the re2c patterns SQ_STR/DQ_STR: the body is any char except
    the quote, NUL or backslash -- or a backslash followed by any
    non-NUL char.
    """
    i = start + 1
    n = len(text)
    while i < n:
        ch = text[i]
        if ch == "\x00":
            return -1
        if ch == "\\":
            if i + 1 >= n or text[i + 1] == "\x00":
                return -1
            i += 2
            continue
        if ch == quote:
            return i
        i += 1
    return -1
