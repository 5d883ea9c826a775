"""Query parser (reference: src/query/grammar.y, lemon-generated).

Grammar, with precedence NOT > AND > OR (grammar.y:67-69) and adjacency
as implicit OR that binds looser than explicit OR (the expr_list
productions, grammar.y:76-84):

    query     ::= expr_list
    expr_list ::= expr | expr_list expr          (implicit OR)
    expr      ::= expr AND expr
                | expr OR expr
                | expr AND NOT expr              (ANDNOT node)
                | ( expr )
                | value

Implemented as a precedence-climbing parser over the lexer's token
stream.  Binding strengths: implicit-OR(1) < OR(2) < AND/AND-NOT(3).
"""

from __future__ import annotations

from typing import Optional

from .ast import EXPR_OP_AND, EXPR_OP_NOT, EXPR_OP_OR, Expr
from .lexer import (LexToken, QuerySyntaxError, TOKEN_AND, TOKEN_BR_CLOSE,
                    TOKEN_BR_OPEN, TOKEN_FF_STRING, TOKEN_NOT, TOKEN_OR,
                    TOKEN_QUOTED_STRING, tokenize_query)

_PREC_ADJ = 1
_PREC_OR = 2
_PREC_AND = 3

_VALUE_TOKENS = (TOKEN_FF_STRING, TOKEN_QUOTED_STRING)


class _Parser:
    def __init__(self, tokens: list[LexToken], source: str):
        self.tokens = tokens
        self.pos = 0
        self.source = source

    def peek(self) -> Optional[LexToken]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def advance(self) -> LexToken:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def error(self) -> QuerySyntaxError:
        tok = self.peek()
        if tok is None:
            return QuerySyntaxError(1, len(self.source), "")
        return QuerySyntaxError(tok.line, tok.offset,
                                self.source[self.source.find(tok.value):]
                                if tok.value else "")

    def parse_primary(self) -> Expr:
        tok = self.peek()
        if tok is None:
            raise self.error()
        if tok.kind in _VALUE_TOKENS:
            self.advance()
            return Expr.leaf(tok.value)
        if tok.kind == TOKEN_BR_OPEN:
            self.advance()
            inner = self.parse_binary(_PREC_ADJ)
            closing = self.peek()
            if closing is None or closing.kind != TOKEN_BR_CLOSE:
                raise self.error()
            self.advance()
            return inner
        raise self.error()

    def parse_binary(self, min_prec: int) -> Expr:
        left = self.parse_primary()
        while True:
            tok = self.peek()
            if tok is None:
                break
            if tok.kind == TOKEN_OR:
                prec, op, consume = _PREC_OR, EXPR_OP_OR, 1
            elif tok.kind == TOKEN_AND:
                prec, op, consume = _PREC_AND, EXPR_OP_AND, 1
            elif tok.kind in _VALUE_TOKENS or tok.kind == TOKEN_BR_OPEN:
                prec, op, consume = _PREC_ADJ, EXPR_OP_OR, 0
            else:
                break
            if prec < min_prec:
                break
            for _ in range(consume):
                self.advance()
            if op == EXPR_OP_AND:
                nxt = self.peek()
                if nxt is not None and nxt.kind == TOKEN_NOT:
                    self.advance()
                    op = EXPR_OP_NOT  # "L AND NOT R" (grammar.y:96-99)
            right = self.parse_binary(prec + 1)  # left-associative
            left = Expr.operator(op, left, right)
        return left


# Fast path for plain term queries (the overwhelming serving
# majority): no operator/quote/paren/NUL characters and no AND/OR/NOT
# keywords means the grammar can only produce the left-folded
# implicit-OR chain -- build it directly, skipping the lexer and
# precedence climb (~10x).  Anything else falls back to the full
# parser; Unicode whitespace that the lexer treats as token bytes is
# preserved because the split is on the lexer's exact ASCII set.
import re as _re

_FAST_BAD_RE = _re.compile(r'[()"\'&|\x00]')
_FAST_KEYWORDS = frozenset(("AND", "OR", "NOT",
                            "and", "or", "not"))
_FAST_WSP = " \t\v\f\r\n"
_FAST_SPLIT_RE = _re.compile(f"[{_FAST_WSP}]+")


def parse_fast_values(query: str) -> Optional[list[str]]:
    """The fast path's *value list*: the raw leaf values of a plain
    term query, or None when the full grammar is needed.  Callers that
    only need the implicit-OR term list (batched serving) skip Expr
    construction entirely."""
    if _FAST_BAD_RE.search(query):
        return None
    if query.isascii():
        # ASCII str.split() splits exactly on the lexer's whitespace.
        parts = query.split()
    else:
        # Unicode: split only on the lexer's ASCII whitespace set
        # (str.split would also split on U+00A0 etc., which the lexer
        # keeps as token bytes).
        parts = [p for p in _FAST_SPLIT_RE.split(query) if p]
    if not parts:
        return None
    for value in parts:
        if len(value) <= 3 and value.upper() in _FAST_KEYWORDS:
            return None
    return parts


def _parse_fast(query: str) -> Optional[Expr]:
    parts = parse_fast_values(query)
    if parts is None:
        return None
    root: Optional[Expr] = None
    for value in parts:
        leaf = Expr.leaf(value)
        root = leaf if root is None else Expr.operator(
            EXPR_OP_OR, root, leaf)
    return root


def parse_query(query: str) -> Expr:
    """Parse the query into an AST; raises QuerySyntaxError."""
    fast = _parse_fast(query)
    if fast is not None:
        return fast
    tokens = tokenize_query(query)
    parser = _Parser(tokens, query)
    if parser.peek() is None:
        # Empty input: the lemon grammar requires at least one expr.
        raise QuerySyntaxError(1, 0, query)
    root = parser.parse_binary(_PREC_ADJ)
    if parser.peek() is not None:
        raise parser.error()
    return root
