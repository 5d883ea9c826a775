"""Query AST (reference: src/query/expr.c/h).

An expression is either a token leaf (the raw query value plus, after
preparation, the resolved Token) or a binary operator node: AND, OR or
NOT -- where NOT is the reference's ANDNOT ("L AND NOT R").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..text.tokenizer import Token

EXPR_VAL_TOKEN = 0
EXPR_OP_AND = 1
EXPR_OP_OR = 2
EXPR_OP_NOT = 3  # ANDNOT semantics

_OP_NAMES = {EXPR_OP_AND: "AND", EXPR_OP_OR: "OR", EXPR_OP_NOT: "NOT"}


@dataclass
class Expr:
    type: int
    value: Optional[str] = None          # leaf: the raw query string
    token: Optional[Token] = None        # leaf: resolved token (or None)
    elements: list["Expr"] = field(default_factory=list)

    @classmethod
    def leaf(cls, value: str) -> "Expr":
        return cls(type=EXPR_VAL_TOKEN, value=value)

    @classmethod
    def operator(cls, op: int, left: "Expr", right: "Expr") -> "Expr":
        return cls(type=op, elements=[left, right])

    @property
    def is_operator(self) -> bool:
        return self.type != EXPR_VAL_TOKEN

    def repr_string(self) -> str:
        """String dump matching the reference tests' format
        (t_queryparser.c expr_string_dump): leaves in backticks,
        operators as ``(OP lhs rhs)``.
        """
        if self.type == EXPR_VAL_TOKEN:
            return f"`{self.value}`"
        e1 = self.elements[0].repr_string()
        e2 = self.elements[1].repr_string()
        return f"({_OP_NAMES[self.type]} {e1} {e2})"

    def walk_leaves(self):
        """Iterative deep-walk yielding every leaf (query.c:86-107)."""
        stack = [self]
        while stack:
            expr = stack.pop()
            if expr.is_operator:
                stack.extend(expr.elements)
            else:
                yield expr
