"""Boolean query algebra: the host half (postfix program compiler).

The planner lowers a query AST to a fixed-width postfix program
(``compile_program``) whose device interpreters live in
nxsearch_tpu/ops/boolean.py; this port serves pure-OR queries only, so
the device evaluators are not carried yet.  Opcodes, limits and the
compiler are identical to the reference package.
"""

from __future__ import annotations

import numpy as np

from ..errors import ErrorCode, NxsError
from ..query.ast import (EXPR_OP_AND, EXPR_OP_NOT, EXPR_OP_OR,
                         EXPR_VAL_TOKEN, Expr)

OP_NOP = 0
OP_PUSH = 1
OP_AND = 2
OP_OR = 3
OP_ANDNOT = 4

# Reference limit: query nesting <= 100 (search.c:70).  The device
# stack depth only needs to cover the *evaluation* stack of the postfix
# program, which for binary trees is bounded by the tree depth + 1;
# the executor picks a bucket size >= the program's actual need.
QUERY_NESTING_LIMIT = 100

_OP_FOR_EXPR = {
    EXPR_OP_AND: OP_AND,
    EXPR_OP_OR: OP_OR,
    EXPR_OP_NOT: OP_ANDNOT,
}


def compile_program(root: Expr, term_slot_of_token) -> tuple[np.ndarray,
                                                             np.ndarray, int]:
    """Lower the AST to a postfix program.

    ``term_slot_of_token(token) -> int`` maps a leaf's resolved token to
    its query-term row (the row in the term-mask matrix); unresolved
    leaves (token None) map to the empty row.

    Returns (ops int32[L], args int32[L], max_stack_depth).  The
    program is *not* padded; the caller pads to its bucket size.
    """
    ops: list[int] = []
    args: list[int] = []

    # Iterative postfix emission; stack entries are (expr, visited).
    stack: list[tuple[Expr, bool]] = [(root, False)]
    while stack:
        expr, visited = stack.pop()
        if expr.type == EXPR_VAL_TOKEN:
            ops.append(OP_PUSH)
            args.append(term_slot_of_token(expr.token))
            continue
        if visited:
            ops.append(_OP_FOR_EXPR[expr.type])
            args.append(0)
            continue
        stack.append((expr, True))
        # Children evaluated left then right (search.c evaluates
        # elements[0] first): push right first so left pops first.
        stack.append((expr.elements[1], False))
        stack.append((expr.elements[0], False))

    # Simulate to find the required stack depth.
    depth = max_depth = 0
    for op in ops:
        depth += 1 if op == OP_PUSH else -1
        max_depth = max(max_depth, depth)
    return (np.asarray(ops, dtype=np.int32),
            np.asarray(args, dtype=np.int32), max_depth)


def check_nesting(root: Expr) -> None:
    """Enforce the reference's recursion limit (search.c:66-75)."""
    def depth(expr: Expr, r: int) -> int:
        if r > QUERY_NESTING_LIMIT:
            raise NxsError(
                ErrorCode.LIMIT,
                f"query nesting limit reached ({QUERY_NESTING_LIMIT} levels)")
        if expr.type == EXPR_VAL_TOKEN:
            return r
        return max(depth(e, r + 1) for e in expr.elements)
    depth(root, 0)


# Sentinel PUSH argument for an unresolved (empty-set) leaf in the
# presence-bits evaluator: any value >= 32 pushes constant False.
EMPTY_LEAF_BIT = 32
