"""Boolean query algebra: the postfix program compiler (host) and its
interpreters (torch).

The planner lowers a query AST to a fixed-width postfix program
(``compile_program``).  Two interpreters run it on the device:
``eval_program_bits`` over per-document presence bits (the sliced,
blockdense and candidate executors; at most 32 terms), and
``eval_program`` over packed per-term document bitmaps built by
``build_term_masks`` (the dense executor, any number of terms).
Opcodes, limits and the compiler are identical to
nxsearch_tpu/ops/boolean.py.  Every interpreter is batched: each row
steps through its own program in lockstep, the five results of a step
computed for every row and one selected per row.
"""

from __future__ import annotations

import numpy as np
import torch

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
    """Enforce the reference's recursion limit (search.c:66-75).

    A walk over an explicit stack: a recursive closure would leave a
    function-cell cycle behind for every query a search parses in full,
    garbage that only the cyclic collector reclaims."""
    stack = [(root, 0)]
    while stack:
        expr, r = stack.pop()
        if r > QUERY_NESTING_LIMIT:
            raise NxsError(
                ErrorCode.LIMIT,
                f"query nesting limit reached ({QUERY_NESTING_LIMIT} levels)")
        if expr.type != EXPR_VAL_TOKEN:
            stack.extend((e, r + 1) for e in expr.elements)


def build_term_masks(slot, qid, valid, *, n_terms: int, n_words: int):
    """Scatter each row's query-term postings into packed per-term doc
    bitmaps.

    slot / qid / valid: [N, B], the flat gather plan of
    ops/scoring.flatten_ranges (slot: the postings' device slots).
    Returns int32[N, n_terms + 1, n_words] little-bit-order words; row
    n_terms stays zero (the empty bitmap of unresolved leaves).  Each
    (term, slot) pair occurs once in the postings, so adding distinct
    bits is OR (bit 31 is the sign bit, and -2**31 plus any sum of the
    other bits stays in range).  Invalid lanes add 0 to the spill row,
    which is zeroed after."""
    n = slot.shape[0]
    slot = slot.to(torch.int64)
    word = slot >> 5
    bit = (torch.ones_like(slot) << (slot & 31)).to(torch.int32)
    rows = torch.where(valid, qid.to(torch.int64), n_terms)
    flat = ((torch.arange(n, device=slot.device)[:, None] * (n_terms + 1)
             + rows) * n_words + torch.where(valid, word, 0))
    masks = torch.zeros(n * (n_terms + 1) * n_words, dtype=torch.int32,
                        device=slot.device)
    masks.index_add_(0, flat.reshape(-1),
                     torch.where(valid, bit, 0).reshape(-1))
    masks = masks.reshape(n, n_terms + 1, n_words)
    masks[:, n_terms] = 0
    return masks


def eval_program(term_masks, ops, args, *, depth: int = 8):
    """Interpret each row's postfix program over packed bitmaps.

    term_masks: int32[N, Q + 1, W]; ops / args: int[N, L] NOP-padded
    (PUSH q pushes term q's bitmap, q == Q the empty one); ``depth``
    the static stack bucket (>= every program's simulated depth).
    Returns the final int32[N, W] document mask of each row.  Stack
    positions clamp as ``lax.dynamic_index_in_dim`` does."""
    n, _q1, n_words = term_masks.shape
    dev = term_masks.device
    ops = ops.to(device=dev, dtype=torch.int64)
    args = args.to(device=dev, dtype=torch.int64)
    stack = torch.zeros((n, depth, n_words), dtype=torch.int32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    q_last = term_masks.shape[1] - 1
    for step in range(ops.shape[1]):
        op = ops[:, step]
        push = op == OP_PUSH
        binary = op >= OP_AND
        leaf = term_masks[rows, args[:, step].clamp(0, q_last)]
        a = stack[rows, (sp - 2).clamp(0, depth - 1)]
        c = stack[rows, (sp - 1).clamp(0, depth - 1)]
        val = torch.where(
            push[:, None], leaf,
            torch.where((op == OP_AND)[:, None], a & c,
                        torch.where((op == OP_OR)[:, None], a | c, a & ~c)))
        pos = torch.where(push, sp, sp - 2).clamp(0, depth - 1)
        write = (push | binary)[:, None]
        stack[rows, pos] = torch.where(write, val, stack[rows, pos])
        sp = sp + push.to(torch.int64) - binary.to(torch.int64)
    return stack[:, 0]


# Sentinel PUSH argument for an unresolved (empty-set) leaf in the
# presence-bits evaluator: any value >= 32 pushes constant False.
EMPTY_LEAF_BIT = 32


def eval_program_bits(present_bits: torch.Tensor, ops: torch.Tensor,
                      args: torch.Tensor, *, depth: int = 8
                      ) -> torch.Tensor:
    """Interpret each row's postfix program over its presence bits.

    present_bits: int64[N, B] holding u32 words (bit q: query term q
    occurs in the candidate; int64 so bit 31 is not a sign bit);
    ops/args: int[N, L] NOP-padded, one program per row; ``depth`` is
    the static stack bucket (>= every program's simulated depth).
    Returns bool[N, B]: which candidates survive their row's program.
    The batched form of nxsearch_tpu's ``eval_program_bits`` (vmapped
    there): every row steps through its own program in lockstep.
    """
    n, b = present_bits.shape
    dev = present_bits.device
    ops = ops.to(device=dev, dtype=torch.int64)
    args = args.to(device=dev, dtype=torch.int64)
    stack = torch.zeros((n, depth, b), dtype=torch.bool, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    for step in range(ops.shape[1]):
        op = ops[:, step]
        arg = args[:, step]
        push = op == OP_PUSH
        binary = op >= OP_AND
        leaf = (((present_bits >> arg.clamp(0, 31)[:, None]) & 1) != 0) \
            & (arg < EMPTY_LEAF_BIT)[:, None]
        a = stack[rows, (sp - 2).clamp(0, depth - 1)]
        c = stack[rows, (sp - 1).clamp(0, depth - 1)]
        val = torch.where(
            push[:, None], leaf,
            torch.where((op == OP_AND)[:, None], a & c,
                        torch.where((op == OP_OR)[:, None], a | c, a & ~c)))
        pos = torch.where(push, sp, sp - 2).clamp(0, depth - 1)
        write = (push | binary)[:, None]
        stack[rows, pos] = torch.where(write, val, stack[rows, pos])
        sp = sp + push.to(torch.int64) - binary.to(torch.int64)
    return stack[:, 0]
