"""Boolean program parity: the port's batched eval_program_bits held to
nxsearch_tpu's on the same programs and presence bits.

Programs come from compile_program over random query trees (AND / OR /
AND NOT, unresolved leaves that push the empty set), NOP-padded to a
bucketed length as the planner pads them; the rows of one batch carry
different programs.  Presence bits are random u32 words made with
numpy, bit 31 included.  Tolerance: exact equality (booleans).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nxsearch_tpu.ops.boolean import eval_program_bits as j_eval_bits
from nxsearch_tpu_torch.ops.boolean import (EMPTY_LEAF_BIT, OP_NOP,
                                            compile_program,
                                            eval_program_bits)
from nxsearch_tpu_torch.query.ast import (EXPR_OP_AND, EXPR_OP_NOT,
                                          EXPR_OP_OR, Expr)

DEPTH = 8
PROG_LEN = 16


def random_tree(rng, n_leaves: int, n_terms: int) -> Expr:
    """A random binary query tree; a leaf's token is its term row (or
    None: an unresolved leaf, ~1 in 8)."""
    if n_leaves == 1:
        leaf = Expr.leaf("t")
        if rng.random() >= 0.125:
            leaf.token = int(rng.integers(0, n_terms))
        return leaf
    left = int(rng.integers(1, n_leaves))
    op = [EXPR_OP_AND, EXPR_OP_OR, EXPR_OP_NOT][int(rng.integers(0, 3))]
    return Expr.operator(op, random_tree(rng, left, n_terms),
                         random_tree(rng, n_leaves - left, n_terms))


def random_program(rng, n_terms: int):
    """(ops, args) of a random tree compiled as the planner compiles it,
    re-drawn until its evaluation stack fits DEPTH and PROG_LEN."""
    while True:
        root = random_tree(rng, int(rng.integers(1, 7)), n_terms)
        ops, args, depth = compile_program(
            root, lambda tok: EMPTY_LEAF_BIT if tok is None else tok)
        if depth <= DEPTH and len(ops) <= PROG_LEN:
            break
    pad = PROG_LEN - len(ops)
    return (np.concatenate([ops, np.full(pad, OP_NOP, np.int32)]),
            np.concatenate([args, np.zeros(pad, np.int32)]))


@pytest.mark.parametrize("seed", range(12))
def test_eval_program_bits_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n_rows, n_docs = 4, 96
    # Rows 24..31 stand in for the top presence bits (bit 31 is the
    # sign of an int32 word).
    n_terms = 32 if seed % 2 else 8
    progs = [random_program(rng, n_terms) for _ in range(n_rows)]
    ops = np.stack([p[0] for p in progs])
    args = np.stack([p[1] for p in progs])
    bits = rng.integers(0, 1 << 32, size=(n_rows, n_docs), dtype=np.uint64)
    bits[:, 0] = 0xFFFFFFFF
    bits[:, 1] = 1 << 31
    bits = bits.astype(np.uint32)

    got = eval_program_bits(torch.from_numpy(bits.astype(np.int64)),
                            torch.from_numpy(ops), torch.from_numpy(args),
                            depth=DEPTH).numpy()
    for r in range(n_rows):
        want = np.asarray(j_eval_bits(jnp.asarray(bits[r]),
                                      jnp.asarray(ops[r]),
                                      jnp.asarray(args[r]), depth=DEPTH))
        np.testing.assert_array_equal(got[r], want, err_msg=f"row {r}")


def test_all_nop_rows_keep_nothing():
    """Padding rows of a batch (all-NOP programs) pass no document, as
    the reference's empty stack does."""
    bits = torch.full((2, 5), 0xFFFFFFFF, dtype=torch.int64)
    ops = torch.zeros((2, PROG_LEN), dtype=torch.int32)
    assert not eval_program_bits(bits, ops, ops, depth=DEPTH).any()
