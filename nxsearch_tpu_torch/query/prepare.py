"""Query preparation: leaf values -> filtered tokens -> terms.

Mirrors query_prepare (src/query/query.c:75-115): every leaf value runs
through the *same* filter pipeline as indexing (whole value, not
re-segmented); the resulting unique token set is then resolved against
the index with TRIM (unmatched query tokens are dropped) and optional
FUZZYMATCH.  Leaves whose token was discarded or trimmed keep
``token=None``, which evaluates to an empty document set
(search.c:133-141).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..text.filters import FilterPipeline
from ..text.tokenizer import (TOKENSET_FUZZYMATCH, TOKENSET_TRIM, TokenSet,
                              tokenize_value)
from .ast import Expr


@dataclass
class Query:
    """Parsed + prepared query (query_t equivalent)."""
    root: Optional[Expr]
    tokens: TokenSet = field(default_factory=TokenSet)
    # Set by the batched fast path (search._prepare_many): the query is
    # a plain implicit-OR term list, so planners may skip the AST walk.
    pure_or: bool = False


def prepare(root: Expr, pipeline: FilterPipeline,
            term_lookup: Callable[[str], Optional[int]],
            fuzzy_lookup: Optional[Callable[[str], Optional[int]]] = None,
            fuzzymatch: bool = True) -> Query:
    q = Query(root=root)
    for leaf in root.walk_leaves():
        leaf.token = tokenize_value(pipeline, q.tokens, leaf.value)

    flags = TOKENSET_TRIM | (TOKENSET_FUZZYMATCH if fuzzymatch else 0)
    n_before = len(q.tokens.tokens)
    q.tokens.resolve(term_lookup, flags, fuzzy_lookup=fuzzy_lookup)

    # Leaves whose token was trimmed must evaluate to the empty set
    # (second walk needed only when resolve actually trimmed).
    if len(q.tokens.tokens) != n_before:
        resolved = {id(t) for t in q.tokens.tokens}
        for leaf in root.walk_leaves():
            if leaf.token is not None and id(leaf.token) not in resolved:
                leaf.token = None
    return q
