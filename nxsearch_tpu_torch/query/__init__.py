from .ast import (EXPR_OP_AND, EXPR_OP_NOT, EXPR_OP_OR,  # noqa: F401
                  EXPR_VAL_TOKEN, Expr)
from .lexer import QuerySyntaxError, tokenize_query  # noqa: F401
from .parser import parse_query  # noqa: F401
from .prepare import Query, prepare  # noqa: F401
