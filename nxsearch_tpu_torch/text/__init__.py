from .tokenizer import (  # noqa: F401
    Token, TokenSet, tokenize, tokenize_value,
    TOKENSET_STAGE, TOKENSET_TRIM, TOKENSET_FUZZYMATCH,
)
from .filters import FilterOps, FilterPipeline, FilterRegistry  # noqa: F401
from .wordbreak import words  # noqa: F401
from .normalize import normalize_token  # noqa: F401
from .porter2 import stem  # noqa: F401
