"""Vendored English stopword list.

The reference loads stopwords from ``$NXS_BASEDIR/filters/stopwords/<lang>``
(src/core/filters_builtin.c:100), populated at deploy time from the NLTK
stopwords corpus by tools/fetch_ext_data.sh.  Since the list is external
data (public domain word list), we vendor the standard NLTK English list
here so deployments work offline; `install_default_stopwords()` writes
it in the reference's on-disk format (one word per line).
"""

from __future__ import annotations

import os

ENGLISH = (
    "i", "me", "my", "myself", "we", "our", "ours", "ourselves", "you",
    "you're", "you've", "you'll", "you'd", "your", "yours", "yourself",
    "yourselves", "he", "him", "his", "himself", "she", "she's", "her",
    "hers", "herself", "it", "it's", "its", "itself", "they", "them",
    "their", "theirs", "themselves", "what", "which", "who", "whom",
    "this", "that", "that'll", "these", "those", "am", "is", "are",
    "was", "were", "be", "been", "being", "have", "has", "had",
    "having", "do", "does", "did", "doing", "a", "an", "the", "and",
    "but", "if", "or", "because", "as", "until", "while", "of", "at",
    "by", "for", "with", "about", "against", "between", "into",
    "through", "during", "before", "after", "above", "below", "to",
    "from", "up", "down", "in", "out", "on", "off", "over", "under",
    "again", "further", "then", "once", "here", "there", "when",
    "where", "why", "how", "all", "any", "both", "each", "few", "more",
    "most", "other", "some", "such", "no", "nor", "not", "only", "own",
    "same", "so", "than", "too", "very", "s", "t", "can", "will",
    "just", "don", "don't", "should", "should've", "now", "d", "ll",
    "m", "o", "re", "ve", "y", "ain", "aren", "aren't", "couldn",
    "couldn't", "didn", "didn't", "doesn", "doesn't", "hadn", "hadn't",
    "hasn", "hasn't", "haven", "haven't", "isn", "isn't", "ma",
    "mightn", "mightn't", "mustn", "mustn't", "needn", "needn't",
    "shan", "shan't", "shouldn", "shouldn't", "wasn", "wasn't", "weren",
    "weren't", "won", "won't", "wouldn", "wouldn't",
)


def install_default_stopwords(basedir: str, lang: str = "en") -> str:
    """Write the vendored stopword list into the reference layout.

    Equivalent to running tools/fetch_ext_data.sh against the basedir
    (but offline).  Returns the written path.
    """
    path = os.path.join(basedir, "filters", "stopwords")
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, lang)
    words = {"en": ENGLISH}.get(lang)
    if words is None:
        raise ValueError(f"no vendored stopword list for language {lang!r}")
    with open(target, "w", encoding="utf-8") as f:
        f.write("\n".join(words) + "\n")
    return target
