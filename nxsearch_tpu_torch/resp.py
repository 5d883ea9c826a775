"""Search response object (reference: src/core/results.c nxs_resp_t).

Holds the ranked ``(doc_id, score)`` results, already capped at the
query limit and sorted descending by score; ``count`` is the number of
returned entries (the reference caps count at the heap limit,
results.c:196-199).  JSON shape matches results.c:155-159,218:
``{"results": [{"doc_id": ..., "score": ...}, ...], "count": N}``.

Batched serving builds responses straight from the device result
block (``from_arrays``): the numpy row slices are kept as-is and the
``(doc_id, score)`` tuple list materializes only if a caller iterates
it.  At 2048-query batches the eager tolist + per-element tuple build
was the single largest host cost of the collect phase (~45 ms per
batch measured on the 8.8M-doc tier); JSON serialization never needs
the tuples at all.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional


class Response:
    """Ranked search results (nxs_resp_t equivalent)."""

    __slots__ = ("_results", "_ids", "_scores")

    def __init__(self, results: list[tuple[int, float]] | None = None):
        self._results: Optional[list[tuple[int, float]]] = (
            results if results is not None else [])
        self._ids = None
        self._scores = None

    @classmethod
    def from_arrays(cls, ids, scores) -> "Response":
        """Wrap equal-length numpy rows (already limit-capped and
        sorted descending); tuples materialize lazily."""
        r = cls.__new__(cls)
        r._results = None
        r._ids = ids
        r._scores = scores
        return r

    @property
    def results(self) -> list[tuple[int, float]]:
        if self._results is None:
            # int() via tolist keeps doc_ids Python ints and scores
            # Python floats -- identical values to the eager path.
            self._results = list(zip(self._ids.tolist(),
                                     self._scores.tolist()))
        return self._results

    @results.setter
    def results(self, value: list[tuple[int, float]]) -> None:
        self._results = value
        self._ids = None
        self._scores = None

    @property
    def count(self) -> int:
        if self._results is None:
            return len(self._ids)
        return len(self._results)

    def __iter__(self) -> Iterator[tuple[int, float]]:
        """Iterate (doc_id, score), nxs_resp_iter_result equivalent."""
        return iter(self.results)

    def __len__(self) -> int:
        return self.count

    def tojson_obj(self) -> dict:
        if self._results is None:
            return {
                "results": [
                    {"doc_id": d, "score": s}
                    for d, s in zip(self._ids.tolist(),
                                    self._scores.tolist())
                ],
                "count": len(self._ids),
            }
        return {
            "results": [
                {"doc_id": doc_id, "score": score}
                for doc_id, score in self._results
            ],
            "count": self.count,
        }

    def tojson(self) -> str:
        return json.dumps(self.tojson_obj())

    def repr_dict(self) -> dict[int, float]:
        """doc_id -> score map (the Lua binding's resp:repr() table)."""
        return dict(self.results)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Response(count={self.count}, results={self.results!r})"
