"""Typed parameter objects.

The reference wraps a yyjson document with typed get/set accessors and
JSON (de)serialization (src/core/params.c:38-218).  Here a Params is a
thin typed wrapper over a plain dict with the same accessor surface and
the same on-disk representation (``params.db`` is a JSON object).
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

from .errors import ErrorCode, NxsError

# Defaults (reference: src/core/nxs_impl.h:39-41, src/core/nxs.c:87-89).
DEFAULT_RANKING_ALGO = "BM25"
DEFAULT_LANGUAGE = "en"
DEFAULT_FILTERS = ("normalizer", "stopwords", "stemmer")
DEFAULT_RESULTS_LIMIT = 1000


class Params:
    """JSON-object-backed parameters (nxs_params_t equivalent)."""

    def __init__(self, values: Optional[dict] = None):
        self._values: dict = dict(values) if values else {}

    # --- constructors -------------------------------------------------
    @classmethod
    def fromjson(cls, text: str | bytes) -> "Params":
        try:
            obj = json.loads(text)
        except (ValueError, TypeError) as e:
            raise NxsError(ErrorCode.INVALID, f"invalid JSON: {e}")
        if not isinstance(obj, dict):
            raise NxsError(ErrorCode.INVALID, "params JSON must be an object")
        return cls(obj)

    @classmethod
    def fromfile(cls, path: str) -> "Params":
        try:
            with open(path, "rb") as f:
                return cls.fromjson(f.read())
        except OSError as e:
            raise NxsError(ErrorCode.SYSTEM, f"could not read params at {path}: {e}")

    # --- typed setters (params.c:38-155) ------------------------------
    def set_str(self, key: str, value: str) -> "Params":
        self._values[key] = str(value)
        return self

    def set_strlist(self, key: str, values: Iterable[str]) -> "Params":
        self._values[key] = [str(v) for v in values]
        return self

    def set_uint(self, key: str, value: int) -> "Params":
        v = int(value)
        if v < 0:
            raise NxsError(ErrorCode.INVALID, f"negative value for {key}")
        self._values[key] = v
        return self

    def set_bool(self, key: str, value: bool) -> "Params":
        self._values[key] = bool(value)
        return self

    # --- typed getters -------------------------------------------------
    def get_str(self, key: str) -> Optional[str]:
        v = self._values.get(key)
        return v if isinstance(v, str) else None

    def get_strlist(self, key: str) -> Optional[list[str]]:
        v = self._values.get(key)
        if isinstance(v, list) and all(isinstance(x, str) for x in v):
            return list(v)
        return None

    def get_uint(self, key: str) -> Optional[int]:
        v = self._values.get(key)
        if isinstance(v, bool):
            return None
        if isinstance(v, int) and v >= 0:
            return v
        if isinstance(v, float) and v >= 0 and float(v).is_integer():
            return int(v)
        return None

    def get_bool(self, key: str) -> Optional[bool]:
        v = self._values.get(key)
        return v if isinstance(v, bool) else None

    # --- serialization (params.c:159-218) -------------------------------
    def tojson(self) -> str:
        return json.dumps(self._values, ensure_ascii=False)

    def serialize(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(self.tojson())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # --- misc -----------------------------------------------------------
    def asdict(self) -> dict:
        return dict(self._values)

    def copy(self) -> "Params":
        return Params(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def __repr__(self) -> str:  # pragma: no cover
        return f"Params({self._values!r})"
