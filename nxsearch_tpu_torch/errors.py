"""Error machinery.

Mirrors the reference's public error API: a small stable enum of error
codes plus a human-readable message (reference: src/core/nxs.h:35-48,
src/core/nxs.c:154-217).  Unlike the C library's per-instance last-error
slot, errors are raised as exceptions carrying (code, msg); the service
layer renders them as ``{"error": {"code": ..., "msg": ...}}`` exactly
like the reference service (svc-src/nxsearch_svc.lua:55-65).
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    # WARNING: stable ABI ordering, matches nxs.h:35-46.
    SUCCESS = 0
    FATAL = 1       # unspecified fatal error
    SYSTEM = 2      # operating system error
    INVALID = 3     # invalid parameter or value
    EXISTS = 4      # resource already exists
    MISSING = 5     # resource is missing
    LIMIT = 6       # resource limit reached


# Convenience aliases matching the C constant names (NXS_ERR_*).
ERR_SUCCESS = ErrorCode.SUCCESS
ERR_FATAL = ErrorCode.FATAL
ERR_SYSTEM = ErrorCode.SYSTEM
ERR_INVALID = ErrorCode.INVALID
ERR_EXISTS = ErrorCode.EXISTS
ERR_MISSING = ErrorCode.MISSING
ERR_LIMIT = ErrorCode.LIMIT


class NxsError(Exception):
    """An error with a stable code, equivalent to nxs_get_error()."""

    def __init__(self, code: ErrorCode, msg: str):
        super().__init__(msg)
        self.code = ErrorCode(code)
        self.msg = msg

    def tojson_obj(self) -> dict:
        return {"error": {"code": int(self.code), "msg": self.msg}}

    def __repr__(self) -> str:  # pragma: no cover
        return f"NxsError(code={self.code!r}, msg={self.msg!r})"
