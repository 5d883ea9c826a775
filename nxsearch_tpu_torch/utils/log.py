"""Leveled logging (reference: src/utils/log.c).

Level comes from the NXS_LOG_LEVEL environment variable, matching the
reference's behavior (core/nxs.c:98-100).  Output format is
``pid:file:line :: func: msg`` -- we delegate to the stdlib logging
module with an equivalent formatter.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "CRITICAL": logging.CRITICAL,
}

_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    level_name = os.environ.get("NXS_LOG_LEVEL", "WARNING").upper()
    level = _LEVELS.get(level_name, logging.WARNING)
    # stderr, NOT stdout: the reference logs to stdout
    # (utils/log.c:45-78), but this library's callers treat stdout as
    # a data channel (bench.py emits one parseable JSON line; CLI
    # pipelines do the same) -- a WARNING mid-run must never corrupt
    # it.
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(
        f"{os.getpid()}:%(filename)s:%(lineno)d :: %(funcName)s: %(message)s"))
    root = logging.getLogger("nxsearch_tpu")
    root.addHandler(handler)
    root.setLevel(level)
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"nxsearch_tpu.{name}")
