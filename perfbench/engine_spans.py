"""Readings of the engine's own counters for per-layer metrics, where
``Run.per_unit_ms`` (a sum of spans) does not fit.

The collector's time is the engine's ``gc.us`` counter (utils/trace.py's
collector hook), which the harness clears at the window's start.  It
reads None where the engine has no such counter.
"""

import sys


def gc_per_unit_ms(run, send: str):
    """Milliseconds of the cyclic collector's collections in the window
    (``gc.us``), per batch or per request; 0 where the engine counts
    collections and the window had none."""
    if run.send != send or not run.units:
        return None
    us = run.exec_stats.get("gc.us")
    if us is None:
        engine = sys.modules.get("nxsearch_tpu_torch.utils.trace")
        if not hasattr(engine, "GC_COUNTERS"):
            return None
        us = 0
    return us / 1e3 / run.units
