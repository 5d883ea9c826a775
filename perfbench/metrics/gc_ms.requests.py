"""The cyclic collector per ``search_many`` request: the engine's
``gc.us`` counter over the window (every collection, on any thread), in
milliseconds a request."""

from perfbench.engine_spans import gc_per_unit_ms


def read(run):
    return gc_per_unit_ms(run, "requests")
