"""The cyclic collector per batch of a pipelined stream: the engine's
``gc.us`` counter over the window (every collection, on any thread), in
milliseconds a batch."""

from perfbench.engine_spans import gc_per_unit_ms


def read(run):
    return gc_per_unit_ms(run, "pipelined")
