"""Tracing / profiling hooks.

The reference has no tracing beyond the benchmark CLI's wall-clock
printer (src/utils/benchmark.c:44-70); SURVEY §5 calls for profiler
hooks and per-phase timings in the rebuild.

- ``phase(name)``: near-zero-cost context manager; logs per-phase
  wall-clock at DEBUG level (enable with NXS_LOG_LEVEL=DEBUG).
- ``profiler_trace(logdir)``: wraps ``torch.profiler.profile`` so a
  block of searches can be captured as a TensorBoard / Chrome trace;
  enabled with NXS_PROFILE_DIR or explicitly.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

from .log import get_logger

_log = get_logger("trace")


@contextlib.contextmanager
def phase(name: str):
    """Time a phase; logs '<name>: N.NN ms' at DEBUG level."""
    if not _log.isEnabledFor(logging.DEBUG):
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _log.debug("%s: %.2f ms", name, (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def profiler_trace(logdir: str | None = None):
    """Capture a torch profiler trace (host and, with a card, CUDA
    activity) around the block.

    ``logdir`` defaults to $NXS_PROFILE_DIR; when neither is set the
    block runs untraced.
    """
    logdir = logdir or os.environ.get("NXS_PROFILE_DIR")
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     logdir)):
        yield
