"""Host allocator tuning for virtualized deployments.

Snapshot-restored microVMs (and some cloud hosts) serve first-touch
page faults through the hypervisor at microseconds per 4 KiB page.
glibc returns every free() larger than 128 KiB to the kernel
(mmap/munmap per allocation), so each large numpy temporary repays the
whole fault tax -- measured here: a 32 MB array allocation costing
seconds, 200x its warm cost, and journal replay 60x slower than the
same code on a warm heap.

``tune_host_allocator`` applies two glibc mallopt knobs (keep large
allocations on the heap; never trim it back) and optionally prefaults
a scratch arena so the heap is warm from the first query.  No-op --
safely -- on non-glibc platforms.

No reference equivalent: the C engine mmaps its index once and never
cycles large heap blocks; array-at-a-time execution does.
"""

from __future__ import annotations

import ctypes
import os

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_applied = False


def tune_host_allocator(prefault_mb: int | None = None) -> bool:
    """Apply the allocator tuning once per process.

    ``prefault_mb`` (or $NXS_PREFAULT_MB, default 512) sizes the
    warm-heap arena; 0 skips prefaulting.  Disable everything with
    NXS_MALLOC_TUNE=0.  Returns True when the mallopt calls applied.
    """
    global _applied
    if os.environ.get("NXS_MALLOC_TUNE", "1") == "0":
        return False
    if prefault_mb is None:
        prefault_mb = int(os.environ.get("NXS_PREFAULT_MB", "512"))
    ok = False
    if not _applied:
        try:
            libc = ctypes.CDLL("libc.so.6", use_errno=True)
            ok = bool(libc.mallopt(_M_TRIM_THRESHOLD, 0x7FFFFFFF))
            ok = bool(libc.mallopt(_M_MMAP_THRESHOLD, 0x7FFFFFFF)) and ok
        except Exception:  # non-glibc / non-Linux: nothing to tune
            return False
        _applied = True
    if prefault_mb > 0:
        arena = bytearray(prefault_mb << 20)
        arena[::4096] = b"\x01" * ((len(arena) + 4095) // 4096)
        del arena
    return ok
