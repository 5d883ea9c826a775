"""Append-only index log files with the commit-pointer discipline.

The reference persists an index as two memory-mapped append-only files
whose headers carry a ``data_len`` commit pointer: data is appended
*before* the pointer is release-stored, so torn/unfinished writes are
invisible to readers and a crashed writer simply leaves the file at the
last published length (src/index/storage.h:42-55, terms.c:303-305,
dtmap.c:326-337).  Cross-process exclusion uses flock: EX for append,
SH for tail consumption (src/index/idxmap.c:57-118).

This module reimplements that protocol with a new little-endian layout
(we deliberately do not reproduce the reference ABI -- the on-device
index is rebuilt from these logs, they are the durable journal):

    header  (32 bytes): magic u32 | version u32 | data_len u64 | reserved
    payload (data_len bytes of records, format defined by the caller)

The creation race (two processes creating the same file) is handled
with O_CREAT without O_EXCL plus a zero-size retry loop under the lock,
equivalent to idxmap.c:62-106.
"""

from __future__ import annotations

import fcntl
import os
import struct
import time
from contextlib import contextmanager

from ..errors import ErrorCode, NxsError

HEADER_FMT = "<IIQ16x"
HEADER_SIZE = struct.calcsize(HEADER_FMT)
ABI_VERSION = 1

MAGIC_TERMS = 0x5454584E   # "NXTT"
MAGIC_DTMAP = 0x4454584E   # "NXTD"


class LogFile:
    """One append-only journal file."""

    def __init__(self, path: str, magic: int, sync: bool = False):
        self.path = path
        self.magic = magic
        self.sync = sync
        self.fd = -1
        self._open_or_create()

    # -- lifecycle -------------------------------------------------------
    def _open_or_create(self) -> None:
        try:
            self.fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        except OSError as e:
            raise NxsError(ErrorCode.SYSTEM,
                           f"could not open {self.path}: {e}")
        try:
            with self.lock_ex():
                st = os.fstat(self.fd)
                if st.st_size == 0:
                    header = struct.pack(HEADER_FMT, self.magic,
                                         ABI_VERSION, 0)
                    os.pwrite(self.fd, header, 0)
                    if self.sync:
                        os.fdatasync(self.fd)
            # Another creator may have won the race; wait for a header.
            deadline = time.monotonic() + 5.0
            while os.fstat(self.fd).st_size < HEADER_SIZE:
                if time.monotonic() > deadline:  # pragma: no cover
                    raise NxsError(ErrorCode.SYSTEM,
                                   f"timed out waiting for {self.path}")
                time.sleep(0.001)
            self._verify_header()
        except Exception:
            os.close(self.fd)
            self.fd = -1
            raise

    def _verify_header(self) -> None:
        raw = os.pread(self.fd, HEADER_SIZE, 0)
        magic, version, _ = struct.unpack(HEADER_FMT, raw)
        if magic != self.magic:
            raise NxsError(ErrorCode.FATAL,
                           f"{self.path}: bad file magic")
        if version != ABI_VERSION:
            raise NxsError(ErrorCode.FATAL,
                           f"{self.path}: unsupported ABI version {version}")

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1

    # -- locking ----------------------------------------------------------
    @contextmanager
    def lock_ex(self):
        fcntl.flock(self.fd, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(self.fd, fcntl.LOCK_UN)

    @contextmanager
    def lock_sh(self):
        fcntl.flock(self.fd, fcntl.LOCK_SH)
        try:
            yield
        finally:
            fcntl.flock(self.fd, fcntl.LOCK_UN)

    # -- committed-length protocol ----------------------------------------
    def committed_len(self) -> int:
        """Read the published data length (caller must hold a lock)."""
        raw = os.pread(self.fd, HEADER_SIZE, 0)
        if len(raw) < HEADER_SIZE:  # pragma: no cover
            return 0
        _, _, data_len = struct.unpack(HEADER_FMT, raw)
        return data_len

    def read_payload(self, start: int, end: int) -> bytes:
        """Read committed payload bytes [start, end)."""
        return os.pread(self.fd, end - start, HEADER_SIZE + start)

    def append(self, data: bytes, committed: int) -> int:
        """Append ``data`` at offset ``committed`` and publish.

        Caller must hold the EX lock and pass the current committed
        length.  Returns the new committed length.  The data write is
        durable (optionally fsynced) before the pointer is published,
        preserving the reference's crash-safety ordering.
        """
        os.pwrite(self.fd, data, HEADER_SIZE + committed)
        if self.sync:
            os.fdatasync(self.fd)
        new_len = committed + len(data)
        os.pwrite(self.fd, struct.pack("<Q", new_len), 8)
        if self.sync:
            os.fdatasync(self.fd)
        return new_len

    def patch(self, payload_offset: int, data: bytes) -> None:
        """Overwrite bytes inside the committed region (tombstoning)."""
        os.pwrite(self.fd, data, HEADER_SIZE + payload_offset)
