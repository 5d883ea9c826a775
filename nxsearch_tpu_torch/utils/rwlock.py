"""A small reader-writer lock with writer->reader downgrade.

The search path wants the reference's flock semantics in-process:
journal-tail consumption and device-snapshot refresh are exclusive
(writers), while query execution is shared (readers) -- the reference
serves concurrent readers per process via mmap + flock SH
(src/index/*.c), and the serving layer here shares one Index handle
across request threads.
"""

from __future__ import annotations

import threading


class RWLock:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    # -- shared (reader) side ------------------------------------------

    def read_acquire(self) -> None:
        with self._cond:
            # Writer preference: a continuous stream of readers must
            # not starve mutations (each reader re-acquires per query).
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def read_release(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    # -- exclusive (writer) side ---------------------------------------

    def write_acquire(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def write_release(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    def downgrade(self) -> None:
        """Atomically convert the held write lock into a read lock:
        no other writer can slip in between."""
        with self._cond:
            assert self._writer
            self._writer = False
            self._readers += 1
            self._cond.notify_all()

    # -- context helpers ----------------------------------------------

    class _Guard:
        def __init__(self, acquire, release):
            self._acquire = acquire
            self._release = release

        def __enter__(self):
            self._acquire()
            return self

        def __exit__(self, *exc):
            self._release()
            return False

    def reading(self) -> "RWLock._Guard":
        return self._Guard(self.read_acquire, self.read_release)

    def writing(self) -> "RWLock._Guard":
        return self._Guard(self.write_acquire, self.write_release)
