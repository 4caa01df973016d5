"""Readers-writer lock guarding the map (a copy of
``voldor_tpu/slam/rwlock.py``; pure Python).

Same role as slam_py/rwlock.py:29-98: VO and mapping take read locks (they
only append), PGO takes the write lock. Writer-preference two-mutex scheme.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self):
        self._readers = 0
        self._readers_lock = threading.Lock()
        self._writer_lock = threading.Lock()

    def r_acquire(self):
        with self._readers_lock:
            self._readers += 1
            if self._readers == 1:
                self._writer_lock.acquire()

    def r_release(self):
        with self._readers_lock:
            self._readers -= 1
            if self._readers == 0:
                self._writer_lock.release()

    def w_acquire(self):
        self._writer_lock.acquire()

    def w_release(self):
        self._writer_lock.release()

    @contextmanager
    def r_locked(self):
        self.r_acquire()
        try:
            yield
        finally:
            self.r_release()

    @contextmanager
    def w_locked(self):
        self.w_acquire()
        try:
            yield
        finally:
            self.w_release()
