"""Lock creation sites of the storage and the interpreter.

Copy of the interface of memgraph_tpu/utils/locks.py.  There,
``tracked_lock`` returns a lock that records the order in which locks are
taken when the lock-order witness is armed (``MG_TRACK_LOCKS``), for the
reference's own test suite.  The port has no such witness: these return
plain ``threading`` locks, which is what the reference returns unarmed.
``ReadWriteGate`` (the replica's apply gate) and ``fork_safe`` are the
port's own.
"""

from __future__ import annotations

import contextlib
import os
import threading
import weakref


def tracked_lock(name: str):
    """A plain ``threading.Lock``; ``name`` names the creation site."""
    return threading.Lock()


def tracked_rlock(name: str):
    """A plain ``threading.RLock``; ``name`` names the creation site."""
    return threading.RLock()


_FORK_SAFE: "weakref.WeakSet" = weakref.WeakSet()
_RLOCK = type(threading.RLock())


def fork_safe(owner):
    """Give ``owner`` (a process-wide registry) a fresh ``_lock`` in every
    child this process forks, and return it.

    A forked child inherits each lock in the state it had at the fork, and
    only the forking thread survives there: a lock another thread held at
    that moment stays held for ever.  The shard plane respawns a worker
    from one of a scatter read's threads while its siblings update the
    metrics (sharding/plane.py), and the read pool forks with the card's
    threads live, so every registry a worker touches is renewed in the
    child, as CPython renews its logging locks."""
    _FORK_SAFE.add(owner)
    return owner


def _renew_after_fork() -> None:
    for owner in list(_FORK_SAFE):
        old = getattr(owner, "_lock", None)
        owner._lock = threading.RLock() if isinstance(old, _RLOCK) \
            else threading.Lock()


os.register_at_fork(after_in_child=_renew_after_fork)


class ReadWriteGate:
    """Many readers or one writer, the writer first: once a writer waits,
    new readers wait behind it.

    The port's own (the reference has none): a replica applies WAL
    frames to its objects directly, past MVCC, so a snapshot export that
    overlapped an apply would read two versions.  The replica's appliers
    hold ``write()``; a snapshot export holds ``read()`` (see
    replication/replica.py and storage/source.py)."""

    def __init__(self) -> None:
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0
        self._writer = False
        self._waiting_writers = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._waiting_writers:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if not self._readers:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._waiting_writers += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._waiting_writers -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    @contextlib.contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextlib.contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()
