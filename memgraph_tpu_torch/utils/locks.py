"""Lock creation sites of the storage and the interpreter.

Copy of the interface of memgraph_tpu/utils/locks.py.  There,
``tracked_lock`` returns a lock that records the order in which locks are
taken when the lock-order witness is armed (``MG_TRACK_LOCKS``), for the
reference's own test suite.  The port has no such witness: these return
plain ``threading`` locks, which is what the reference returns unarmed.
"""

from __future__ import annotations

import threading


def tracked_lock(name: str):
    """A plain ``threading.Lock``; ``name`` names the creation site."""
    return threading.Lock()


def tracked_rlock(name: str):
    """A plain ``threading.RLock``; ``name`` names the creation site."""
    return threading.RLock()
