"""Shared-state annotations of the storage and the interpreter.

Copy of the interface of memgraph_tpu/utils/sanitize.py.  There, these
calls feed a race detector and an MVCC isolation checker when the
sanitizer is armed (``MG_SAN``), for the reference's own test suite.  The
port has no sanitizer, so each is a no-op, which is what the reference
does unarmed.
"""

from __future__ import annotations


def armed() -> bool:
    return False


def shared_field(owner, *fields: str) -> None:
    """Declares ``fields`` of ``owner`` shared between threads: a no-op."""


def shared_read(owner, field: str) -> None:
    """A read of a shared field: a no-op."""


def shared_write(owner, field: str) -> None:
    """A write of a shared field: a no-op."""


def yield_point(label: str = "") -> None:
    """A point where a schedule explorer could switch threads: a no-op."""


def mvcc_event(kind: str, **fields) -> None:
    """A transaction event for the isolation checker: a no-op."""
