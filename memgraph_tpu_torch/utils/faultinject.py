"""Deterministic fault injection for the device and durability paths.

Copy of the ``device.*`` and durability points of
memgraph_tpu/utils/faultinject.py and their grammar (the replication,
Raft, management and stream points, and the network model, come with
their slices).  A point is armed programmatically (``arm``) or from the
``MEMGRAPH_TPU_FAULTS`` environment variable at import, comma-separated
specs::

    MEMGRAPH_TPU_FAULTS="device.oom=raise@2,wal.write=torn:7+kill@5"

    <point>=<action>[:<arg>][+<then>]@<hit>[;<hit>...]

Actions: ``raise`` (``FaultInjected``, an OSError), ``kill``
(``os._exit(137)``, as a kill -9 would end the process),
``delay:<sec>`` (sleep, then continue) and, at write sites,
``torn:<n>`` (write the record's first n bytes, flush them, then raise,
or with ``+kill`` end the process: a crash mid-write at an exact byte
offset).  ``@<hits>`` lists the 1-based hits at which the action fires;
without it every hit fires.  Each point counts its own hits.  An
unarmed point costs one module-flag read.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field

log = logging.getLogger(__name__)

ENV_VAR = "MEMGRAPH_TPU_FAULTS"
KILL_EXIT_CODE = 137  # the code a SIGKILLed process reports

#: the points (utils/devicefault.py turns them into typed errors at every
#: device dispatch); arming another name is an error
KNOWN_POINTS = (
    "device.call",     # a dispatch fails (the kernel or its launch)
    "device.oom",      # device memory exhausted
    "device.hang",     # armed delay:<sec>: the dispatch stalls
    "device.lost",     # the card is gone: "raise" in process, "kill" ends it
    "wal.write",       # WalFile.sink, around the record write (torn-able)
    "wal.fsync",       # WalFile.sink, before os.fsync
    "snapshot.rename", # create_snapshot, before the tmp -> final os.replace
    "kvstore.put",     # KVStore.put, before the sqlite write
)

ACTIONS = ("raise", "kill", "delay", "torn")


class FaultInjected(OSError):
    """Raised at an armed point."""


@dataclass
class _FaultSpec:
    point: str
    action: str                      # raise | kill | delay | torn
    arg: float | None = None         # delay seconds / torn byte count
    then: str = "raise"              # torn's follow-up: raise | kill
    hits: frozenset[int] | None = None   # 1-based; None: every hit
    fired: int = field(default=0)

    def matches(self, hit: int) -> bool:
        return self.hits is None or hit in self.hits


_LOCK = threading.Lock()
_SPECS: dict[str, list[_FaultSpec]] = {}
_COUNTS: dict[str, int] = {}
_ARMED = False   # fast path: an unarmed fire() is one global read


def _parse_spec(text: str) -> _FaultSpec:
    text = text.strip()
    point, _, rest = text.partition("=")
    point = point.strip()
    if point not in KNOWN_POINTS:
        raise ValueError(f"unknown fault point {point!r} "
                         f"(known: {', '.join(KNOWN_POINTS)})")
    if not rest:
        raise ValueError(f"fault spec {text!r} has no action")
    action_part, _, hits_part = rest.partition("@")
    then = "raise"
    if "+" in action_part:
        action_part, _, then = action_part.partition("+")
        if then not in ("raise", "kill"):
            raise ValueError(f"bad torn follow-up {then!r}")
    action, _, arg_s = action_part.partition(":")
    action = action.strip()
    if action not in ACTIONS:
        raise ValueError(f"unknown fault action {action!r}")
    arg: float | None = None
    if action == "delay":
        arg = float(arg_s or 0.05)
    elif action == "torn":
        arg = int(arg_s or 0)
    hits = None
    if hits_part:
        hits = frozenset(int(h) for h in hits_part.split(";") if h)
    return _FaultSpec(point, action, arg, then, hits)


def arm(point: str, action: str, *, arg: float | None = None,
        at: int | list[int] | None = None, then: str = "raise") -> None:
    """Arm one point: ``action`` at hit ``at`` (one or a list; every hit
    when None); ``then`` is a torn write's follow-up."""
    global _ARMED
    if point not in KNOWN_POINTS:
        raise ValueError(f"unknown fault point {point!r}")
    if action not in ACTIONS:
        raise ValueError(f"unknown fault action {action!r}")
    hits = None
    if at is not None:
        hits = frozenset([at] if isinstance(at, int) else at)
    with _LOCK:
        _SPECS.setdefault(point, []).append(
            _FaultSpec(point, action, arg, then, hits))
        _ARMED = True


def arm_from_string(text: str) -> None:
    """Arm from the environment variable's grammar."""
    global _ARMED
    for chunk in text.split(","):
        if not chunk.strip():
            continue
        spec = _parse_spec(chunk)
        with _LOCK:
            _SPECS.setdefault(spec.point, []).append(spec)
            _ARMED = True


def reset(reload_env: bool = False) -> None:
    """Disarm every point and zero the hit counts."""
    global _ARMED
    with _LOCK:
        _SPECS.clear()
        _COUNTS.clear()
        _ARMED = False
    if reload_env:
        _load_env()


def hit_count(point: str) -> int:
    with _LOCK:
        return _COUNTS.get(point, 0)


def _next_matching(point: str) -> tuple[_FaultSpec | None, int]:
    """Count a hit on ``point``; the armed spec that fires on it, and the
    hit's number."""
    with _LOCK:
        hit = _COUNTS.get(point, 0) + 1
        _COUNTS[point] = hit
        spec = next((s for s in _SPECS.get(point, ()) if s.matches(hit)),
                    None)
        if spec is not None:
            spec.fired += 1
    return spec, hit


def _execute(spec: _FaultSpec, hit: int) -> None:
    if spec.action == "delay":
        time.sleep(spec.arg or 0.05)
        return
    if spec.action == "kill":
        log.error("faultinject: killing process at %s (hit %d)",
                  spec.point, hit)
        os._exit(KILL_EXIT_CODE)
    # raise (a torn spec fired through fire() has no payload to tear)
    raise FaultInjected(f"injected fault at {spec.point} (hit {hit})")


def fire(point: str) -> None:
    """The hook of a call site: counts a hit and, when an armed spec
    matches it, sleeps, raises ``FaultInjected`` or ends the process."""
    if not _ARMED:
        return
    spec, hit = _next_matching(point)
    if spec is not None:
        _execute(spec, hit)


def faulty_write(point: str, fileobj, data: bytes) -> None:
    """Write ``data`` to ``fileobj``, honouring the faults armed at
    ``point``: a torn spec writes the first n bytes, flushes them so they
    land in the file, then raises (or ends the process)."""
    if not _ARMED:
        fileobj.write(data)
        return
    spec, hit = _next_matching(point)
    if spec is None:
        fileobj.write(data)
        return
    if spec.action == "torn":
        n = int(spec.arg or 0)
        fileobj.write(data[:n])
        fileobj.flush()
        log.error("faultinject: torn write at %s: %d/%d bytes (hit %d)",
                  point, n, len(data), hit)
        if spec.then == "kill":
            os._exit(KILL_EXIT_CODE)
        raise FaultInjected(
            f"injected torn write at {point}: {n}/{len(data)} bytes")
    _execute(spec, hit)
    fileobj.write(data)


def _load_env() -> None:
    text = os.environ.get(ENV_VAR, "")
    if text:
        try:
            arm_from_string(text)
        except ValueError:
            log.exception("faultinject: bad %s value %r", ENV_VAR, text)


_load_env()
