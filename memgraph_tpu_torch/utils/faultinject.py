"""Deterministic device fault injection.

Copy of the ``device.*`` points of memgraph_tpu/utils/faultinject.py and
their grammar.  A point is armed programmatically (``arm``) or from the
``MEMGRAPH_TPU_FAULTS`` environment variable at import, comma-separated
specs::

    MEMGRAPH_TPU_FAULTS="device.oom=raise@2,device.hang=delay:0.5@3"

    <point>=<action>[:<arg>]@<hit>[;<hit>...]

Actions: ``raise`` (``FaultInjected``, an OSError), ``kill``
(``os._exit(137)``, as a kill -9 would end the process) and
``delay:<sec>`` (sleep, then continue).  ``@<hits>`` lists the 1-based
hits at which the action fires; without it every hit fires.  Each point
counts its own hits.  An unarmed point costs one module-flag read.
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
)

ACTIONS = ("raise", "kill", "delay")


class FaultInjected(OSError):
    """Raised at an armed point."""


@dataclass
class _FaultSpec:
    point: str
    action: str                      # raise | kill | delay
    arg: float | None = None         # delay seconds
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
    action, _, arg_s = action_part.partition(":")
    action = action.strip()
    if action not in ACTIONS:
        raise ValueError(f"unknown fault action {action!r}")
    arg = float(arg_s or 0.05) if action == "delay" else None
    hits = None
    if hits_part:
        hits = frozenset(int(h) for h in hits_part.split(";") if h)
    return _FaultSpec(point, action, arg, hits)


def arm(point: str, action: str, *, arg: float | None = None,
        at: int | list[int] | None = None) -> None:
    """Arm one point: ``action`` at hit ``at`` (one or a list; every hit
    when None)."""
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
            _FaultSpec(point, action, arg, hits))
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


def fire(point: str) -> None:
    """The hook of a call site: counts a hit and, when an armed spec
    matches it, sleeps, raises ``FaultInjected`` or ends the process."""
    if not _ARMED:
        return
    with _LOCK:
        hit = _COUNTS.get(point, 0) + 1
        _COUNTS[point] = hit
        spec = next((s for s in _SPECS.get(point, ()) if s.matches(hit)),
                    None)
        if spec is not None:
            spec.fired += 1
    if spec is None:
        return
    if spec.action == "delay":
        time.sleep(spec.arg or 0.05)
        return
    if spec.action == "kill":
        log.error("faultinject: killing process at %s (hit %d)", point, hit)
        os._exit(KILL_EXIT_CODE)
    raise FaultInjected(f"injected fault at {point} (hit {hit})")


def _load_env() -> None:
    text = os.environ.get(ENV_VAR, "")
    if text:
        try:
            arm_from_string(text)
        except ValueError:
            log.exception("faultinject: bad %s value %r", ENV_VAR, text)


_load_env()
