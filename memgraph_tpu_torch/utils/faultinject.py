"""Deterministic fault injection for the device, durability and cluster paths.

Copy of the ``device.*``, durability, replication, Raft and management
points of memgraph_tpu/utils/faultinject.py, their grammar and its
network model (the stream points come with their slice).  A point is
armed programmatically (``arm``) or from the ``MEMGRAPH_TPU_FAULTS``
environment variable at import, comma-separated specs::

    MEMGRAPH_TPU_FAULTS="device.oom=raise@2,wal.write=torn:7+kill@5"

    <point>=<action>[:<arg>][+<then>]@<hit>[;<hit>...]

Actions: ``raise`` (``FaultInjected``, an OSError), ``kill``
(``os._exit(137)``, as a kill -9 would end the process),
``drop`` (``fire`` returns "drop" and the site skips the operation:
a lost RPC), ``delay:<sec>`` (sleep, then continue) and, at write sites,
``torn:<n>`` (write the record's first n bytes, flush them, then raise,
or with ``+kill`` end the process: a crash mid-write at an exact byte
offset).  ``@<hits>`` lists the 1-based hits at which the action fires;
without it every hit fires.  Each point counts its own hits.  An
unarmed point costs one module-flag read.  ``seeded_schedule`` derives
hit numbers from a seed, so a randomized campaign replays exactly.

The network model faults links instead of call sites: rules keyed on
(src, dst) logical node names (``net_partition``, ``net_delay``, ...),
read by every cluster RPC site in both directions through ``net_fire``.
"""

from __future__ import annotations

import logging
import os
import random
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
    "repl.send",       # ReplicaClient frame/system/2PC sends
    "repl.recv",       # ReplicaServer, before handling a received frame
    "raft.rpc",        # RaftNode._call_peer ("drop" = RPC lost)
    "mgmt.rpc",        # coordination.mgmt_call ("drop" = mgmt RPC lost)
)

ACTIONS = ("raise", "kill", "drop", "delay", "torn")


class FaultInjected(OSError):
    """Raised at an armed point."""


@dataclass
class _FaultSpec:
    point: str
    action: str                      # raise | kill | drop | delay | torn
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


def disarm(point: str) -> None:
    """Disarm one point; its hit count is kept, so re-arming it at a
    seeded hit number replays exactly."""
    global _ARMED
    with _LOCK:
        _SPECS.pop(point, None)
        _ARMED = bool(_SPECS)


def reset(reload_env: bool = False) -> None:
    """Disarm every point and the network model, and zero the hit
    counts."""
    global _ARMED, _NET_ARMED
    with _LOCK:
        _SPECS.clear()
        _COUNTS.clear()
        _ARMED = False
        _NET_RULES.clear()
        _NET_ARMED = False
    if reload_env:
        _load_env()


def hit_count(point: str) -> int:
    with _LOCK:
        return _COUNTS.get(point, 0)


def seeded_schedule(seed: int, points=KNOWN_POINTS,
                    max_hit: int = 16) -> dict[str, int]:
    """{point: hit number} drawn from ``seed``, the points in sorted
    order: the same seed always gives the same schedule."""
    rng = random.Random(seed)
    return {p: rng.randint(1, max_hit) for p in sorted(points)}


def arm_seeded(seed: int, points=KNOWN_POINTS, action: str = "raise",
               max_hit: int = 16) -> dict[str, int]:
    schedule = seeded_schedule(seed, points, max_hit)
    for point, hit in schedule.items():
        arm(point, action, at=hit)
    return schedule


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


def _execute(spec: _FaultSpec, hit: int) -> str | None:
    if spec.action == "delay":
        time.sleep(spec.arg or 0.05)
        return None
    if spec.action == "drop":
        log.warning("faultinject: dropping at %s (hit %d)", spec.point, hit)
        return "drop"
    if spec.action == "kill":
        log.error("faultinject: killing process at %s (hit %d)",
                  spec.point, hit)
        os._exit(KILL_EXIT_CODE)
    # raise (a torn spec fired through fire() has no payload to tear)
    raise FaultInjected(f"injected fault at {spec.point} (hit {hit})")


def fire(point: str) -> str | None:
    """The hook of a call site: counts a hit and, when an armed spec
    matches it, sleeps, raises ``FaultInjected``, ends the process, or
    returns "drop" (the site skips the operation); None to continue."""
    if not _ARMED:
        return None
    spec, hit = _next_matching(point)
    if spec is None:
        return None
    return _execute(spec, hit)


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
    if _execute(spec, hit) == "drop":
        return          # the write is silently lost
    fileobj.write(data)


# --- the network model: rules on (src, dst) links --------------------------
#
# Every cluster RPC site (raft._call_peer, replication send / ack, the
# coordinator's mgmt RPCs) reads the rules of its direction, so a one-way
# partition behaves like a real one: the request arrives and runs, only
# its ack is lost.  "*" matches any node.  Process-global like the points:
# an in-process cluster shares one network.

NET_ACTIONS = ("drop", "delay", "duplicate", "reorder")


@dataclass
class _LinkRule:
    src: str                 # node name or "*"
    dst: str
    action: str              # one of NET_ACTIONS
    arg: float = 0.0         # delay seconds / reorder's largest jitter

    def matches(self, src: str | None, dst: str | None) -> bool:
        # None: the caller declared no node identity (an admin or test
        # connection), which no rule matches
        if src is None or dst is None:
            return False
        return (self.src == "*" or self.src == src) and \
            (self.dst == "*" or self.dst == dst)


_NET_RULES: list[_LinkRule] = []
_NET_ARMED = False           # fast path: an unarmed net_fire() is one read
_NET_RNG = random.Random(0)  # reorder jitter; reseeded by net_seed()


def net_seed(seed: int) -> None:
    """Seed the jitter so reorder delays replay exactly."""
    global _NET_RNG
    with _LOCK:
        _NET_RNG = random.Random(seed)


def _net_add(src: str, dst: str, action: str, arg: float = 0.0) -> None:
    if action not in NET_ACTIONS:
        raise ValueError(f"unknown net action {action!r} "
                         f"(known: {', '.join(NET_ACTIONS)})")
    global _NET_ARMED
    with _LOCK:
        _NET_RULES.append(_LinkRule(src, dst, action, arg))
        _NET_ARMED = True


def net_partition(a: str, b: str, *, bidirectional: bool = True) -> None:
    """Partition a <-> b (only a -> b with ``bidirectional=False``)."""
    _net_add(a, b, "drop")
    if bidirectional:
        _net_add(b, a, "drop")


def net_partition_node(node: str) -> None:
    """Isolate one node from every other, both directions."""
    _net_add(node, "*", "drop")
    _net_add("*", node, "drop")


def net_delay(a: str, b: str, seconds: float, *,
              bidirectional: bool = True) -> None:
    _net_add(a, b, "delay", seconds)
    if bidirectional:
        _net_add(b, a, "delay", seconds)


def net_duplicate(a: str, b: str, *, bidirectional: bool = True) -> None:
    _net_add(a, b, "duplicate")
    if bidirectional:
        _net_add(b, a, "duplicate")


def net_reorder(a: str, b: str, jitter: float = 0.05, *,
                bidirectional: bool = True) -> None:
    """A seeded random delay a message: messages overtake each other."""
    _net_add(a, b, "reorder", jitter)
    if bidirectional:
        _net_add(b, a, "reorder", jitter)


def net_heal(a: str | None = None, b: str | None = None) -> None:
    """Remove link rules: all of them, every rule touching ``a``, or both
    directions of the pair (a, b)."""
    global _NET_ARMED
    with _LOCK:
        if a is None:
            _NET_RULES.clear()
        elif b is None:
            _NET_RULES[:] = [r for r in _NET_RULES
                             if a not in (r.src, r.dst)]
        else:
            _NET_RULES[:] = [r for r in _NET_RULES
                             if {r.src, r.dst} != {a, b}
                             and (r.src, r.dst) not in ((a, b), (b, a))]
        _NET_ARMED = bool(_NET_RULES)


def net_links() -> list[tuple[str, str, str]]:
    """The rules as (src, dst, action)."""
    with _LOCK:
        return [(r.src, r.dst, r.action) for r in _NET_RULES]


def _net_execute(rules: list[_LinkRule]) -> str | None:
    """A drop wins, delays add up, a duplicate is returned to the caller
    (which sends again)."""
    result = None
    sleep_s = 0.0
    for rule in rules:
        if rule.action == "drop":
            return "drop"
        if rule.action == "delay":
            sleep_s += rule.arg
        elif rule.action == "reorder":
            with _LOCK:
                sleep_s += _NET_RNG.random() * rule.arg
        elif rule.action == "duplicate":
            result = "duplicate"
    if sleep_s > 0.0:
        time.sleep(sleep_s)
    return result


def net_fire(src: str | None, dst: str | None) -> str | None:
    """The link hook of one message direction src -> dst: "drop" when the
    message is lost, "duplicate" when the caller should deliver it
    twice, None to continue (delays already slept).  ``None`` for src or
    dst marks traffic without a node identity, which no rule matches."""
    if not _NET_ARMED:
        return None
    if src is None or dst is None:
        return None
    with _LOCK:
        matched = [r for r in _NET_RULES if r.matches(src, dst)]
    if not matched:
        return None
    return _net_execute(matched)


def _renew_lock_after_fork() -> None:
    """A child forked while another thread held ``_LOCK`` gets a fresh one
    (see ``utils.locks.fork_safe``)."""
    global _LOCK
    _LOCK = threading.Lock()


os.register_at_fork(after_in_child=_renew_lock_after_fork)


def _load_env() -> None:
    text = os.environ.get(ENV_VAR, "")
    if text:
        try:
            arm_from_string(text)
        except ValueError:
            log.exception("faultinject: bad %s value %r", ENV_VAR, text)


_load_env()
