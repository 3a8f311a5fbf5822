"""The device mesh: an ordered tuple of torch devices, one per shard, and
the collectives that combine the shards' payloads.

Port of memgraph_tpu/parallel/mesh.py.  JAX's ``shard_map`` is single
controller: one process drives every device of the mesh.  So is this
mesh: one process holds every shard, each shard's edge row lives on its
own device, and a collective is a plain function over the shards'
payloads (a list, shard order):

  ``psum_scatter``  row q of every shard's (P, ...) payload, summed, lands
                    on shard q
  ``psum``          the sum of every shard's payload, on every shard
  ``pmin``/``pmax`` the elementwise min / max, on every shard
  ``all_gather``    the shards' blocks concatenated in shard order, on
                    every shard

Each collective reduces in a fixed shard order (shard 0, then 1, ...) on
the owner's device, copying between distinct devices with
``tensor.to(dev, non_blocking=True)``, so its answer is bit-equal from
run to run, whatever the devices.  Shards on one device share one result
(computed once).  ``collective_counts`` counts the collectives by kind,
which keeps the reference's "one collective an iteration" contract
checkable.

A mesh of 1 is the same code path, not a second implementation: its
collectives return the one payload as it is.

Devices: ``get_mesh_context(n)`` takes the first ``n`` visible CUDA
devices, or raises.  A caller may also name them, with repeats:
``("cuda:0",) * 4`` runs four shards on one card, ``("cpu",) * 8`` eight
on the CPU (the counterpart of the JAX tests' 8 virtual host devices).
All devices of a mesh are of one type; a payload that lies elsewhere
than its shard's device is refused.

``analytics_mesh()`` is the process default the ops route through:
MEMGRAPH_TPU_MESH_DEVICES = "all" | "<int>" (unset: no mesh, the
single-chip routes).  On the CPU (an entry point asked for ``device="cpu"``)
an integer gives that many ``cpu`` shards and "all" one.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device

logger = logging.getLogger(__name__)

_EDGE_AXIS = "shard"


def device_count() -> int:
    """Visible CUDA devices (0 on a host without a card)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def streaming_device() -> torch.device:
    """The device the out-of-core streamed tier targets: the first
    visible card (raises without one)."""
    return resolve_device(None)


@dataclass(frozen=True)
class MeshContext:
    """An ordered tuple of devices, one per shard, over one named axis.

    Edge rows are placed one a shard (``put_edge_blocks``); O(n) vertex
    vectors are replicated (``put_replicated``: one copy a distinct
    device, shared by the shards on it) or blocked over the shards."""

    devices: tuple
    axis: str = _EDGE_AXIS

    def __post_init__(self):
        devs = tuple(resolve_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            named = sorted({str(d) for d in devs})
            raise ValueError(
                "a mesh's shards must all be on cuda or all on cpu: a "
                f"collective cannot reach across {named}")
        object.__setattr__(self, "devices", devs)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The distinct devices, in shard order."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def cache_key(self):
        """Stable identity for per-graph placement caches."""
        return (self.axis, self.n_shards, tuple(str(d) for d in self.devices))

    def put_edge_blocks(self, arr) -> tuple:
        """A (n_shards, ...) host array as one tensor a shard, row p on
        shard p's device (each row uploaded once, from pinned memory on a
        card; the caller synchronizes before the rows are read)."""
        arr = np.asarray(arr)
        if arr.shape[0] != self.n_shards:
            raise ValueError(f"{arr.shape[0]} rows for {self.n_shards} "
                             "shards")
        return tuple(_upload(arr[p], dev)
                     for p, dev in enumerate(self.devices))

    def put_replicated(self, arr) -> tuple:
        """A host array on every shard: one upload a distinct device,
        shared by the shards on it."""
        by_dev = {dev: _upload(arr, dev) for dev in self.distinct}
        return tuple(by_dev[d] for d in self.devices)

    def synchronize(self) -> None:
        for dev in self.distinct:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def _upload(a, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cpu":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


_ctx_cache: dict = {}
_ctx_lock = threading.Lock()


def get_mesh_context(n_devices: int | None = None, axis: str = _EDGE_AXIS,
                     *, devices=None, device=None) -> MeshContext:
    """Build (or fetch the cached) MeshContext.

    ``devices`` names the shards' devices, repeats allowed.  Otherwise
    ``device`` picks the type: ``cpu`` gives ``n_devices`` cpu shards
    (default 1); a CUDA device (the default) the first ``n_devices``
    visible cards (default: all), or just that card for one shard.
    ``n_devices=1`` is the mesh-of-1 degeneracy."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cpu":
            devices = (dev,) * (1 if n_devices is None else int(n_devices))
        elif n_devices == 1 and device is not None:
            devices = (dev,)
        else:
            count = device_count()
            n = count if n_devices is None else int(n_devices)
            if not 1 <= n <= count:
                raise ValueError(
                    f"requested {n} devices; {count} available")
            devices = tuple(torch.device("cuda", i) for i in range(n))
    elif n_devices is not None and int(n_devices) != len(devices):
        raise ValueError(f"{n_devices} shards asked, {len(devices)} "
                         "devices named")
    ctx = MeshContext(devices=tuple(devices), axis=axis)
    with _ctx_lock:
        return _ctx_cache.setdefault(ctx.cache_key, ctx)


def analytics_mesh(device=None) -> MeshContext | None:
    """Process-default mesh for the ops' analytics, or None (single
    chip): MEMGRAPH_TPU_MESH_DEVICES = "all" | "<int>"; unset keeps the
    single-chip routes.  ``device``: the entry point's device (cpu: an
    integer gives that many cpu shards, "all" one)."""
    spec = os.environ.get("MEMGRAPH_TPU_MESH_DEVICES", "").strip()
    if not spec:
        return None
    dev = resolve_device(device)
    if spec.lower() == "all":
        return get_mesh_context(1 if dev.type == "cpu" else None,
                                device=dev)
    try:
        n = int(spec)
    except ValueError:
        logger.warning("MEMGRAPH_TPU_MESH_DEVICES=%r is not an int or "
                       "'all'; ignoring", spec)
        return None
    n = max(n, 1)
    if dev.type == "cuda":
        n = min(n, device_count())
    return get_mesh_context(n, device=dev)


def resolve_mesh(mesh=None, device=None) -> MeshContext | None:
    """Normalize an algorithm's ``mesh=`` argument: None (the
    environment's ``analytics_mesh``, usually None), an int shard count
    (on ``device``'s type), a tuple or list of devices (repeats allowed),
    or a ready MeshContext."""
    if mesh is None:
        return analytics_mesh(device)
    if isinstance(mesh, MeshContext):
        return mesh
    if isinstance(mesh, (int, np.integer)) and not isinstance(mesh, bool):
        return get_mesh_context(int(mesh), device=device)
    if isinstance(mesh, (tuple, list)):
        return get_mesh_context(devices=tuple(mesh))
    raise TypeError("mesh must be None, an int, a tuple of devices or a "
                    f"MeshContext; got {type(mesh).__name__}")


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

#: collectives run in this process, by kind
collective_counts = {"psum_scatter": 0, "psum": 0, "pmin": 0, "pmax": 0,
                     "all_gather": 0}


def collectives_total() -> int:
    return sum(collective_counts.values())


def reset_collective_counts() -> None:
    for k in collective_counts:
        collective_counts[k] = 0


def _check(ctx: MeshContext, payloads, name: str) -> None:
    if len(payloads) != ctx.n_shards:
        raise ValueError(f"{name}: {len(payloads)} payloads for "
                         f"{ctx.n_shards} shards")
    for p, (t, dev) in enumerate(zip(payloads, ctx.devices)):
        if t.device != dev:
            raise ValueError(f"{name}: shard {p}'s payload lies on "
                             f"{t.device}, not on its device {dev}")
    collective_counts[name] += 1


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev, non_blocking=True)


def _fold(payloads, dev, op):
    acc = _to(payloads[0], dev)
    for t in payloads[1:]:
        acc = op(acc, _to(t, dev))
    return acc


def _replicated_fold(ctx, payloads, name, op):
    _check(ctx, payloads, name)
    if ctx.n_shards == 1:
        return [payloads[0]]
    got = {dev: _fold(payloads, dev, op) for dev in ctx.distinct}
    return [got[d] for d in ctx.devices]


def psum(ctx: MeshContext, payloads) -> list:
    """Σ_p payloads[p], in shard order, on every shard."""
    return _replicated_fold(ctx, payloads, "psum", torch.add)


def pmin(ctx: MeshContext, payloads) -> list:
    """The elementwise min of the payloads, on every shard."""
    return _replicated_fold(ctx, payloads, "pmin", torch.minimum)


def pmax(ctx: MeshContext, payloads) -> list:
    """The elementwise max of the payloads, on every shard."""
    return _replicated_fold(ctx, payloads, "pmax", torch.maximum)


def psum_scatter(ctx: MeshContext, payloads) -> list:
    """payloads[p] is (P, ...): shard q gets Σ_p payloads[p][q], summed in
    shard order on its own device."""
    _check(ctx, payloads, "psum_scatter")
    P = ctx.n_shards
    for t in payloads:
        if t.shape[0] != P:
            raise ValueError(f"psum_scatter: a payload of {t.shape[0]} "
                             f"rows for {P} shards")
    if P == 1:
        return [payloads[0][0]]
    if len(ctx.distinct) == 1:
        # one device: every row's fold at once (the same adds, in order)
        return list(_fold(payloads, ctx.devices[0], torch.add).unbind(0))
    return [_fold([t[q] for t in payloads], ctx.devices[q], torch.add)
            for q in range(P)]


def all_gather(ctx: MeshContext, blocks) -> list:
    """The shards' blocks concatenated in shard order, on every shard."""
    _check(ctx, blocks, "all_gather")
    if ctx.n_shards == 1:
        return [blocks[0]]
    got = {dev: torch.cat([_to(b, dev) for b in blocks])
           for dev in ctx.distinct}
    return [got[d] for d in ctx.devices]


def replicated(ctx: MeshContext, fn, *per_shard) -> list:
    """``fn`` of replicated per-shard arguments, run once a distinct
    device (the shards on one device share the result)."""
    got = {}
    for p, dev in enumerate(ctx.devices):
        if dev not in got:
            got[dev] = fn(*(a[p] for a in per_shard))
    return [got[d] for d in ctx.devices]
