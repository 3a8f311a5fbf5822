"""Checkpoint/resume layer for long-running fixpoints.

Port of memgraph_tpu/parallel/checkpoint.py.  A fixpoint runs as chunks
of up to ``k`` iterations (the chunk's carry is the loop state: the
iterate, its convergence metric, the iteration counter), driven from the
host:

  * every completed chunk's carry is copied to HOST memory as a
    :class:`Checkpoint` (k iterations are the most a device fault can
    destroy),
  * a device fault (``utils/devicefault.classify_device_error``) is
    answered by resuming from the last checkpoint, after a
    ``device_lost`` also rebuilding the device-resident inputs through
    the caller's ``rebuild`` hook: resumed, not restarted,
  * resumption is bit-exact: a chunk is a pure function of its carry, so
    re-running from checkpoint ``c`` replays iterations ``c..c+k`` as an
    unfaulted run does,
  * ``checkpoint_every=0`` runs one full-budget chunk.

Every fault, resume, checkpoint and slow chunk is counted in
``utils.metrics.global_metrics`` under the reference's ``analytics.*``
names, and (port only) the iterations a resume redoes in
``analytics.redone_iterations_total``.  The reference's trace span per chunk is dropped (the port has no
``observability/trace.py``, as the kernel server drops a request's
``trace``).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field

from ..observability import stats as mgstats
from ..observability import trace as mgtrace
from ..utils import devicefault
from ..utils.metrics import global_metrics
from ..utils.retry import RetryPolicy


@dataclass(frozen=True)
class Checkpoint:
    """Host-memory snapshot of one algorithm's loop state."""
    algo: str
    iteration: int
    payload: tuple            # host (numpy / python scalar) carry copy


class CheckpointStore:
    """Host-memory checkpoint store keyed by job id, process-local: it
    protects against DEVICE faults (the card's state vanishing), not
    host crashes.  A bounded LRU keeps a long-lived server from
    accumulating dead jobs."""

    MAX_JOBS = 64

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ckpts: dict[str, Checkpoint] = {}

    def put(self, job: str, ckpt: Checkpoint) -> None:
        with self._lock:
            self._ckpts.pop(job, None)        # re-insert: LRU refresh
            self._ckpts[job] = ckpt
            while len(self._ckpts) > self.MAX_JOBS:
                self._ckpts.pop(next(iter(self._ckpts)))
        global_metrics.increment("analytics.checkpoint.saved_total")

    def get(self, job: str) -> Checkpoint | None:
        with self._lock:
            return self._ckpts.get(job)

    def drop(self, job: str) -> None:
        with self._lock:
            self._ckpts.pop(job, None)


_default_store = CheckpointStore()


def default_store() -> CheckpointStore:
    """The process-wide store the entry points default to."""
    return _default_store


@dataclass
class RunReport:
    """What the resumable runner observed, filled in place so the entry
    points keep their (values, err, iters) return."""
    algo: str = ""
    iterations: int = 0          # final iteration count
    chunks: int = 0              # successful chunk dispatches
    checkpoints: int = 0         # host checkpoints written
    resumes: int = 0             # device-fault recoveries
    faults: list = field(default_factory=list)   # typed outcome per fault
    lost_spans: list = field(default_factory=list)  # iters redone/resume
    slow_chunks: int = 0         # chunks exceeding chunk_deadline_s
    rebuilds: int = 0            # device_lost input re-placements

    @property
    def redone_iterations(self) -> int:
        return int(sum(self.lost_spans))


def run_resumable(*, algo: str, chunk, carry, carry_to_host,
                  carry_from_host, iter_of, max_iterations: int,
                  checkpoint_every: int = 0, job: str | None = None,
                  store: CheckpointStore | None = None,
                  retry: RetryPolicy | None = None, rebuild=None,
                  chunk_deadline_s: float | None = None,
                  report: RunReport | None = None):
    """Drive a chunked device loop to completion, surviving device faults.

    ``chunk(carry, it_stop)`` runs until convergence or iteration
    ``it_stop`` and returns the new carry; ``iter_of`` reads its
    iteration counter (on the host: where device errors surface).
    ``carry_to_host``/``carry_from_host`` convert the carry for
    checkpointing.  ``rebuild()`` runs after a ``device_lost`` to re-place
    device-resident inputs (and may return a replacement ``chunk``).
    Returns the final carry."""
    report = report if report is not None else RunReport()
    report.algo = algo
    store = store or default_store()
    retry = retry or RetryPolicy(base_delay=0.05, max_delay=1.0,
                                 max_retries=3)
    k = checkpoint_every if checkpoint_every and checkpoint_every > 0 \
        else max_iterations
    ephemeral = job is None
    if ephemeral:
        job = f"{algo}:{uuid.uuid4().hex}"

    it = int(iter_of(carry))
    prior = store.get(job)
    if prior is not None and prior.algo == algo \
            and prior.iteration > it:
        carry = carry_from_host(prior.payload)
        it = prior.iteration
        global_metrics.increment("analytics.checkpoint.restored_total")
    # iteration-0 checkpoint: a fault during the FIRST chunk also resumes
    # (from the start) instead of failing the run
    store.put(job, Checkpoint(algo, it, carry_to_host(carry)))
    report.checkpoints += 1

    faults_in_a_row = 0
    t_run = time.monotonic()
    try:
        while True:
            it_stop = min(max_iterations, it + k)
            t0 = time.monotonic()
            try:
                # one chunk = one span (a faulted chunk records as an
                # error); the iteration's read ends it on the card's time
                with mgtrace.span("device.chunk") as sp:
                    devicefault.device_fault_point()
                    new_carry = chunk(carry, it_stop)
                    new_it = int(iter_of(new_carry))
                    if sp:
                        sp.set(algo=algo, chunk=report.chunks,
                               it_from=it, it_to=new_it)
            except Exception as e:  # noqa: BLE001 — classified below
                kind = devicefault.classify_device_error(e)
                if kind is None:
                    raise
                report.faults.append(kind)
                global_metrics.increment(
                    f"analytics.device_fault.{kind}_total")
                faults_in_a_row += 1
                if faults_in_a_row > retry.max_retries:
                    raise
                time.sleep(retry.delay_for(faults_in_a_row - 1))
                if kind == "device_lost" and rebuild is not None:
                    replacement = rebuild()
                    if replacement is not None:
                        chunk = replacement
                    report.rebuilds += 1
                ckpt = store.get(job)
                carry = carry_from_host(ckpt.payload)
                it = ckpt.iteration
                report.resumes += 1
                # the failed chunk's partial progress is discarded: at
                # most it_stop - checkpoint iterations (<= k) are redone
                report.lost_spans.append(it_stop - it)
                global_metrics.increment("analytics.resume_total")
                global_metrics.increment(
                    "analytics.redone_iterations_total", it_stop - it)
                continue
            faults_in_a_row = 0
            elapsed = time.monotonic() - t0
            # the first completed chunk folds in the kernels' first-use
            # build, later chunks are iteration time (the reference's
            # convention for XLA's compile)
            mgstats.record_stage(
                "device_compile" if report.chunks == 0
                else "device_iterate", elapsed)
            if chunk_deadline_s is not None and elapsed > chunk_deadline_s:
                # the chunk COMPLETED, late
                report.slow_chunks += 1
                global_metrics.increment(
                    "analytics.chunk_deadline_exceeded_total")
            carry = new_carry
            report.chunks += 1
            if new_it >= max_iterations or new_it < it_stop \
                    or new_it == it:
                # budget spent, or the loop's own convergence check
                # stopped it before the chunk cap
                it = new_it
                break
            it = new_it
            store.put(job, Checkpoint(algo, it, carry_to_host(carry)))
            report.checkpoints += 1
    finally:
        if ephemeral:
            store.drop(job)
        global_metrics.observe("analytics.resumable_run_seconds",
                               time.monotonic() - t_run)
    report.iterations = it
    if not ephemeral:
        store.drop(job)   # completed: the job's checkpoint is obsolete
    return carry
