"""Framework-wide exception hierarchy.

Copy of memgraph_tpu/exceptions.py, with two classes of the port's own:
``NotPortedException``, the typed refusal of a query family whose
modules a later slice of the port brings, and ``DeviceWorkRefused``, a
forked read worker's refusal of a plan that reaches the device.

Mirrors the error taxonomy the reference surfaces to clients (storage errors
at memgraph/src/storage/v2/storage.hpp, query exceptions at
memgraph/src/query/exceptions.hpp) without copying its structure.
"""


class MemgraphTpuError(Exception):
    """Base class for all framework errors."""


# --- storage-level -----------------------------------------------------------

class StorageError(MemgraphTpuError):
    pass


class SerializationError(StorageError):
    """Write-write conflict between concurrent transactions (optimistic MVCC)."""


class ConstraintViolation(StorageError):
    def __init__(self, message, constraint=None):
        super().__init__(message)
        self.constraint = constraint


class DurabilityError(StorageError):
    pass


# --- query-level -------------------------------------------------------------

class QueryException(MemgraphTpuError):
    pass


#: the later slices of the port, as the waiting families name them
SLICE_HOST_FEATURES = ("streams, triggers, TTL, dump, enums, text and "
                       "point indexes, on-disk storage")
SLICE_OBSERVABILITY = ("observability (HTTP metrics, audit, telemetry, "
                       "monitoring)")


class NotPortedException(QueryException):
    """A query family the port does not run yet: ``family`` names it and
    ``slice`` the later slice of the port that brings it."""

    def __init__(self, family: str, slice: str) -> None:
        super().__init__(f"{family} is not available in memgraph_tpu_torch "
                         f"yet: it comes with the port's {slice} slice")
        self.family = family
        self.slice = slice


class SyntaxException(QueryException):
    """Cypher lexical/grammatical error. Client code: Memgraph.ClientError."""


class SemanticException(QueryException):
    """Valid syntax, invalid meaning (unbound symbol, bad aggregation, ...)."""


class TypeException(QueryException):
    """Runtime type mismatch in expression evaluation."""


class EntityNotFound(QueryException):
    """Access to a deleted graph entity's properties or labels
    (TCK: EntityNotFound / DeletedEntityAccess)."""


class ArithmeticException(QueryException):
    pass


class ProfileException(QueryException):
    pass


class HintedAbortError(QueryException):
    """Query killed (timeout / TERMINATE TRANSACTIONS / shutdown)."""


class TransactionException(QueryException):
    pass


class ReplicaUnavailableException(TransactionException):
    """Commit refused BEFORE any replica prepared: the write definitely
    did not happen anywhere (a safe, non-ambiguous failure — chaos
    clients may record it as a clean fail, not indeterminate)."""


class FencedException(TransactionException):
    """This MAIN holds a stale fencing epoch — a newer MAIN was
    promoted. Refused before any effect; definitely did not happen."""


class ProcedureException(QueryException):
    """Error raised from a CALLed query module procedure."""


class DeviceWorkRefused(QueryException):
    """A forked read worker (server/mp_executor.py) refuses a query whose
    plan reaches the device: a compiled read lane or a procedure call.
    Decided from the plan before it runs; the caller runs such a query
    on its in-process interpreter."""


class WorkerCrashedError(MemgraphTpuError, ConnectionError):
    """A pooled worker process died mid-request. The pool has already
    respawned it, so reads are RETRYABLE — ConnectionError in the MRO
    means RetryPolicy's default ``retry_on`` catches it without
    special-casing (mp_executor and the shard plane both raise this).

    ``in_doubt`` distinguishes the two crash windows for writers: False
    means the request was never handed to the worker (replaced while
    queued — safe to blindly re-send), True means it died after the
    request was on the wire, so a non-idempotent op may or may not have
    applied and must NOT be blindly retried (see WriteInDoubtError)."""

    def __init__(self, message: str, *, in_doubt: bool = False) -> None:
        super().__init__(message)
        self.in_doubt = in_doubt


class WriteInDoubtError(MemgraphTpuError):
    """A non-idempotent write crashed in the in-doubt window: the owner
    died after the request was sent but before the ack, so the write
    may or may not be in the shard's WAL. Surfaced instead of retried —
    a blind re-send could double-apply. Callers that can verify
    (read-your-write, idempotency keys) may resolve the doubt
    themselves; chaos checkers record it as indeterminate."""


class ShardError(MemgraphTpuError):
    pass


class StaleShardEpoch(ShardError):
    """A shard owner refused a write because the request's routing
    epoch does not match its grant (stale client map, or a fenced
    deposed owner). Carries the owner's epoch so the client can refresh
    the shard map and retry against the current owner."""

    def __init__(self, shard_id: int, epoch: int,
                 fenced: bool = False) -> None:
        what = "fenced owner" if fenced else "stale routing epoch"
        super().__init__(f"shard {shard_id}: {what} "
                         f"(owner epoch {epoch})")
        self.shard_id = shard_id
        self.epoch = epoch
        self.fenced = fenced


class AuthException(MemgraphTpuError):
    pass


#: Worker-shipped error envelopes carry ``(type_name, message)``
#: strings; this is the decode table back into the typed taxonomy.
#: Message-only constructors only — classes with structured payloads
#: (StaleShardEpoch) or process-lifecycle semantics (WorkerCrashedError,
#: WriteInDoubtError) are deliberately absent and fall through to the
#: MemgraphTpuError catch-all.
WIRE_ERRORS = {
    "MemgraphTpuError": MemgraphTpuError,
    "StorageError": StorageError,
    "SerializationError": SerializationError,
    "ConstraintViolation": ConstraintViolation,
    "DurabilityError": DurabilityError,
    "QueryException": QueryException,
    "SyntaxException": SyntaxException,
    "SemanticException": SemanticException,
    "TypeException": TypeException,
    "EntityNotFound": EntityNotFound,
    "ArithmeticException": ArithmeticException,
    "ProfileException": ProfileException,
    "HintedAbortError": HintedAbortError,
    "TransactionException": TransactionException,
    "ReplicaUnavailableException": ReplicaUnavailableException,
    "FencedException": FencedException,
    "ProcedureException": ProcedureException,
    "DeviceWorkRefused": DeviceWorkRefused,
    "ShardError": ShardError,
    "AuthException": AuthException,
}


def raise_wire_error(type_name: str, message: str):
    """Rehydrate a worker error envelope into its taxonomy class, so
    pool/plane clients surface SyntaxException as SyntaxException
    instead of a stringly generic error. Unknown type names (builtin
    exceptions, future classes crossing an old wire) degrade to
    MemgraphTpuError with the name preserved in the message."""
    cls = WIRE_ERRORS.get(type_name)
    if cls is None:
        raise MemgraphTpuError(f"{type_name}: {message}")
    raise cls(message)
