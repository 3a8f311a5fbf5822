"""Minimal synchronous Bolt client.

Counterpart of the reference's test/client bolt client
(memgraph/src/communication/bolt/client.cpp): handshake, HELLO/LOGON,
RUN/PULL, explicit transactions. Used by the e2e tests and usable as a thin
Python driver for the server.

Copy of memgraph_tpu/server/client.py for the port (its imports the
port's own).
"""

from __future__ import annotations

import socket
import struct

from ..exceptions import MemgraphTpuError
from . import packstream as ps
from .bolt import (BOLT_MAGIC, M_BEGIN, M_COMMIT, M_GOODBYE, M_HELLO,
                   M_LOGON, M_PULL, M_RECORD, M_RESET, M_ROLLBACK,
                   M_ROUTE, M_RUN, M_SUCCESS, M_FAILURE, M_IGNORED)


class BoltClientError(MemgraphTpuError):
    def __init__(self, code, message):
        super().__init__(f"{code}: {message}")
        self.code = code


class BoltClient:
    def __init__(self, host="127.0.0.1", port=7687, username="",
                 password="", timeout=30.0, versions=None,
                 encrypted=False, ca_file=None, scheme="basic"):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        if encrypted:  # bolt+s: TLS from the first byte
            from ..utils.tls import client_context
            # hostname verification on when a CA is pinned (end-user path)
            self.sock = client_context(ca_file).wrap_socket(
                self.sock, server_hostname=host)
        self._versions = versions or ((5, 2), (5, 0), (4, 4), (4, 3))
        self._handshake()
        self._hello(username, password, scheme)

    # --- wire ---------------------------------------------------------------

    def _handshake(self):
        proposals = b""
        for (maj, minor) in list(self._versions)[:4]:
            proposals += bytes([0, 0, minor, maj])
        while len(proposals) < 16:
            proposals += bytes([0, 0, 0, 0])
        self.sock.sendall(BOLT_MAGIC + proposals)
        chosen = self._recv_exact(4)
        self.version = (chosen[3], chosen[2])
        if self.version == (0, 0):
            raise MemgraphTpuError("bolt version negotiation failed")

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise MemgraphTpuError("connection closed")
            out += chunk
        return out

    def _send_message(self, signature: int, *fields):
        data = ps.pack(ps.Structure(signature, list(fields)))
        msg = b""
        pos = 0
        while pos < len(data):
            chunk = data[pos:pos + 0xFFFF]
            msg += struct.pack(">H", len(chunk)) + chunk
            pos += len(chunk)
        self.sock.sendall(msg + b"\x00\x00")

    def _read_message(self) -> ps.Structure:
        chunks = []
        while True:
            size = struct.unpack(">H", self._recv_exact(2))[0]
            if size == 0:
                if chunks:
                    return ps.unpack(b"".join(chunks))
                continue
            chunks.append(self._recv_exact(size))

    def _expect_success(self) -> dict:
        msg = self._read_message()
        if msg.tag == M_SUCCESS:
            return msg.fields[0] if msg.fields else {}
        if msg.tag == M_FAILURE:
            meta = msg.fields[0]
            raise BoltClientError(meta.get("code", "?"),
                                  meta.get("message", "?"))
        if msg.tag == M_IGNORED:
            raise MemgraphTpuError("request ignored (session failed state)")
        raise MemgraphTpuError(f"unexpected message 0x{msg.tag:02X}")

    # --- protocol -----------------------------------------------------------

    def _hello(self, username, password, scheme="basic"):
        extra = {"user_agent": "memgraph-tpu-client/0.1"}
        if self.version < (5, 1):
            extra.update({"scheme": scheme, "principal": username,
                          "credentials": password})
        self._send_message(M_HELLO, extra)
        self._expect_success()
        if self.version >= (5, 1):
            self._send_message(M_LOGON, {"scheme": scheme,
                                         "principal": username,
                                         "credentials": password})
            self._expect_success()

    def execute(self, query: str, parameters: dict | None = None):
        """Run a query, pull everything. Returns (columns, rows, summary)."""
        self._send_message(M_RUN, query, parameters or {}, {})
        meta = self._expect_success()
        columns = meta.get("fields", [])
        rows = []
        while True:
            self._send_message(M_PULL, {"n": 1000})
            while True:
                msg = self._read_message()
                if msg.tag == M_RECORD:
                    rows.append(msg.fields[0])
                    continue
                if msg.tag == M_SUCCESS:
                    summary = msg.fields[0] if msg.fields else {}
                    break
                if msg.tag == M_FAILURE:
                    m = msg.fields[0]
                    raise BoltClientError(m.get("code", "?"),
                                          m.get("message", "?"))
                raise MemgraphTpuError(
                    f"unexpected message 0x{msg.tag:02X}")
            if not summary.get("has_more"):
                return columns, rows, summary

    def begin(self):
        self._send_message(M_BEGIN, {})
        self._expect_success()

    def commit(self):
        self._send_message(M_COMMIT)
        self._expect_success()

    def rollback(self):
        self._send_message(M_ROLLBACK)
        self._expect_success()

    def reset(self):
        self._send_message(M_RESET)
        self._expect_success()

    def route(self, routing: dict | None = None, db: str | None = None):
        """Fetch the routing table (Bolt 4.3+ ROUTE message)."""
        self._send_message(M_ROUTE, routing or {}, [], db)
        meta = self._expect_success()
        return meta.get("rt")

    def close(self):
        try:
            self._send_message(M_GOODBYE)
        except OSError:
            pass  # peer already gone; GOODBYE is best-effort
        self.sock.close()


class RoutedClient:
    """Route-table-driven writes with failover retry.

    A thin HA driver over :class:`BoltClient` (reference analog: the
    neo4j driver's routing table handling against coordinators): it
    bootstraps from one or more router (coordinator) addresses, fetches
    the ROUTE table, and sends writes to the current writer. On any
    failure it refreshes the table — from ANY reachable router learned
    so far — and retries against the (possibly new) MAIN with
    exponential backoff, so a failover is a handful of retried requests
    instead of an error surfaced to the caller.

    Fencing: the table carries the coordinator's fencing epoch; the
    client remembers the highest epoch it has seen and refuses to go
    back to a table (or writer) from an older one — a partitioned
    coordinator serving a stale table cannot steer writes to a deposed
    MAIN.
    """

    def __init__(self, routers: list[str], username: str = "",
                 password: str = "", retry=None, timeout: float = 10.0):
        from ..utils.retry import RetryPolicy
        if not routers:
            raise MemgraphTpuError("RoutedClient needs >= 1 router")
        self.routers = list(routers)
        self.username = username
        self.password = password
        # the RetryPolicy owns ALL timing: per-connection timeout rides
        # attempt_timeout (the legacy `timeout` arg seeds it), and an
        # optional policy deadline bounds a whole routed write
        self.retry = retry or RetryPolicy(base_delay=0.2, max_delay=2.0,
                                          max_retries=8,
                                          attempt_timeout=timeout)
        self.timeout = self.retry.attempt_timeout \
            if self.retry.attempt_timeout is not None else timeout
        self.known_epoch = 0
        self._writer_addr: str | None = None
        self._writer: BoltClient | None = None
        # shard topology: shard_id -> owner endpoint,
        # refreshed with the writer table under the SAME epoch guard —
        # a stale coordinator can never roll the shard map backwards
        self.shard_table: dict[int, str] = {}

    @staticmethod
    def _split(addr: str) -> tuple[str, int]:
        host, _, port = addr.rpartition(":")
        return host, int(port)

    def refresh_route_table(self) -> bool:
        """Fetch a fresh table from any reachable router; keep only a
        table at least as new (by fencing epoch) as what we know."""
        for router in list(self.routers):
            host, port = self._split(router)
            try:
                rc = BoltClient(host=host, port=port,
                                username=self.username,
                                password=self.password,
                                timeout=self.timeout)
            except (OSError, MemgraphTpuError):
                continue
            try:
                rt = rc.route() or {}
            except (OSError, MemgraphTpuError):
                continue
            finally:
                try:
                    rc.close()
                except OSError:
                    pass
            epoch = int(rt.get("epoch") or 0)
            if epoch < self.known_epoch:
                continue   # stale coordinator (partitioned minority)
            self.known_epoch = max(self.known_epoch, epoch)
            if rt.get("shards"):
                self.shard_table = {int(k): v
                                    for k, v in rt["shards"].items()}
            servers = {s["role"]: s["addresses"]
                       for s in rt.get("servers", [])}
            for r in servers.get("ROUTE", []):
                if r not in self.routers:
                    self.routers.append(r)
            writers = servers.get("WRITE", [])
            if writers:
                if writers[0] != self._writer_addr:
                    self._disconnect()
                    self._writer_addr = writers[0]
                return True
        return False

    def _disconnect(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
            except OSError:
                pass
            self._writer = None

    def _connect_writer(self) -> BoltClient:
        if self._writer is None:
            if self._writer_addr is None and not self.refresh_route_table():
                raise MemgraphTpuError("no writer in any routing table")
            host, port = self._split(self._writer_addr)
            self._writer = BoltClient(host=host, port=port,
                                      username=self.username,
                                      password=self.password,
                                      timeout=self.timeout)
        return self._writer

    def execute_write(self, query: str, parameters: dict | None = None):
        """Run a write on the current MAIN, re-routing with backoff on
        failure. Returns (columns, rows, summary) like BoltClient.

        Timing is RetryPolicy-owned: `attempts()` sleeps the backoff
        between tries and stops early when the policy's overall deadline
        would be crossed — no ad-hoc sleep/timeout constants here."""
        last: Exception | None = None
        for _attempt in self.retry.attempts():
            try:
                return self._connect_writer().execute(query, parameters)
            except BoltClientError as e:
                if e.code.startswith(("Memgraph.ClientError.Statement",
                                      "Memgraph.ClientError.Security")):
                    raise   # the query/auth is wrong; rerouting won't help
                # transaction/transient failures (fenced main, strict
                # replicas unavailable mid-failover) ARE the retry case
                last = e
                self._disconnect()
                self.refresh_route_table()
            except (OSError, MemgraphTpuError) as e:
                last = e
                self._disconnect()
                self.refresh_route_table()
        raise MemgraphTpuError(
            f"write failed after {self.retry.max_retries + 1} routed "
            f"attempts: {last}") from last

    def close(self) -> None:
        self._disconnect()
