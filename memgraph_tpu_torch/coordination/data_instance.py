"""Management server running on each data instance.

Counterpart of the reference's DataInstanceManagementServer
(memgraph/src/coordination/data_instance_management_server.cpp,
registered at memgraph.cpp:964-970): answers coordinator health checks
(STATE_CHECK) and executes promote/demote RPCs during failover.

Copy of memgraph_tpu/coordination/data_instance.py for the port: the
same RPCs on the replication framing, so either package's coordinator
drives the other's data instance.  The ``metrics`` reply reads the
port's ``utils.metrics`` exposition, and a configured kernel daemon's
counters through the port's own ``server/kernel_server``
(``SupervisedKernelClient``, never spawning one).  A server bound to
port 0 reads back the port it got.
"""

from __future__ import annotations

import json
import logging
import socket
import threading

from ..replication import protocol as P

log = logging.getLogger(__name__)

MSG_MGMT = 0x30


class DataInstanceManagementServer:
    def __init__(self, interpreter_context, host="127.0.0.1", port=12000,
                 node_name: str | None = None):
        self.ictx = interpreter_context
        self.host = host
        self.port = port
        # logical node name for the nemesis network model; threaded into
        # the lazily created ReplicationState
        self.node_name = node_name
        self._sock: socket.socket | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(4)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def _replication(self):
        from ..replication.main_role import ReplicationState
        if getattr(self.ictx, "replication", None) is None:
            self.ictx.replication = ReplicationState(
                self.ictx.storage, ictx=self.ictx,
                node_name=self.node_name)
        return self.ictx.replication

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn) -> None:
        try:
            from ..utils.tls import wrap_cluster_server
            conn = wrap_cluster_server(conn)
            while not self._stop.is_set():
                msg_type, payload = P.recv_frame(conn)
                if msg_type != MSG_MGMT:
                    break
                req = json.loads(payload.decode("utf-8"))
                resp = self._handle(req)
                P.send_frame(conn, MSG_MGMT,
                             json.dumps(resp).encode("utf-8"))
        except (ConnectionError, OSError, json.JSONDecodeError):
            pass
        finally:
            conn.close()

    def _handle(self, req: dict) -> dict:
        kind = req.get("kind")
        replication = self._replication()
        if kind == "state_check":
            # role/epoch/replicas let the coordinator RECONCILE divergent
            # topology (a healed old main, a restarted node) instead of
            # only counting health misses
            epoch, fenced = replication.fencing_info()
            return {"ok": True, "role": replication.role,
                    "fencing_epoch": epoch,
                    "fenced": fenced,
                    "replicas": replication.replica_names(),
                    "last_commit_ts": self.ictx.storage.latest_commit_ts()}
        if kind == "promote":
            # become MAIN (fencing epoch minted through Raft) and adopt
            # the given replicas
            from ..exceptions import FencedException
            from ..replication.main_role import ReplicationMode
            try:
                replication.set_role_main(epoch=req.get("epoch"))
            except FencedException as e:
                return {"ok": False, "fenced": True, "errors": [str(e)]}
            if req.get("no_strict_degradation"):
                replication.allow_strict_degradation = False
            errors = []
            for rep in req.get("replicas", []):
                try:
                    replication.register_replica(
                        rep["name"], rep["address"],
                        ReplicationMode[rep.get("mode", "SYNC")])
                except Exception as e:
                    errors.append(f"{rep['name']}: {e}")
            return {"ok": not errors, "errors": errors,
                    "fencing_epoch": replication.current_epoch()}
        if kind == "demote":
            port = req.get("replication_port", 10000)
            try:
                replication.set_role_replica("0.0.0.0", port,
                                             epoch=req.get("epoch"))
            except Exception as e:
                return {"ok": False, "errors": [str(e)]}
            return {"ok": True,
                    "fencing_epoch": replication.current_epoch()}
        if kind == "metrics":
            # scrape federation (mgstat): the coordinator pulls
            # every instance's exposition through the mgmt channel and
            # serves one labeled payload. When a resident kernel daemon
            # is reachable its health counters ride along as a separate
            # exposition, so the accelerator plane appears as its own
            # federated instance.
            from ..utils.metrics import global_metrics
            resp = {"ok": True, "role": replication.role,
                    "text": global_metrics.prometheus_text()}
            daemon = self._kernel_daemon_exposition()
            if daemon:
                resp["daemon_text"] = daemon
            return resp
        return {"ok": False, "errors": [f"unknown request {kind}"]}

    def _kernel_daemon_exposition(self) -> str | None:
        """The local kernel daemon's counters as an exposition, or None
        when no daemon socket is configured/answering."""
        sock = (getattr(self.ictx, "config", {}) or {}).get(
            "kernel_server_socket")
        if not sock:
            return None
        from ..observability import stats as mgstats
        from ..server.kernel_server import SupervisedKernelClient
        client = SupervisedKernelClient(sock, spawn=False)
        try:
            health = client.health(timeout=1.0)
        finally:
            client.close()
        if health is None:
            return None
        return mgstats.counters_exposition(
            health.get("counters"),
            {"kernel_server.daemon.in_flight":
                 float(health.get("in_flight", 0)),
             "kernel_server.daemon.wedged":
                 1.0 if health.get("wedged") else 0.0,
             "kernel_server.daemon.uptime_s":
                 float(health.get("uptime_s", 0.0))})


def mgmt_call(address: str, request: dict, timeout: float = 2.0,
              src: str | None = None, dst: str | None = None
              ) -> dict | None:
    """One management RPC. ``src``/``dst`` are logical node names for
    the nemesis network model (the coordinator passes its raft id and
    the instance name, so chaos tests can partition exactly the
    coordinator↔instance link)."""
    from ..utils import faultinject as FI
    try:
        if FI.fire("mgmt.rpc") == "drop":
            return None  # RPC lost on the wire
    except FI.FaultInjected:
        return None      # injected fault == unreachable instance
    if FI.net_fire(src, dst) == "drop":
        return None      # request direction partitioned
    host, _, port = address.rpartition(":")
    try:
        from ..utils.tls import wrap_cluster_client
        with socket.create_connection((host, int(port)),
                                      timeout=timeout) as raw:
            with wrap_cluster_client(raw, server_hostname=host) as sock:
                P.send_frame(sock, MSG_MGMT,
                             json.dumps(request).encode("utf-8"))
                msg_type, payload = P.recv_frame(sock)
                if msg_type != MSG_MGMT:
                    return None
                response = json.loads(payload.decode("utf-8"))
    except (ConnectionError, OSError, ValueError,
            json.JSONDecodeError):
        return None
    if FI.net_fire(dst, src) == "drop":
        return None      # asymmetric link: executed, but the ack is lost
    return response
