"""Coordinator instance: Raft-replicated cluster state + failover.

Counterpart of the reference's CoordinatorInstance
(memgraph/src/coordination/coordinator_instance.cpp): the Raft
leader health-checks every data instance (StateCheck RPC analog, :478-502);
after `FAILOVER_MISS_THRESHOLD` consecutive misses of the MAIN it runs
TryFailover (:542-585): pick the most up-to-date alive replica, commit the
new topology through Raft, then promote/demote the data instances.

Fencing: every committed ``set_main`` mints a monotonically increasing
**fencing epoch** inside the replicated state machine (all coordinators
agree on it by construction). Promote/demote RPCs carry the epoch, data
instances attach it to their state, and replicas refuse registration from
a lower epoch — so a deposed MAIN that was partitioned away from the
coordinator can never feed replicas (or keep collecting strict votes)
after its successor exists. The health loop additionally RECONCILES
divergent topology: a healed stale main is demoted, a restarted current
main gets its replica set re-registered — both idempotent and safe to
re-run, which is what makes failover itself retryable.

Copy of memgraph_tpu/coordination/coordinator.py for the port, on the
port's Raft, management RPCs and ``utils.metrics``; the federation
reads the port's ``observability/stats.py``.  ``rng=`` passes the Raft
node its election ``random.Random``.
"""

from __future__ import annotations

import logging
import threading
import time

from ..utils.metrics import global_metrics
from ..utils.locks import tracked_lock
from ..utils.retry import RetryPolicy
from .data_instance import mgmt_call
from .raft import RaftNode

log = logging.getLogger(__name__)


class CoordinatorInstance:
    HEALTH_CHECK_INTERVAL = 0.5
    FAILOVER_MISS_THRESHOLD = 3

    def __init__(self, node_id: str, host: str, raft_port: int,
                 peers: dict[str, tuple[str, int]], kvstore=None,
                 routers: list[str] | None = None,
                 repl_mode: str = "SYNC",
                 election_seed: int | None = None,
                 rng=None):
        # bolt addresses of ALL coordinators (config-derived), served in
        # the ROUTE role so drivers survive losing their bootstrap router
        self.routers = list(routers or [])
        # replication mode used when (re)wiring data instances. The
        # split-brain-proof profile is STRICT_SYNC: commits wait for
        # every replica's 2PC vote and degradation is disabled, so an
        # isolated MAIN can never ack a write its successor won't have.
        self.repl_mode = repl_mode
        # replicated cluster state: name -> instance descriptor
        # (initialized BEFORE RaftNode: restoring a persisted snapshot
        # calls _restore during RaftNode.__init__)
        self.instances: dict[str, dict] = {}
        self.main_name: str | None = None
        self.epoch = 0        # fencing epoch; bumped by every set_main
        # shard placement (mgshard): shard_id -> owner endpoint.
        # Reassignment mints the SAME fencing epoch inside the
        # replicated apply, so a stale shard map can never route an
        # acked write — one epoch chain fences MAIN role AND shard
        # ownership.
        self.shard_map: dict[int, str] = {}
        self._lock = tracked_lock("Coordinator._lock")
        self.raft = RaftNode(node_id, host, raft_port, peers,
                             apply_fn=self._apply, kvstore=kvstore,
                             snapshot_fn=self._snapshot,
                             restore_fn=self._restore,
                             election_seed=election_seed, rng=rng)
        # failover raft-commit retries: transient outcomes (timeout /
        # lost quorum mid-commit) back off and re-propose; set_main is
        # idempotent so an ambiguous timeout is safe to retry
        self.failover_retry = RetryPolicy(base_delay=0.1, max_delay=1.0,
                                          max_retries=3)
        self._miss_counts: dict[str, int] = {}
        self._stop = threading.Event()
        self._health_thread: threading.Thread | None = None

    # --- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self.raft.start()
        self._health_thread = threading.Thread(target=self._health_loop,
                                               daemon=True)
        self._health_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.raft.stop()

    # --- replicated state machine -------------------------------------------

    def _apply(self, command: dict) -> None:
        """Applied on EVERY coordinator for each committed Raft entry."""
        op = command.get("op")
        with self._lock:
            if op == "register_instance":
                self.instances[command["name"]] = {
                    "name": command["name"],
                    "mgmt_address": command["mgmt_address"],
                    "replication_address": command["replication_address"],
                    "bolt_address": command.get("bolt_address"),
                    "role": "replica",
                }
            elif op == "unregister_instance":
                self.instances.pop(command["name"], None)
                if self.main_name == command["name"]:
                    self.main_name = None
            elif op == "set_main":
                name = command["name"]
                # mint the fencing epoch HERE, inside the replicated
                # apply: every coordinator derives the identical,
                # strictly monotonic value from the log order alone
                self.epoch += 1
                for inst in self.instances.values():
                    inst["role"] = "replica"
                if name in self.instances:
                    self.instances[name]["role"] = "main"
                    self.main_name = name
                global_metrics.set_gauge("coordination.current_epoch",
                                         float(self.epoch))
            elif op == "set_shard_owner":
                # minted HERE, inside the replicated apply: every
                # coordinator derives the identical (epoch, owner) pair
                # from log order alone — the shard-ownership fencing
                # proof rides the same chain as set_main
                self.epoch += 1
                self.shard_map[int(command["shard"])] = command["owner"]
                global_metrics.set_gauge("coordination.current_epoch",
                                         float(self.epoch))

    def _snapshot(self) -> dict:
        """State-machine snapshot for Raft log compaction."""
        with self._lock:
            return {"instances": {k: dict(v)
                                  for k, v in self.instances.items()},
                    "main_name": self.main_name,
                    "epoch": self.epoch,
                    "shard_map": {str(k): v
                                  for k, v in self.shard_map.items()}}

    def _restore(self, state: dict) -> None:
        """Replace the state machine from a Raft snapshot (restart replay
        or leader install-snapshot for a lagging coordinator)."""
        with self._lock:
            self.instances = {k: dict(v)
                              for k, v in state.get("instances",
                                                    {}).items()}
            self.main_name = state.get("main_name")
            self.epoch = int(state.get("epoch") or 0)
            self.shard_map = {int(k): v
                              for k, v in (state.get("shard_map")
                                           or {}).items()}

    # --- client operations (leader only) ------------------------------------

    def register_instance(self, name: str, mgmt_address: str,
                          replication_address: str,
                          bolt_address: str | None = None) -> bool:
        return bool(self.raft.propose({
            "op": "register_instance", "name": name,
            "mgmt_address": mgmt_address,
            "replication_address": replication_address,
            "bolt_address": bolt_address}))

    def route_table(self) -> dict:
        """Bolt ROUTE table from LIVE replicated cluster state (reference:
        coordinator_instance.cpp routing): MAIN serves writes, replicas
        serve reads; this coordinator serves further ROUTE requests. The
        fencing epoch rides along so clients can reject acks from a main
        this table already superseded."""
        with self._lock:
            writers = [i["bolt_address"] for i in self.instances.values()
                       if i["role"] == "main" and i.get("bolt_address")]
            readers = [i["bolt_address"] for i in self.instances.values()
                       if i["role"] == "replica" and i.get("bolt_address")]
            epoch = self.epoch
            shards = {str(k): v for k, v in self.shard_map.items()}
        table = {"writers": writers, "readers": readers or writers,
                 "epoch": epoch}
        if shards:
            # shard topology rides the same ROUTE payload (and the same
            # epoch) so shard-aware clients refresh both in one fetch
            table["shards"] = shards
        return table

    def assign_shard(self, shard_id: int, owner: str) -> bool:
        """Commit a shard-ownership change through Raft; the fencing
        epoch for the new owner is minted inside the apply."""
        return bool(self.raft.propose({"op": "set_shard_owner",
                                       "shard": int(shard_id),
                                       "owner": owner}))

    def shard_map_view(self) -> dict:
        """The epoch-versioned shard map from replicated state."""
        with self._lock:
            return {"epoch": self.epoch,
                    "owners": dict(self.shard_map)}

    def unregister_instance(self, name: str) -> bool:
        return bool(self.raft.propose({"op": "unregister_instance",
                                       "name": name}))

    def set_instance_to_main(self, name: str) -> bool:
        """Explicit promotion: commit through Raft, then reconfigure."""
        with self._lock:
            if name not in self.instances:
                return False
        if not self.raft.propose({"op": "set_main", "name": name}):
            return False
        self._reconfigure_data_instances(name)
        return True

    def federated_prometheus_text(self) -> str:
        """One labeled exposition for the whole cluster (mgstat).

        Scrapes every registered data instance's metrics through the
        mgmt channel (main + replicas), plus this coordinator's own
        registry; instances exposing a resident kernel daemon contribute
        it as a separate ``<name>-kernel-daemon`` series. Unreachable
        instances are simply absent — the scrape must degrade, not
        fail, under partitions."""
        from ..observability import stats as mgstats
        global_metrics.increment("coordination.federation_scrapes_total")
        parts: dict[str, str] = {
            self.raft.node_id: global_metrics.prometheus_text()}
        with self._lock:
            instances = [dict(i) for i in self.instances.values()]
        for inst in instances:
            resp = mgmt_call(inst["mgmt_address"], {"kind": "metrics"},
                             timeout=2.0, src=self.raft.node_id,
                             dst=inst["name"])
            if resp is None or not resp.get("ok"):
                continue
            parts[inst["name"]] = resp.get("text", "")
            daemon = resp.get("daemon_text")
            if daemon:
                parts[f"{inst['name']}-kernel-daemon"] = daemon
        return mgstats.federate_expositions(parts)

    def show_instances(self) -> list[list]:
        with self._lock:
            instances = [dict(i) for i in self.instances.values()]
        rows = []
        is_leader = self.raft.is_leader()
        for inst in sorted(instances, key=lambda i: i["name"]):
            health = "unknown"
            if is_leader:
                misses = self._miss_counts.get(inst["name"], 0)
                health = "up" if misses == 0 else (
                    "down" if misses >= self.FAILOVER_MISS_THRESHOLD
                    else "degraded")
            rows.append([inst["name"], inst["mgmt_address"],
                         inst["role"], health])
        rows.append([self.raft.node_id, f"raft:{self.raft.port}",
                     "leader" if is_leader else "coordinator", "up"])
        return rows

    # --- health checks + failover (leader) ----------------------------------

    def _health_loop(self) -> None:
        while not self._stop.wait(self.HEALTH_CHECK_INTERVAL):
            if not self.raft.is_leader():
                continue
            with self._lock:
                instances = [dict(i) for i in self.instances.values()]
                main_name = self.main_name
                epoch = self.epoch
            states: dict[str, dict | None] = {}
            for inst in instances:
                resp = mgmt_call(inst["mgmt_address"],
                                 {"kind": "state_check"}, timeout=1.0,
                                 src=self.raft.node_id, dst=inst["name"])
                name = inst["name"]
                states[name] = resp
                if resp is None or not resp.get("ok"):
                    self._miss_counts[name] = \
                        self._miss_counts.get(name, 0) + 1
                else:
                    self._miss_counts[name] = 0
            if main_name is not None and \
                    self._miss_counts.get(main_name, 0) >= \
                    self.FAILOVER_MISS_THRESHOLD:
                self._try_failover(main_name)
                continue
            self._reconcile(instances, main_name, epoch, states)

    def _reconcile(self, instances: list[dict], main_name: str | None,
                   epoch: int, states: dict) -> None:
        """Idempotent topology repair, run every healthy round: a healed
        deposed MAIN is demoted (with the current fencing epoch), and a
        current MAIN whose replica registry diverged from the replicated
        state (restart, promote that half-failed, replica that just
        returned) gets exactly the missing replicas re-registered. Safe
        to re-run — which is what makes failover interruption-tolerant."""
        if main_name is None:
            return
        main_state = states.get(main_name)
        for inst in instances:
            name = inst["name"]
            resp = states.get(name)
            if name == main_name or resp is None or not resp.get("ok"):
                continue
            if resp.get("role") == "main":
                # a deposed main returned from its partition: fence it
                port = int(inst["replication_address"].rpartition(":")[2])
                log.warning("reconcile: demoting stale main %s "
                            "(fencing epoch %d)", name, epoch)
                mgmt_call(inst["mgmt_address"],
                          {"kind": "demote", "replication_port": port,
                           "epoch": epoch},
                          timeout=2.0, src=self.raft.node_id, dst=name)
        if main_state is None or not main_state.get("ok"):
            return
        expected = sorted(i["name"] for i in instances
                          if i["name"] != main_name)
        reported = sorted(main_state.get("replicas", []))
        if main_state.get("role") == "main" and reported == expected \
                and not main_state.get("fenced"):
            return
        missing = [n for n in expected if n not in reported]
        # only re-register replicas that are alive AND already demoted;
        # the stale-main branch above demotes first, next round registers
        ready = []
        for inst in instances:
            name = inst["name"]
            resp = states.get(name)
            if name == main_name or name not in missing:
                continue
            if resp is None or not resp.get("ok") or \
                    resp.get("role") != "replica":
                continue
            ready.append({"name": name,
                          "address": inst["replication_address"],
                          "mode": self.repl_mode})
        if not ready and main_state.get("role") == "main" and \
                not main_state.get("fenced"):
            return
        log.warning("reconcile: refreshing main %s (role=%s, missing "
                    "replicas %s, epoch %d)", main_name,
                    main_state.get("role"), missing, epoch)
        main_inst = next(i for i in instances if i["name"] == main_name)
        mgmt_call(main_inst["mgmt_address"],
                  {"kind": "promote", "replicas": ready, "epoch": epoch,
                   "no_strict_degradation":
                       self.repl_mode == "STRICT_SYNC"},
                  timeout=10.0, src=self.raft.node_id, dst=main_name)

    def _try_failover(self, failed_main: str) -> None:
        """Choose the most up-to-date alive replica and promote it.

        Raft-commit retries ride the shared RetryPolicy; the whole
        procedure is idempotent (reconciliation repairs a crash between
        the commit and the promote RPCs), so every exit path is safe."""
        global_metrics.increment("coordination.failover_attempts")
        with self._lock:
            candidates = [dict(i) for i in self.instances.values()
                          if i["name"] != failed_main]
        best_name, best_ts = None, -1
        for inst in candidates:
            resp = mgmt_call(inst["mgmt_address"], {"kind": "state_check"},
                             timeout=1.0, src=self.raft.node_id,
                             dst=inst["name"])
            if resp is None or not resp.get("ok"):
                continue
            ts = resp.get("last_commit_ts", 0)
            if ts > best_ts:
                best_name, best_ts = inst["name"], ts
        if best_name is None:
            log.error("failover: no alive replica to promote")
            return
        log.warning("failover: promoting %s (last_commit_ts=%d) to MAIN",
                    best_name, best_ts)
        committed = False
        for attempt in range(self.failover_retry.max_retries + 1):
            result = self.raft.propose({"op": "set_main",
                                        "name": best_name})
            if result:
                committed = True
                break
            if not result.retryable:
                # not_leader/lost_leadership: the NEW raft leader owns
                # this failover now — do not fight it
                log.error("failover: raft commit failed (%s); yielding "
                          "to the current leader", result.outcome)
                return
            log.warning("failover: raft commit %s (attempt %d); "
                        "retrying with backoff", result.outcome, attempt)
            time.sleep(self.failover_retry.delay_for(attempt))
        if not committed:
            log.error("failover: raft commit retries exhausted")
            return
        with self._lock:
            epoch = self.epoch
        global_metrics.increment("coordination.failovers_total")
        global_metrics.set_gauge("coordination.current_epoch",
                                 float(epoch))
        log.warning("failover: %s is MAIN at fencing epoch %d",
                    best_name, epoch)
        self._reconfigure_data_instances(best_name)

    def _reconfigure_data_instances(self, new_main: str) -> None:
        with self._lock:
            instances = [dict(i) for i in self.instances.values()]
            epoch = self.epoch
        replicas = []
        for inst in instances:
            if inst["name"] == new_main:
                continue
            # demote (best effort — the failed MAIN may be unreachable;
            # reconciliation fences it with this epoch when it returns)
            port = int(inst["replication_address"].rpartition(":")[2])
            mgmt_call(inst["mgmt_address"],
                      {"kind": "demote", "replication_port": port,
                       "epoch": epoch},
                      timeout=2.0, src=self.raft.node_id,
                      dst=inst["name"])
            replicas.append({"name": inst["name"],
                             "address": inst["replication_address"],
                             "mode": self.repl_mode})
        resp = mgmt_call(
            next(i["mgmt_address"] for i in instances
                 if i["name"] == new_main),
            {"kind": "promote", "replicas": replicas, "epoch": epoch,
             "no_strict_degradation": self.repl_mode == "STRICT_SYNC"},
            timeout=10.0, src=self.raft.node_id, dst=new_main)
        if resp is None or not resp.get("ok"):
            log.error("failover: promote of %s reported %s (reconcile "
                      "will retry)", new_main, resp)
