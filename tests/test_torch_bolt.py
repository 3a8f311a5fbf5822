"""The port's Bolt entry point (memgraph_tpu_torch/server: packstream, bolt,
client) against the JAX package's on the CPU.

- PackStream: the golden fixtures of ``tests/test_bolt_golden.py``
  (imported, not edited) through the port's ``packstream``; random values
  from a numpy seed and hypothesis cases pack to the same bytes in both
  packages; the graph, temporal and spatial structures of
  ``value_to_bolt`` give the same bytes in both (4.4 and 5.2).
- One scripted Bolt conversation per protocol version runs against the
  JAX ``BoltServer`` and the port's (``device="cpu"``) over raw sockets:
  HELLO / LOGON, RUN / PULL n, DISCARD, BEGIN / COMMIT / ROLLBACK, RESET
  after a failure, ROUTE; every reply (records, summaries, failure codes
  and messages) is compared.  A server with users defined refuses and
  admits the same logins in both.
- The port's client drives the JAX server, and the JAX client the
  port's server; the port's ``RoutedClient`` writes through the port's
  server.
- ``CALL`` over Bolt on a small generated graph: the rows reach the wire
  as Python values, and match the JAX server's within the tolerances of
  ``tests/test_torch_cypher_procedures.py`` (PageRank rtol 1e-5, atol
  1e-9; components and degrees exact).

Every socket, thread join and subprocess has a timeout of its own.
"""

import contextlib
import socket
import struct
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from memgraph_tpu.auth.auth import Auth as JAuth
from memgraph_tpu.query import interpreter as jinterp
from memgraph_tpu.server import bolt as jbolt
from memgraph_tpu.server import client as jclient
from memgraph_tpu.server import packstream as jps
from memgraph_tpu.storage import InMemoryStorage as JStorage
from memgraph_tpu_torch.auth.auth import Auth as TAuth
from memgraph_tpu_torch.query import interpreter as tinterp
from memgraph_tpu_torch.server import bolt as tbolt
from memgraph_tpu_torch.server import client as tclient
from memgraph_tpu_torch.server import packstream as tps
from memgraph_tpu_torch.storage import InMemoryStorage as TStorage
from test_bolt_golden import PRIMITIVES, b

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

TIMEOUT = 30.0      # every socket
JOIN = 10.0         # every server thread


def jax_ctx():
    ictx = jinterp.InterpreterContext(JStorage())
    ictx.auth_store = JAuth()
    return ictx


def port_ctx():
    ictx = tinterp.InterpreterContext(TStorage(), device="cpu")
    ictx.auth_store = TAuth()
    return ictx


@contextlib.contextmanager
def serving(bolt, ictx, **kw):
    """A ``BoltServer`` of the given package on 127.0.0.1, port 0: yields
    its port; stops it and joins its thread on exit."""
    srv = bolt.BoltServer(ictx, "127.0.0.1", 0, ictx.auth_store, **kw)
    thread, loop = srv.run_in_thread()
    try:
        yield srv._server.sockets[0].getsockname()[1]
    finally:
        # let closed sessions finish on the loop before it stops
        deadline = time.monotonic() + JOIN
        while srv._live_sessions and time.monotonic() < deadline:
            time.sleep(0.01)
        srv.stop()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(JOIN)
        assert not thread.is_alive(), "the server thread did not stop"


@pytest.fixture(scope="module")
def servers():
    """A JAX server and a port server, each on a fresh storage with an
    auth store of its own (no users: both run open)."""
    with serving(jbolt, jax_ctx()) as jp, serving(tbolt, port_ctx()) as tp:
        yield {"jax": jp, "port": tp}


# --------------------------------------------------------------------------
# PackStream
# --------------------------------------------------------------------------

@pytest.mark.parametrize("value,hexbytes", PRIMITIVES,
                         ids=[repr(v)[:24] for v, _ in PRIMITIVES])
def test_golden_encode(value, hexbytes):
    assert tps.pack(value) == b(hexbytes)


@pytest.mark.parametrize("value,hexbytes", PRIMITIVES,
                         ids=[repr(v)[:24] for v, _ in PRIMITIVES])
def test_golden_decode(value, hexbytes):
    decoded = tps.unpack(b(hexbytes))
    assert decoded == value
    assert type(decoded) is type(value)


def test_map_key_order_is_preserved():
    assert tps.pack({"b": 1, "a": 2}) == b("a2 81 62 01 81 61 02")


def random_value(rng, depth=0):
    """A PackStream value drawn from ``rng``: scalars at every size
    boundary, strings and bytes past 15 / 255 / 65535, nested lists,
    maps and structures."""
    kind = rng.integers(0, 10 if depth < 3 else 6)
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:
        bits = int(rng.choice([4, 7, 8, 15, 16, 31, 32, 63]))
        return int(rng.integers(-(1 << bits), 1 << bits))
    if kind == 3:
        return float(rng.standard_normal() * 10.0 ** rng.integers(-300, 300))
    if kind == 4:
        n = int(rng.choice([0, 3, 15, 16, 255, 256, 70_000]))
        return "".join(map(chr, rng.integers(32, 0x3000, n).tolist()))
    if kind == 5:
        n = int(rng.choice([0, 1, 255, 256, 70_000]))
        return rng.integers(0, 256, n).astype(np.uint8).tobytes()
    n = int(rng.choice([0, 1, 15, 16, 300]))
    n = min(n, 20) if depth else n
    if kind in (6, 7):
        return [random_value(rng, depth + 1) for _ in range(n)]
    if kind == 8:
        return {f"k{i}": random_value(rng, depth + 1) for i in range(n)}
    return tps.Structure(int(rng.integers(0, 128)),
                         [random_value(rng, depth + 1)
                          for _ in range(min(n, 15))])


def as_jax(v):
    """The same value with the JAX package's ``Structure``."""
    if isinstance(v, tps.Structure):
        return jps.Structure(v.tag, [as_jax(x) for x in v.fields])
    if isinstance(v, list):
        return [as_jax(x) for x in v]
    if isinstance(v, dict):
        return {k: as_jax(x) for k, x in v.items()}
    return v


@pytest.mark.parametrize("seed", range(24))
def test_random_values_pack_to_the_same_bytes(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        v = random_value(rng)
        got = tps.pack(v)
        assert got == jps.pack(as_jax(v))
        assert tps.unpack(got) == v


values = st.recursive(
    st.none() | st.booleans() | st.integers(-(1 << 63), (1 << 63) - 1)
    | st.floats(allow_nan=False) | st.text() | st.binary(),
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=8), inner, max_size=20)
    | st.builds(lambda tag, fields: tps.Structure(tag, fields),
                st.integers(0, 127), st.lists(inner, max_size=15)),
    max_leaves=40)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(values)
def test_hypothesis_values_pack_to_the_same_bytes(v):
    got = tps.pack(v)
    assert got == jps.pack(as_jax(v))
    assert tps.unpack(got) == v


def graph(storage):
    """(:Person {name: 'Ann'})-[:KNOWS {since: 2020}]->(:City), as
    ``tests/test_bolt_golden.py`` builds it."""
    acc = storage.access()
    a = acc.create_vertex()
    a.add_label(storage.label_mapper.name_to_id("Person"))
    a.set_property(storage.property_mapper.name_to_id("name"), "Ann")
    c = acc.create_vertex()
    c.add_label(storage.label_mapper.name_to_id("City"))
    e = acc.create_edge(a, c, storage.edge_type_mapper.name_to_id("KNOWS"))
    e.set_property(storage.property_mapper.name_to_id("since"), 2020)
    acc.commit()
    return storage, a, c, e


@pytest.mark.parametrize("version", [(5, 2), (4, 4)])
def test_graph_structures_give_the_same_bytes(version):
    from memgraph_tpu.query.values import Path as JPath
    from memgraph_tpu.storage.common import View as JView
    from memgraph_tpu_torch.query.values import Path as TPath
    from memgraph_tpu_torch.storage.common import View as TView
    js, ja, jc, je = graph(JStorage())
    ts, ta, tc, te = graph(TStorage())
    for jv, tv in ((ja, ta), (je, te), (JPath([ja, je, jc]),
                                        TPath([ta, te, tc]))):
        want = jps.pack(jbolt.value_to_bolt(jv, js, JView.OLD, version))
        got = tps.pack(tbolt.value_to_bolt(tv, ts, TView.OLD, version))
        assert got == want


TEMPORALS = [("Date", "2020-01-01"), ("LocalTime", "12:34:56.789"),
             ("LocalDateTime", "2020-01-01T12:34:56"),
             ("ZonedDateTime", "2020-01-01T12:34:56+02:00"),
             ("Duration", "P1DT2.000003S")]


@pytest.mark.parametrize("version", [(5, 2), (4, 4)])
@pytest.mark.parametrize("kind,text", TEMPORALS,
                         ids=[k for k, _ in TEMPORALS])
def test_temporal_structures_give_the_same_bytes(kind, text, version):
    from memgraph_tpu.utils import temporal as jt
    from memgraph_tpu_torch.utils import temporal as tt
    want = jps.pack(jbolt.value_to_bolt(getattr(jt, kind).parse(text),
                                        None, None, version))
    got = tps.pack(tbolt.value_to_bolt(getattr(tt, kind).parse(text),
                                       None, None, version))
    assert got == want
    # and back: the parameter decoders agree on the structure
    back_j = jbolt.bolt_to_value(jps.unpack(want))
    back_t = tbolt.bolt_to_value(tps.unpack(got))
    assert type(back_t).__name__ == type(back_j).__name__
    assert str(back_t) == str(back_j)


def test_point_structures_give_the_same_bytes():
    from memgraph_tpu.utils.point import CrsType as JCrs, Point as JPoint
    from memgraph_tpu_torch.utils.point import CrsType as TCrs, Point as TPoint
    for args in ((1.5, 2.25, None, "WGS84_2D"), (1.0, 2.0, 3.0, "CARTESIAN_3D")):
        want = jps.pack(jbolt.value_to_bolt(
            JPoint(*args[:3], getattr(JCrs, args[3])), None, None))
        got = tps.pack(tbolt.value_to_bolt(
            TPoint(*args[:3], getattr(TCrs, args[3])), None, None))
        assert got == want


@pytest.mark.parametrize("value", [np.float32(1.5), np.int64(3),
                                   np.bool_(True)],
                         ids=["float32", "int64", "bool_"])
def test_a_numpy_scalar_does_not_reach_the_wire(value):
    """Both packages refuse a numpy scalar (``np.float64`` is a Python
    float and passes in both): a procedure's rows must be Python
    values."""
    with pytest.raises(jps.PackStreamError):
        jbolt.value_to_bolt(value, None, None)
    with pytest.raises(tps.PackStreamError):
        tbolt.value_to_bolt(value, None, None)


def test_a_torch_scalar_does_not_reach_the_wire():
    with pytest.raises(tps.PackStreamError):
        tbolt.value_to_bolt(torch.tensor(2.0), None, None)


def test_a_worker_call_runs_under_the_contexts_card(monkeypatch):
    """The session pool's seam: each interpreter call runs with the
    context's CUDA device current (``torch.cuda.device`` entered with
    it), and on the CPU with nothing set."""
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(dev)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)

    class Ctx:
        pass

    card, cpu = Ctx(), Ctx()
    card.device, cpu.device = torch.device("cuda", 0), torch.device("cpu")
    assert tbolt._on_device(card, lambda x: x + 1, 1) == 2
    assert entered == [torch.device("cuda", 0)]
    assert tbolt._on_device(cpu, lambda: 3) == 3
    assert entered == [torch.device("cuda", 0)]


# --------------------------------------------------------------------------
# raw-socket conversations against both servers
# --------------------------------------------------------------------------

class Wire:
    """A Bolt connection by hand: the handshake, then one message at a
    time with every reply up to its summary."""

    def __init__(self, port, version):
        self.sock = socket.create_connection(("127.0.0.1", port), TIMEOUT)
        self.sock.settimeout(TIMEOUT)
        self.sock.sendall(tbolt.BOLT_MAGIC + bytes([0, 0, version[1],
                                                    version[0]])
                          + bytes(12))
        self.version = self._recv(4)

    def _recv(self, n):
        out = b""
        while len(out) < n:
            part = self.sock.recv(n - len(out))
            if not part:
                raise ConnectionError("the server closed the connection")
            out += part
        return out

    def _message(self):
        data = b""
        while True:
            size = struct.unpack(">H", self._recv(2))[0]
            if size == 0:
                if data:
                    return tps.unpack(data)
                continue
            data += self._recv(size)

    def send(self, tag, *fields):
        data = tps.pack(tps.Structure(tag, list(fields)))
        self.sock.sendall(struct.pack(">H", len(data)) + data + b"\x00\x00")
        if tag == tbolt.M_GOODBYE:
            return []
        replies = []
        while True:
            msg = self._message()
            replies.append(msg)
            if msg.tag != tbolt.M_RECORD:
                return replies

    def close(self):
        self.sock.close()


def conversation(version):
    """(tag, fields) messages of one session: every request kind the
    server answers, failures and RESET included."""
    M = tbolt
    hello = {"user_agent": "parity/1"}
    out = []
    if version < (5, 1):
        hello.update({"scheme": "basic", "principal": "", "credentials": ""})
        out.append((M.M_HELLO, hello))
    else:
        out += [(M.M_HELLO, hello),
                (M.M_LOGON, {"scheme": "basic", "principal": "",
                             "credentials": ""})]

    def run(q, params=None):
        return (M.M_RUN, q, params or {}, {})
    out += [
        run("CREATE (a:P {name: 'a', v: 1})-[:R {w: 2.5}]->(b:P {name: 'b'}) "
            "RETURN a, b"), (M.M_PULL, {"n": -1}),
        run("UNWIND range(1, 5) AS i RETURN i, i * 2 AS d"),
        (M.M_PULL, {"n": 2}), (M.M_PULL, {"n": 2}), (M.M_PULL, {"n": -1}),
        run("UNWIND range(1, 10) AS i RETURN i"), (M.M_DISCARD, {"n": -1}),
        (M.M_BEGIN, {}), run("CREATE (:T {x: 1})"), (M.M_PULL, {"n": -1}),
        (M.M_COMMIT,),
        (M.M_BEGIN, {}), run("CREATE (:T {x: 2})"), (M.M_PULL, {"n": -1}),
        (M.M_ROLLBACK,),
        run("MATCH (t:T) RETURN t.x ORDER BY t.x"), (M.M_PULL, {"n": -1}),
        run("RETURN 1 +"), (M.M_PULL, {"n": -1}), (M.M_RESET,),
        run("MATCH p = (:P)-[:R]->(:P) RETURN p, $x AS x",
            {"x": [1, "a", None, 2.5, {"k": True}]}), (M.M_PULL, {"n": -1}),
        run("RETURN date('2020-01-01') AS d, localtime('12:00:01') AS t, "
            "duration('P1DT1S') AS du, point({x: 1.0, y: 2.0}) AS pt, "
            "datetime('2020-01-01T12:34:56+02:00') AS z"),
        (M.M_PULL, {"n": -1}),
        run("RETURN $d AS d, $ld AS ld",
            {"d": tps.Structure(tps.S_DATE, [18262]),
             "ld": tps.Structure(tps.S_LOCAL_DATETIME, [1577882096, 0])}),
        (M.M_PULL, {"n": -1}),
        run("RETURN nope"), (M.M_PULL, {"n": -1}), (M.M_RESET,),
        run("UNWIND [1, 0] AS z RETURN 10 / z"), (M.M_PULL, {"n": -1}),
        (M.M_RESET,),
        (M.M_BEGIN, {}), run("CREATE (:T {x: 3})"), (M.M_PULL, {"n": -1}),
        (M.M_BEGIN, {}), (M.M_RESET,),
        run("MATCH (t:T) RETURN count(t) AS c"), (M.M_PULL, {"n": -1}),
        run("CREATE INDEX ON :P(name)"), (M.M_PULL, {"n": -1}),
        run("MATCH (n:P) SET n.v = coalesce(n.v, 0) + 1 RETURN n.v"),
        (M.M_PULL, {"n": -1}),
        (M.M_ROUTE, {}, [], None),
        (M.M_GOODBYE,),
    ]
    return out


def talk(port, version, script):
    wire = Wire(port, version)
    try:
        return [wire.version] + [wire.send(*msg) for msg in script]
    finally:
        wire.close()


@pytest.mark.parametrize("version", [(5, 2), (5, 0), (4, 4)],
                         ids=["5.2", "5.0", "4.4"])
def test_a_scripted_conversation_gets_the_same_replies(version):
    script = conversation(version)
    with serving(jbolt, jax_ctx()) as jp, serving(tbolt, port_ctx()) as tp:
        want = talk(jp, version, script)
        got = talk(tp, version, script)
    assert got == want
    codes = {r[-1].fields[0]["code"] for r in want[1:]
             if r and r[-1].tag == tbolt.M_FAILURE}
    assert codes == {"Memgraph.ClientError.Statement.SyntaxError",
                     "Memgraph.ClientError.Statement.SemanticError",
                     "Memgraph.ClientError.Transaction.Invalid",
                     "Memgraph.TransientError.General.Error"}
    assert any(r and r[-1].tag == tbolt.M_IGNORED for r in want[1:])


def test_logins_are_refused_and_admitted_alike():
    """A server with users: a wrong password and an unknown user fail
    with the same Security code; a right one is admitted; a request
    before any login fails alike."""
    def with_users(ictx):
        ictx.auth_store.create_user("admin", "pw")
        ictx.auth_store.create_user("reader", "rpw")
        ictx.auth_store.grant("reader", ["MATCH"])
        return ictx

    M = tbolt
    logons = [("admin", "nope"), ("ghost", "pw"), ("admin", "pw"),
              ("reader", "rpw")]
    scripts = [[(M.M_HELLO, {"user_agent": "parity/1"}),
                (M.M_LOGON, {"scheme": "basic", "principal": u,
                             "credentials": p}),
                (M.M_RUN, "CREATE (:X)", {}, {}), (M.M_PULL, {"n": -1}),
                (M.M_RESET,),
                (M.M_RUN, "MATCH (n) RETURN count(n)", {}, {}),
                (M.M_PULL, {"n": -1})] for u, p in logons]
    scripts.append([(M.M_HELLO, {"user_agent": "parity/1"}),
                    (M.M_RUN, "RETURN 1", {}, {})])
    with serving(jbolt, with_users(jax_ctx())) as jp, \
            serving(tbolt, with_users(port_ctx())) as tp:
        for script in scripts:
            want = talk(jp, (5, 2), script)
            got = talk(tp, (5, 2), script)
            assert got == want
    codes = [r[-1].fields[0]["code"] for r in want[1:]
             if r and r[-1].tag == M.M_FAILURE]
    assert codes == ["Memgraph.ClientError.Security.Unauthenticated"]


# --------------------------------------------------------------------------
# each package's client against the other's server
# --------------------------------------------------------------------------

def client_session(client):
    """(columns, rows, summary) of a few statements through a client."""
    out = [client.execute("RETURN 1 + 1 AS two, 'x' AS s, [1, 2.5] AS l")]
    client.execute("CREATE (:C {k: 1})-[:E {w: 0.5}]->(:C {k: 2})")
    out.append(client.execute("MATCH (a:C)-[e:E]->(b:C) "
                              "RETURN a.k, e.w, b.k, e, a"))
    client.begin()
    client.execute("CREATE (:C {k: 3})")
    client.rollback()
    client.begin()
    client.execute("CREATE (:C {k: 4})")
    client.commit()
    out.append(client.execute("MATCH (c:C) RETURN c.k ORDER BY c.k"))
    out.append(client.execute("UNWIND range(1, 2500) AS i RETURN i"))
    out.append(client.route())
    return out


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_a_client_drives_the_other_packages_server(client_pkg, server_pkg):
    """The same session through the server's own client and through the
    other package's, each on a fresh server: the same answers."""
    clients = {"jax": jclient, "port": tclient}
    bolts = {"jax": (jbolt, jax_ctx), "port": (tbolt, port_ctx)}
    outs = []
    for pkg in (server_pkg, client_pkg):
        bolt, ctx = bolts[server_pkg]
        with serving(bolt, ctx()) as port:
            c = clients[pkg].BoltClient(port=port, timeout=TIMEOUT)
            try:
                outs.append(client_session(c))
                with pytest.raises(clients[pkg].BoltClientError) as e:
                    c.execute("RETURN 1 +")
                outs.append(e.value.code)
                c.reset()
                outs.append(c.execute("RETURN 2 AS after_reset"))
            finally:
                c.close()
    assert _same(outs[:3], outs[3:])
    assert outs[1] == "Memgraph.ClientError.Statement.SyntaxError"


def _same(a, b_):
    """Equal up to the package of the ``Structure`` class."""
    if hasattr(a, "tag") and hasattr(b_, "tag"):
        return a.tag == b_.tag and _same(a.fields, b_.fields)
    if isinstance(a, (list, tuple)) and isinstance(b_, (list, tuple)):
        return len(a) == len(b_) and all(map(_same, a, b_))
    if isinstance(a, dict) and isinstance(b_, dict):
        return a.keys() == b_.keys() and all(_same(a[k], b_[k]) for k in a)
    return a == b_


def test_routed_client_writes_through_the_port_server():
    """The single-instance routing table names the advertised address,
    and the routed client writes there."""
    ictx = port_ctx()
    with serving(tbolt, ictx) as port:
        ictx.config["advertised_address"] = f"127.0.0.1:{port}"
        rc = tclient.RoutedClient([f"127.0.0.1:{port}"], timeout=TIMEOUT)
        try:
            rc.execute_write("CREATE (:Routed {v: 7})")
            _, rows, _ = rc.execute_write("MATCH (n:Routed) RETURN n.v")
            assert rows == [[7]]
            assert rc.known_epoch == 0
        finally:
            rc.close()


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_bolt_over_tls(tmp_path, client_pkg):
    """bolt+s: the port's server with the port's self-signed pair answers
    an encrypted client of either package, and refuses a plaintext one."""
    from memgraph_tpu_torch.utils import tls
    cert, key = tls.generate_self_signed(str(tmp_path))
    client = {"jax": jclient, "port": tclient}[client_pkg]
    with serving(tbolt, port_ctx(),
                 ssl_context=tls.server_context(cert, key)) as port:
        with pytest.raises((OSError, client.MemgraphTpuError)):
            client.BoltClient(port=port, timeout=5).execute("RETURN 1")
        c = client.BoltClient(port=port, encrypted=True, ca_file=cert,
                              timeout=TIMEOUT)
        try:
            assert c.execute("RETURN 40 + 2 AS x")[1] == [[42]]
        finally:
            c.close()


def test_max_sessions_cap_refuses_with_a_bolt_failure():
    from memgraph_tpu_torch.utils.metrics import global_metrics
    with serving(tbolt, port_ctx(), max_sessions=1) as port:
        before = global_metrics.value("bolt.connections_rejected_total")
        keep = tclient.BoltClient(port=port, timeout=TIMEOUT)
        try:
            with pytest.raises(tclient.BoltClientError) as e:
                tclient.BoltClient(port=port, timeout=TIMEOUT).execute(
                    "RETURN 1")
            assert "ServerOverloaded" in e.value.code
            assert global_metrics.value(
                "bolt.connections_rejected_total") == before + 1
            assert keep.execute("RETURN 40 + 2")[1] == [[42]]
        finally:
            keep.close()


# --------------------------------------------------------------------------
# CALL over Bolt
# --------------------------------------------------------------------------

N, E = 1500, 9000


def pairs():
    rng = np.random.default_rng(23)
    src = rng.integers(0, N, E)
    dst = (rng.random(E) ** 2 * N).astype(np.int64)
    return np.stack([src, dst], 1).tolist()


@pytest.fixture(scope="module")
def graph_servers(servers):
    """Both module servers hold the same generated graph, built by
    Cypher over Bolt."""
    for pkg, client in (("jax", jclient), ("port", tclient)):
        c = client.BoltClient(port=servers[pkg], timeout=TIMEOUT)
        try:
            c.execute("UNWIND range(0, $n - 1) AS i CREATE (:U {id: i})",
                      {"n": N})
            c.execute("CREATE INDEX ON :U(id)")
            c.execute("UNWIND $pairs AS p MATCH (a:U {id: p[0]}), "
                      "(b:U {id: p[1]}) CREATE (a)-[:F]->(b)",
                      {"pairs": pairs()})
        finally:
            c.close()
    return servers


CALLS = [
    ("CALL pagerank.get() YIELD node, rank RETURN node.id AS id, rank",
     1e-5, 1e-9),
    ("CALL wcc.get() YIELD node, component_id "
     "RETURN node.id AS id, component_id", 0.0, 0.0),
    ("CALL degree_centrality.get('out') YIELD node, degree "
     "RETURN node.id AS id, degree", 0.0, 0.0),
    ("CALL pagerank.get() YIELD node, rank RETURN node, rank "
     "ORDER BY rank DESC LIMIT 5", None, None),
]


@pytest.mark.parametrize("query,rtol,atol", CALLS,
                         ids=["pagerank", "wcc", "degree", "nodes"])
def test_a_call_over_bolt_matches_the_jax_server(graph_servers, query, rtol,
                                                 atol):
    out = {}
    for pkg, client in (("jax", jclient), ("port", tclient)):
        c = client.BoltClient(port=graph_servers[pkg], timeout=TIMEOUT)
        try:
            out[pkg] = c.execute(query)
        finally:
            c.close()
    (jcols, jrows, jsum), (tcols, trows, tsum) = out["jax"], out["port"]
    assert tcols == jcols and tsum == jsum
    assert len(trows) == len(jrows)
    if rtol is None:
        # whole nodes on the wire: the same top five
        assert [r[0].fields[2]["id"] for r in trows] == \
            [r[0].fields[2]["id"] for r in jrows]
        return
    assert len(trows) == N
    want = {r[0]: r[1:] for r in jrows}
    got = {r[0]: r[1:] for r in trows}
    assert want.keys() == got.keys()
    for k, row in want.items():
        assert all(type(x) in (int, float) for x in got[k])
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(row, np.float64),
                                   rtol=rtol, atol=atol)
