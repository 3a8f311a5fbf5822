"""TLS contexts for every listener: Bolt, replication, Raft, mgmt RPC.

Reference analog: memgraph/src/communication/context.cpp
(ServerContext/ClientContext wrapping OpenSSL) plus the intra-cluster TLS
init at memgraph.cpp:302-317, where one cert/key pair configured at startup
covers all cluster-internal channels. Same shape here: `set_cluster_tls`
installs a process-wide pair consulted by the replication and coordination
transports; Bolt takes its own pair (clients terminate TLS differently
than cluster peers).

Copy of memgraph_tpu/utils/tls.py for the port.
"""

from __future__ import annotations

import os
import ssl
import threading
from dataclasses import dataclass
from typing import Optional


def server_context(cert_file: str, key_file: str,
                   ca_file: Optional[str] = None) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_file, key_file)
    if ca_file:
        ctx.load_verify_locations(ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(ca_file: Optional[str] = None,
                   cert_file: Optional[str] = None,
                   key_file: Optional[str] = None,
                   verify_hostname: bool = True) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if ca_file:
        ctx.load_verify_locations(ca_file)
        # cluster peers dial by ip:port (verify_hostname=False); end-user
        # bolt+s clients verify the hostname against the CA-signed cert
        ctx.check_hostname = verify_hostname
    else:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    if cert_file and key_file:
        ctx.load_cert_chain(cert_file, key_file)
    return ctx


@dataclass
class ClusterTls:
    cert_file: str
    key_file: str
    ca_file: Optional[str] = None


_cluster: Optional[ClusterTls] = None
_cluster_server_ctx: Optional[ssl.SSLContext] = None
_cluster_client_ctx: Optional[ssl.SSLContext] = None
_lock = threading.Lock()


def set_cluster_tls(cert_file: str, key_file: str,
                    ca_file: Optional[str] = None) -> None:
    """Install intra-cluster TLS (replication + Raft + mgmt RPC). Contexts
    are built once here — Raft heartbeats wrap sockets many times a
    second, so per-connection context construction would hammer disk."""
    global _cluster, _cluster_server_ctx, _cluster_client_ctx
    with _lock:
        _cluster = ClusterTls(cert_file, key_file, ca_file)
        _cluster_server_ctx = server_context(cert_file, key_file, ca_file)
        _cluster_client_ctx = client_context(
            ca_file, cert_file, key_file, verify_hostname=False)


def clear_cluster_tls() -> None:
    global _cluster, _cluster_server_ctx, _cluster_client_ctx
    with _lock:
        _cluster = None
        _cluster_server_ctx = None
        _cluster_client_ctx = None


def cluster_server_context() -> Optional[ssl.SSLContext]:
    with _lock:
        return _cluster_server_ctx


def cluster_client_context() -> Optional[ssl.SSLContext]:
    with _lock:
        return _cluster_client_ctx


def wrap_cluster_server(sock, handshake_timeout: float = 5.0):
    """Wrap an accepted cluster-side connection if TLS is configured.

    A handshake deadline is mandatory: callers run this on per-connection
    threads, but without a timeout a silent peer would pin the thread (and
    a half-open scanner could exhaust them)."""
    ctx = cluster_server_context()
    if ctx is None:
        return sock
    old = sock.gettimeout()
    sock.settimeout(handshake_timeout)
    try:
        wrapped = ctx.wrap_socket(sock, server_side=True)
    finally:
        try:
            sock.settimeout(old)
        except OSError:
            pass
    wrapped.settimeout(old)
    return wrapped


def wrap_cluster_client(sock, server_hostname=None):
    ctx = cluster_client_context()
    if ctx is None:
        return sock
    return ctx.wrap_socket(sock, server_hostname=server_hostname)


def generate_self_signed(directory: str, common_name: str = "memgraph-tpu"
                         ) -> tuple[str, str]:
    """Create a self-signed cert + key (tests / quick start). Returns
    (cert_path, key_path)."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(x509.SubjectAlternativeName(
                [x509.DNSName("localhost"),
                 x509.IPAddress(__import__("ipaddress").ip_address(
                     "127.0.0.1"))]), critical=False)
            .sign(key, hashes.SHA256()))
    os.makedirs(directory, exist_ok=True)
    cert_path = os.path.join(directory, "cert.pem")
    key_path = os.path.join(directory, "key.pem")
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(key_path, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
    return cert_path, key_path
