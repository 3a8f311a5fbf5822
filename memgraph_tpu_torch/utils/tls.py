"""TLS contexts for the Bolt listener (bolt+s) and its clients.

Reference analog: memgraph/src/communication/context.cpp
(ServerContext/ClientContext wrapping OpenSSL).

Copy of memgraph_tpu/utils/tls.py for the port, without its intra-cluster
pair (``set_cluster_tls`` and the cluster contexts and wrappers, for the
replication and coordination transports): that comes with the port's
replication slice, and until then ``main`` refuses the cluster TLS flags.
"""

from __future__ import annotations

import os
import ssl
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
