#!/usr/bin/env python3
"""SAML SSO reference module (subprocess JSON-line protocol).

Validates a base64-encoded SAML Response (saml-entra-id / saml-okta
schemes), verifies the XML signature against the IdP certificate, checks
assertion conditions (NotBefore / NotOnOrAfter / audience), extracts the
NameID or a username attribute plus the role attribute, and maps the IdP
role through MEMGRAPH_SSO_<SCHEME>_SAML_ROLE_MAPPING. The env-variable
surface mirrors the reference module
(memgraph/src/auth/reference_modules/saml.py: IDP_CERT, IDP_ID,
ASSERTION_AUDIENCE, USE_NAME_ID, USERNAME_ATTRIBUTE, ROLE_MAPPING,
OKTA ROLE_ATTRIBUTE; Entra's role claim URI).

Signature verification deviates deliberately: the reference delegates to
python3-saml/xmlsec (exclusive C14N 1.0), which is not a dependency;
this module verifies RSA-SHA256 enveloped signatures using stdlib
`xml.etree.ElementTree.canonicalize` (W3C C14N 2.0) + `cryptography`.
IdPs that sign with exclusive-c14n-1.0 output that differs from C14N
2.0 canonical form are rejected rather than mis-accepted — verification
remains fail-closed.

Copy of memgraph_tpu/auth/reference_modules/saml.py for the port.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import sys
from datetime import datetime, timezone
from xml.etree import ElementTree as ET

NS = {
    "samlp": "urn:oasis:names:tc:SAML:2.0:protocol",
    "saml": "urn:oasis:names:tc:SAML:2.0:assertion",
    "ds": "http://www.w3.org/2000/09/xmldsig#",
}
ENTRA_ROLE_ATTR = ("http://schemas.microsoft.com/ws/2008/06/identity/"
                   "claims/role")
RSA_SHA256 = "http://www.w3.org/2001/04/xmldsig-more#rsa-sha256"
SHA256_URI = "http://www.w3.org/2001/04/xmlenc#sha256"


def _c14n(element: ET.Element) -> bytes:
    # rewrite_prefixes: digests must not depend on the namespace-prefix
    # names the producer happened to serialize with
    return ET.canonicalize(ET.tostring(element, encoding="unicode"),
                           strip_text=False,
                           rewrite_prefixes=True).encode("utf-8")


def _strip_signatures(element: ET.Element) -> ET.Element:
    """Copy of the tree with ds:Signature elements removed (enveloped-
    signature transform)."""
    clone = ET.fromstring(ET.tostring(element))
    for parent in clone.iter():
        for child in list(parent):
            if child.tag == f"{{{NS['ds']}}}Signature":
                parent.remove(child)
    return clone


def _load_idp_cert(path: str):
    from cryptography import x509
    with open(path, "rb") as f:
        data = f.read()
    if b"BEGIN CERTIFICATE" in data:
        return x509.load_pem_x509_certificate(data).public_key()
    from cryptography.hazmat.primitives.serialization import (
        load_pem_public_key)
    return load_pem_public_key(data)


def verify_signature(root: ET.Element, signed_el: ET.Element,
                     public_key) -> None:
    """Verify the enveloped RSA-SHA256 signature covering signed_el."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    sig = signed_el.find("ds:Signature", NS) or root.find(
        ".//ds:Signature", NS)
    if sig is None:
        raise ValueError("response is not signed")
    signed_info = sig.find("ds:SignedInfo", NS)
    method = sig.find(".//ds:SignatureMethod", NS)
    if signed_info is None or method is None:
        raise ValueError("malformed signature element")
    if method.get("Algorithm") != RSA_SHA256:
        raise ValueError("unsupported signature algorithm (rsa-sha256 only)")
    digest_method = sig.find(".//ds:DigestMethod", NS)
    if digest_method is None or digest_method.get("Algorithm") != SHA256_URI:
        raise ValueError("unsupported digest algorithm (sha256 only)")

    # 1. reference digest: sha256 of the signed element, signatures removed
    digest_value = sig.find(".//ds:DigestValue", NS)
    if digest_value is None or not digest_value.text:
        raise ValueError("missing digest value")
    computed = hashlib.sha256(_c14n(_strip_signatures(signed_el))).digest()
    if base64.b64decode(digest_value.text.strip()) != computed:
        raise ValueError("assertion digest mismatch")

    # 2. signature over canonicalized SignedInfo
    sig_value = sig.find("ds:SignatureValue", NS)
    if sig_value is None or not sig_value.text:
        raise ValueError("missing signature value")
    public_key.verify(base64.b64decode(sig_value.text.strip()),
                      _c14n(signed_info),
                      padding.PKCS1v15(), hashes.SHA256())


def _check_conditions(assertion: ET.Element, audience: str) -> None:
    cond = assertion.find("saml:Conditions", NS)
    if cond is None:
        raise ValueError("assertion has no Conditions")
    now = datetime.now(timezone.utc)

    def parse(ts):
        return datetime.fromisoformat(ts.replace("Z", "+00:00"))

    nb, noa = cond.get("NotBefore"), cond.get("NotOnOrAfter")
    if nb and now < parse(nb):
        raise ValueError("assertion not yet valid")
    if noa and now >= parse(noa):
        raise ValueError("assertion expired")
    if audience:
        auds = [a.text for a in cond.findall(".//saml:Audience", NS)]
        if audience not in auds:
            raise ValueError("audience restriction mismatch")


def _attributes(assertion: ET.Element) -> dict:
    out: dict = {}
    for attr in assertion.findall(".//saml:Attribute", NS):
        values = [v.text or "" for v in
                  attr.findall("saml:AttributeValue", NS)]
        out[attr.get("Name")] = values
    return out


def authenticate(scheme: str, response: str) -> dict:
    if scheme not in ("saml-entra-id", "saml-okta"):
        return {"authenticated": False, "errors": "invalid SSO scheme"}
    se = "ENTRA_ID" if scheme == "saml-entra-id" else "OKTA"
    env = os.environ.get
    try:
        xml = base64.b64decode(response)
        root = ET.fromstring(xml)
        assertion = root.find(".//saml:Assertion", NS)
        if assertion is None:
            raise ValueError("no assertion in response")
        cert_path = env(f"MEMGRAPH_SSO_{se}_SAML_IDP_CERT", "")
        if not cert_path:
            raise ValueError("IdP certificate not configured")
        verify_signature(root, assertion, _load_idp_cert(cert_path))
        idp_id = env(f"MEMGRAPH_SSO_{se}_SAML_IDP_ID", "")
        if idp_id:
            issuer = assertion.find("saml:Issuer", NS)
            if issuer is None or issuer.text != idp_id:
                raise ValueError("issuer mismatch")
        _check_conditions(
            assertion, env(f"MEMGRAPH_SSO_{se}_SAML_ASSERTION_AUDIENCE", ""))

        attrs = _attributes(assertion)
        role_attr = (ENTRA_ROLE_ATTR if scheme == "saml-entra-id"
                     else env("MEMGRAPH_SSO_OKTA_SAML_ROLE_ATTRIBUTE", ""))
        if role_attr not in attrs:
            raise ValueError("role attribute missing from assertion")
        idp_role = attrs[role_attr]
        idp_role = idp_role[0] if isinstance(idp_role, list) else idp_role

        mappings_raw = "".join(
            env(f"MEMGRAPH_SSO_{se}_SAML_ROLE_MAPPING", "").split(" "))
        mappings = dict(m.split(":") for m in mappings_raw.split(";") if m)
        if idp_role not in mappings:
            raise ValueError(
                f"the role {idp_role!r} is not present in the role mappings")

        use_name_id = env(f"MEMGRAPH_SSO_{se}_SAML_USE_NAME_ID",
                          "true").lower() in ("true", "1", "yes")
        if use_name_id:
            name_id = assertion.find(".//saml:NameID", NS)
            if name_id is None or not name_id.text:
                raise ValueError("NameID not found in assertion")
            username = name_id.text
        else:
            uattr = env(f"MEMGRAPH_SSO_{se}_SAML_USERNAME_ATTRIBUTE", "")
            if uattr not in attrs or not attrs[uattr]:
                raise ValueError(f"username attribute {uattr!r} missing")
            username = attrs[uattr][0]
        return {"authenticated": True, "username": username,
                "role": mappings[idp_role]}
    except Exception as e:  # noqa: BLE001 — the host treats errors as deny
        return {"authenticated": False, "errors": str(e)}


def main() -> None:
    for line in sys.stdin:
        if not line.strip():
            continue
        try:
            params = json.loads(line)
            ret = authenticate(params.get("scheme", ""),
                               params.get("response", ""))
        except Exception as e:  # noqa: BLE001
            ret = {"authenticated": False, "errors": str(e)}
        sys.stdout.write(json.dumps(ret) + "\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
