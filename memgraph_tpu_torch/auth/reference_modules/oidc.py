#!/usr/bin/env python3
"""OIDC SSO reference module (subprocess JSON-line protocol).

Validates OIDC access/ID tokens (RS256 JWTs) against the identity
provider's JWKS endpoint and maps IdP roles to local roles. Behavior
mirrors the reference's OIDC module
(memgraph/src/auth/reference_modules/oidc.py: scheme variants
oidc-entra-id / oidc-okta / oidc-custom, env-driven config including the
MEMGRAPH_SSO_* variable names, "token_type:field" username selection,
"idp_role:role1,role2;..." role mappings) — reimplemented on the stdlib
+ `cryptography` (no PyJWT or requests dependency) and on THIS repo's
module protocol: one JSON line {"scheme", "username", "response"} in,
one JSON line {"authenticated", "username", "roles"} out.

The Bolt client supplies `response` as "access_token=...;id_token=..."
(the reference's convention). JWKS endpoints may be http(s):// or
file:// — the latter lets tests and air-gapped deployments pin keys.

Copy of memgraph_tpu/auth/reference_modules/oidc.py for the port.
"""

from __future__ import annotations

import base64
import json
import os
import sys
import time
import urllib.request


def _b64url(data: str) -> bytes:
    pad = -len(data) % 4
    return base64.urlsafe_b64decode(data + "=" * pad)


def _b64url_uint(data: str) -> int:
    return int.from_bytes(_b64url(data), "big")


_JWKS_CACHE: dict = {}          # url -> (fetched_at, jwks)
JWKS_TTL_SEC = 300.0            # IdPs rate-limit their keys endpoints


def _fetch_jwks(url: str, cafile=None) -> dict:
    cached = _JWKS_CACHE.get(url)
    if cached and time.time() - cached[0] < JWKS_TTL_SEC:
        return cached[1]
    ctx = None
    if url.startswith("https"):
        import ssl
        ctx = ssl.create_default_context(cafile=cafile)
    with urllib.request.urlopen(url, timeout=10, context=ctx) as resp:
        jwks = json.loads(resp.read().decode("utf-8"))
    _JWKS_CACHE[url] = (time.time(), jwks)
    return jwks


def _verify_rs256(token: str, jwk: dict) -> dict:
    """Verify header.payload signature against an RSA JWK; returns the
    decoded claims. Raises ValueError on any failure."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    head_b64, body_b64, sig_b64 = token.split(".")
    pub = rsa.RSAPublicNumbers(
        _b64url_uint(jwk["e"]), _b64url_uint(jwk["n"])).public_key()
    try:
        pub.verify(_b64url(sig_b64),
                   f"{head_b64}.{body_b64}".encode("ascii"),
                   padding.PKCS1v15(), hashes.SHA256())
    except Exception as e:  # noqa: BLE001 — any crypto failure = invalid
        raise ValueError(f"signature verification failed: {e}") from e
    return json.loads(_b64url(body_b64))


def validate_jwt(token: str, jwks: dict, audience: str | None) -> dict:
    """Full token validation: alg, kid lookup, signature, exp, aud."""
    try:
        header = json.loads(_b64url(token.split(".")[0]))
    except Exception as e:  # noqa: BLE001
        raise ValueError(f"cannot decode JWT header: {e}") from e
    if header.get("alg") != "RS256":
        raise ValueError("invalid algorithm in header (RS256 required)")
    kid = header.get("kid")
    if not kid:
        raise ValueError("missing key ID (kid) in JWT header")
    keys = jwks.get("keys")
    if not isinstance(keys, list):
        raise ValueError("invalid JWKS response: missing keys array")
    jwk = next((k for k in keys if k.get("kid") == kid), None)
    if jwk is None:
        raise ValueError("matching kid not found")
    claims = _verify_rs256(token, jwk)
    exp = claims.get("exp")
    if exp is None:
        raise ValueError("token missing expiration claim")
    if int(exp) < int(time.time()):
        raise ValueError("token expired")
    nbf = claims.get("nbf")
    if nbf is not None and int(nbf) > int(time.time()):
        raise ValueError("token not yet valid")
    if audience:
        aud = claims.get("aud")
        auds = aud if isinstance(aud, list) else [aud]
        if audience not in auds:
            raise ValueError("audience mismatch")
    return claims


def parse_role_mappings(raw: str) -> dict:
    """'idp_role:role1,role2;other:role3' -> {idp_role: [roles...]}."""
    out: dict[str, list] = {}
    if not raw or not raw.strip():
        raise ValueError("missing role mappings")
    for mapping in raw.strip().split(";"):
        if not mapping.strip():
            continue
        parts = mapping.split(":")
        if len(parts) != 2:
            raise ValueError(f"invalid role mapping: {mapping}")
        roles = [r.strip() for r in parts[1].split(",") if r.strip()]
        if not roles:
            raise ValueError(f"no valid roles specified for: {parts[0]}")
        out[parts[0].strip()] = roles
    return out


_SCHEME_PREFIX = {
    "oidc-entra-id": "MEMGRAPH_SSO_ENTRA_ID_OIDC",
    "oidc-okta": "MEMGRAPH_SSO_OKTA_OIDC",
    "oidc-custom": "MEMGRAPH_SSO_CUSTOM_OIDC",
}


def load_config(scheme: str) -> dict:
    p = _SCHEME_PREFIX[scheme]
    env = os.environ.get
    cfg = {
        "role_field": env(f"{p}_ROLE_FIELD",
                          "groups" if scheme == "oidc-okta" else "roles"),
        "username": env(f"{p}_USERNAME", "id:sub"),
        "role_mapping": parse_role_mappings(env(f"{p}_ROLE_MAPPING", "")),
        "cafile": env(f"{p}_EXTRA_CA_CERTS") or None,
    }
    if scheme == "oidc-entra-id":
        tenant = env(f"{p}_TENANT_ID", "")
        cfg["jwks_uri"] = (f"https://login.microsoftonline.com/{tenant}"
                           "/discovery/v2.0/keys")
        cfg["access_aud"] = cfg["id_aud"] = env(f"{p}_CLIENT_ID", "")
    elif scheme == "oidc-okta":
        cfg["jwks_uri"] = f"{env(f'{p}_ISSUER', '')}/v1/keys"
        cfg["access_aud"] = env(f"{p}_AUTHORIZATION_SERVER", "")
        cfg["id_aud"] = env(f"{p}_CLIENT_ID", "")
    else:
        cfg["jwks_uri"] = env(f"{p}_PUBLIC_KEY_ENDPOINT", "")
        cfg["access_aud"] = env(f"{p}_ACCESS_TOKEN_AUDIENCE", "")
        cfg["id_aud"] = env(f"{p}_ID_TOKEN_AUDIENCE", "")
    cfg["use_id_token"] = cfg["username"].startswith("id:")
    return cfg


def map_roles(claims: dict, cfg: dict) -> list:
    field = cfg["role_field"]
    if field not in claims:
        raise ValueError(
            f"missing roles field named {field} — roles are probably not "
            "configured on the token issuer")
    idp_roles = claims[field]
    if isinstance(idp_roles, str):
        idp_roles = [idp_roles]
    matched: list = []
    for r in idp_roles:
        for local in cfg["role_mapping"].get(r, ()):
            if local not in matched:
                matched.append(local)
    if not matched:
        raise ValueError(
            f"cannot map any of the roles {sorted(idp_roles)} to local roles")
    return matched


def authenticate(scheme: str, response: str) -> dict:
    if scheme not in _SCHEME_PREFIX:
        return {"authenticated": False, "errors": "invalid SSO scheme"}
    try:
        cfg = load_config(scheme)
        tokens = dict(t.split("=", 1) for t in response.split(";") if t)
        jwks = _fetch_jwks(cfg["jwks_uri"], cafile=cfg["cafile"])

        def _validate_with_rotation(token, aud):
            """On a kid miss, bypass the JWKS cache once: the IdP may
            have rotated its signing keys inside the cache TTL."""
            nonlocal jwks
            try:
                return validate_jwt(token, jwks, aud)
            except ValueError as e:
                if "kid not found" not in str(e):
                    raise
                _JWKS_CACHE.pop(cfg["jwks_uri"], None)
                jwks = _fetch_jwks(cfg["jwks_uri"], cafile=cfg["cafile"])
                return validate_jwt(token, jwks, aud)

        access = _validate_with_rotation(tokens["access_token"],
                                         cfg["access_aud"] or None)
        id_claims = None
        if cfg["use_id_token"]:
            id_claims = _validate_with_rotation(tokens["id_token"],
                                                cfg["id_aud"] or None)
        roles = map_roles(access, cfg)
        token_type, _, field = cfg["username"].partition(":")
        source = id_claims if token_type == "id" else access
        if not field or source is None or field not in source:
            raise ValueError(f"field {field!r} missing in {token_type} token")
        return {"authenticated": True, "username": str(source[field]),
                "roles": roles}
    except Exception as e:  # noqa: BLE001 — the host treats errors as deny
        return {"authenticated": False, "errors": str(e)}


def main() -> None:
    # stateless loop: one JSON line in, one out (auth/module.py protocol)
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
