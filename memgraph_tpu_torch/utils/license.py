"""Enterprise license checking (reference: src/license/license.cpp,
license key settings `enterprise.license` / `organization.name` in
flags/run_time_configurable.cpp; surfaced by SHOW LICENSE INFO,
interpreter.cpp SystemInfoQuery::InfoType::LICENSE).

Key format (own design — the reference's `mglk-` scheme is not copied):

    mgtpu-<base64url(JSON payload)>.<sig>

payload = {"organization": str, "type": "enterprise"|"oem"|"ai-platform",
           "valid_until": unix epoch seconds (0 = perpetual),
           "memory_limit": bytes (0 = unlimited)}
sig     = first 16 hex chars of sha256(payload_b64 + "|" + organization)

The signature binds the key to the organization name, so a key only
validates when the `organization.name` setting matches — the same
operator contract as the reference. This is a checksum, not asymmetric
crypto: the goal is parity of behavior (key parsing, expiry, org match,
memory limit plumbing), not DRM.

Copy of memgraph_tpu/utils/license.py for the port: a key minted by
either package validates in both.
"""

from __future__ import annotations

import base64
import hashlib
import json
import time

KEY_PREFIX = "mgtpu-"
LICENSE_SETTING = "enterprise.license"
ORGANIZATION_SETTING = "organization.name"

VALID_TYPES = ("enterprise", "oem", "ai-platform")


def _sign(payload_b64: str, organization: str) -> str:
    return hashlib.sha256(
        f"{payload_b64}|{organization}".encode()).hexdigest()[:16]


def generate_key(organization: str, license_type: str = "enterprise",
                 valid_until: int = 0, memory_limit: int = 0) -> str:
    """Mint a key (admin/test helper; the reference ships keys out of
    band, so there is no query surface for this)."""
    if license_type not in VALID_TYPES:
        raise ValueError(f"license type must be one of {VALID_TYPES}")
    payload = json.dumps({
        "organization": organization, "type": license_type,
        "valid_until": int(valid_until), "memory_limit": int(memory_limit),
    }, sort_keys=True).encode()
    blob = base64.urlsafe_b64encode(payload).decode().rstrip("=")
    return f"{KEY_PREFIX}{blob}.{_sign(blob, organization)}"


def _decode(key: str) -> dict:
    """Parse + checksum-verify a key; raises ValueError with the reason."""
    if not key.startswith(KEY_PREFIX):
        raise ValueError(f"license key must start with {KEY_PREFIX!r}")
    blob, _, sig = key[len(KEY_PREFIX):].partition(".")
    try:
        padded = blob + "=" * (-len(blob) % 4)
        payload = json.loads(base64.urlsafe_b64decode(padded))
    except Exception as e:
        raise ValueError(f"malformed license payload: {e}") from e
    org = payload.get("organization", "")
    if sig != _sign(blob, org):
        raise ValueError("license key checksum mismatch")
    if payload.get("type") not in VALID_TYPES:
        raise ValueError(f"unknown license type {payload.get('type')!r}")
    return payload


class LicenseChecker:
    """Validates the key in the runtime settings store on every call —
    `SET DATABASE SETTING 'enterprise.license' TO '...'` takes effect
    immediately, like the reference's observer-driven checker."""

    def __init__(self, settings) -> None:
        self._settings = settings

    def info(self) -> dict:
        key = self._settings.get(LICENSE_SETTING) or ""
        organization = self._settings.get(ORGANIZATION_SETTING) or ""
        result = {
            "organization_name": organization,
            "license_key": key,
            "is_valid": False,
            "license_type": "",
            "valid_until": "",
            "memory_limit": "unlimited",
            "status": "",
        }
        if not key:
            result["status"] = "no license key set"
            return result
        try:
            payload = _decode(key)
        except ValueError as e:
            result["status"] = str(e)
            return result
        if payload["organization"] != organization:
            result["status"] = (
                "license issued to a different organization "
                f"({payload['organization']!r}); set "
                f"'{ORGANIZATION_SETTING}' to match")
            return result
        until = payload.get("valid_until", 0)
        if until:
            result["valid_until"] = time.strftime(
                "%Y-%m-%d", time.gmtime(until))
            if time.time() > until:
                result["license_type"] = payload["type"]
                result["status"] = "license expired"
                return result
        else:
            result["valid_until"] = "forever"
        limit = payload.get("memory_limit", 0)
        if limit:
            result["memory_limit"] = f"{limit / (1024 ** 3):.2f}GiB"
        result["is_valid"] = True
        result["license_type"] = payload["type"]
        result["status"] = "valid"
        return result

    def is_valid(self) -> bool:
        return self.info()["is_valid"]

    def memory_limit(self) -> int:
        """Licensed memory cap in bytes (0 = unlimited / no license).
        Runs the FULL validation — an expired or org-mismatched license
        grants nothing."""
        if not self.is_valid():
            return 0
        return _decode(
            self._settings.get(LICENSE_SETTING))["memory_limit"]
