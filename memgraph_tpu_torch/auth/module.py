"""External auth modules: subprocess JSON line protocol.

Counterpart of the reference's auth module host
(memgraph/src/auth/module.hpp:30 + reference_modules/): an
executable is spawned once and kept alive; each authentication request
writes ONE JSON line {"username", "password", ...} to its stdin and
reads ONE JSON line {"authenticated": bool, "role": str} back, under a
timeout. Any protocol violation (crash, timeout, malformed output,
missing fields) denies authentication — the module is trusted to say
yes, never assumed to.

Scheme routing: `module_mappings` ("saml:/path;oidc:/path") binds Bolt
auth schemes to executables, as the reference's
--auth-module-mappings flag does; the reserved name "basic" cannot be
remapped.

Copy of memgraph_tpu/auth/module.py for the port.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import threading

log = logging.getLogger(__name__)

CALL_TIMEOUT_SEC = 10.0


class AuthModule:
    """One external module executable, restarted on failure."""

    def __init__(self, executable: str,
                 timeout: float = CALL_TIMEOUT_SEC) -> None:
        self.executable = executable
        self.timeout = timeout
        self._proc: subprocess.Popen | None = None
        self._lock = threading.Lock()

    def _ensure_proc(self) -> subprocess.Popen:
        if self._proc is None or self._proc.poll() is not None:
            self._proc = subprocess.Popen(
                [self.executable], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True, bufsize=1)
        return self._proc

    def call(self, params: dict) -> dict | None:
        """One request/response; None on ANY protocol failure."""
        with self._lock:
            try:
                proc = self._ensure_proc()
                proc.stdin.write(json.dumps(params) + "\n")
                proc.stdin.flush()
                line = _read_line_with_timeout(proc, self.timeout)
                if line is None:
                    self._kill()
                    return None
                reply = json.loads(line)
                if not isinstance(reply, dict):
                    return None
                return reply
            except (OSError, ValueError, json.JSONDecodeError) as e:
                log.warning("auth module %s failed: %s", self.executable, e)
                self._kill()
                return None

    def _kill(self) -> None:
        if self._proc is not None:
            try:
                self._proc.kill()
            except OSError:
                pass
            self._proc = None

    def close(self) -> None:
        with self._lock:
            self._kill()


def _read_line_with_timeout(proc: subprocess.Popen, timeout: float):
    """Read one stdout line; None on timeout (a wedged module must not
    hang the Bolt worker)."""
    result: list = [None]

    def reader():
        try:
            result[0] = proc.stdout.readline()
        except (OSError, ValueError):
            result[0] = None

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive() or not result[0]:
        return None
    return result[0]


def parse_module_mappings(spec: str) -> dict[str, AuthModule]:
    """'saml:/path/a.py;oidc:/path/b.py' -> {scheme: AuthModule}."""
    out: dict[str, AuthModule] = {}
    for part in filter(None, (spec or "").split(";")):
        scheme, _, path = part.partition(":")
        scheme = scheme.strip().lower()
        path = path.strip()
        if not scheme or not path or scheme == "basic":
            log.warning("ignoring invalid auth module mapping %r", part)
            continue
        if not os.access(path, os.X_OK):
            log.warning("auth module %r is not executable; ignoring", path)
            continue
        out[scheme] = AuthModule(path)
    return out
