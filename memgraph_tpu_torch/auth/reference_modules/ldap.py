#!/usr/bin/env python3
"""Reference auth module: LDAP bind + role lookup.

Counterpart of memgraph/src/auth/reference_modules/ldap.py: binds
as the user DN (prefix + username + suffix), optionally resolves a role
from a group search. Config via LDAP_CONFIG env var (JSON):
{"host", "port", "prefix", "suffix", "role_base": optional,
 "role_attribute": optional}. Requires the ldap3 client library.

Copy of memgraph_tpu/auth/reference_modules/ldap.py for the port.
"""

import json
import os
import sys


def main():
    cfg = json.loads(os.environ.get("LDAP_CONFIG", "{}"))
    try:
        import ldap3
    except ImportError:
        # no client library: deny everything, loudly once
        sys.stderr.write("ldap3 is not installed\n")
        for _ in sys.stdin:
            sys.stdout.write(json.dumps({"authenticated": False}) + "\n")
            sys.stdout.flush()
        return
    server = ldap3.Server(cfg.get("host", "localhost"),
                          port=int(cfg.get("port", 389)))
    for line in sys.stdin:
        reply = {"authenticated": False}
        try:
            req = json.loads(line)
            username = req.get("username", "")
            password = req.get("response", "")
            # empty password would perform an ANONYMOUS bind, which most
            # LDAP servers accept — deny before binding
            if username and password:
                dn = cfg.get("prefix", "") + \
                    ldap3.utils.dn.escape_rdn(username) + \
                    cfg.get("suffix", "")
                conn = ldap3.Connection(server, dn, password)
                if conn.bind():
                    reply = {"authenticated": True, "username": username}
                    base = cfg.get("role_base")
                    if base and conn.search(
                            base, f"(member={dn})",
                            attributes=[cfg.get("role_attribute", "cn")]):
                        if conn.entries:
                            reply["role"] = str(
                                conn.entries[0][
                                    cfg.get("role_attribute", "cn")])
                    conn.unbind()
        except Exception as e:  # noqa: BLE001
            reply = {"authenticated": False, "errors": str(e)}
        sys.stdout.write(json.dumps(reply) + "\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
