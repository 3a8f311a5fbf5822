#!/usr/bin/env python3
"""Reference auth module: users/roles from a JSON file.

Protocol (auth/module.py; reference: src/auth/reference_modules/): one
JSON line per request on stdin {"scheme", "username", "response"}, one
JSON line reply on stdout {"authenticated", "username", "role"}.

Config: AUTH_USERFILE env var -> {"users": {name: {"password": ...,
"role": ...}}}. Stands in for an IdP in tests and air-gapped deploys.

Copy of memgraph_tpu/auth/reference_modules/userfile.py for the port.
"""

import json
import os
import sys


def main():
    with open(os.environ["AUTH_USERFILE"]) as f:
        users = json.load(f)["users"]
    for line in sys.stdin:
        try:
            req = json.loads(line)
            user = users.get(req.get("username", ""))
            ok = user is not None and \
                user.get("password") == req.get("response")
            reply = {"authenticated": bool(ok)}
            if ok:
                reply["username"] = req["username"]
                reply["role"] = user.get("role", "")
        except Exception as e:  # noqa: BLE001 — reply, never crash
            reply = {"authenticated": False, "errors": str(e)}
        sys.stdout.write(json.dumps(reply) + "\n")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
