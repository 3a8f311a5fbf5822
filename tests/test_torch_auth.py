"""The port's auth (memgraph_tpu_torch/auth, utils/license.py) against the
JAX package's on the CPU.

- Scripts of auth, fine-grained, user-profile, password-policy and
  license statements run statement by statement, each as a named session
  user, through the JAX package's interpreter and the port's
  (``device="cpu"``), each context with an auth store of its own.  Every
  statement's columns, rows and summary, or its error (class and
  message), are compared exactly (``test_torch_cypher.run``).
- Each package's ``Auth`` loads the JSON file the other wrote, and a
  license key minted by either validates alike in both.
- An SSO module (the reference ``userfile`` module, run as a script by
  ``auth/module.py``) authenticates alike in both; the port's module
  scripts import neither ``jax`` nor ``memgraph_tpu``.
"""

import ast
import os
import sys

import pytest
import torch

from memgraph_tpu.auth import auth as jauth
from memgraph_tpu.auth import module as jmodule
from memgraph_tpu.query import interpreter as jinterp
from memgraph_tpu.storage import InMemoryStorage as JStorage
from memgraph_tpu.utils import license as jlicense
from memgraph_tpu_torch.auth import auth as tauth
from memgraph_tpu_torch.auth import module as tmodule
from memgraph_tpu_torch.query import interpreter as tinterp
from memgraph_tpu_torch.storage import InMemoryStorage as TStorage
from memgraph_tpu_torch.utils import license as tlicense
from test_torch_cypher import run

# One intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each of them oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Sessions:
    """One interpreter context of a package, and one interpreter a
    session user on it (None: the anonymous session)."""

    def __init__(self, interp_mod, storage, auth, config):
        kw = {"device": "cpu"} if interp_mod is tinterp else {}
        self.mod = interp_mod
        self.ctx = interp_mod.InterpreterContext(storage, dict(config), **kw)
        self.ctx.auth_store = auth
        self.by_user = {}

    def __call__(self, user):
        if user not in self.by_user:
            it = self.mod.Interpreter(self.ctx)
            it.username = user
            self.by_user[user] = it
        return self.by_user[user]


def play(script, config=None):
    """Each step of ``script`` ((user, query) or (user, query, params))
    through both packages: a list of (step, JAX outcome, port outcome)."""
    j = Sessions(jinterp, JStorage(), jauth.Auth(), config or {})
    t = Sessions(tinterp, TStorage(), tauth.Auth(), config or {})
    out = []
    for step in script:
        user, query, params = (*step, None)[:3]
        out.append((step, run(j(user), query, params),
                    run(t(user), query, params)))
    return out


def assert_same(outcomes):
    for step, want, got in outcomes:
        assert got == want, step


RBAC = [
    (None, "SHOW USERS"),
    (None, "RETURN roles(), username()"),
    (None, "CREATE USER admin IDENTIFIED BY 'adminpw'"),
    (None, "CREATE (:Anonymous)"),
    ("admin", "CREATE USER reader IDENTIFIED BY 'readerpw'"),
    ("admin", "CREATE USER reader IDENTIFIED BY 'again'"),
    ("admin", "GRANT MATCH, SET TO reader"),
    ("admin", "CREATE (:T {v: 1})"),
    ("reader", "MATCH (n:T) RETURN n.v"),
    ("reader", "CREATE (:Nope)"),
    ("reader", "MATCH (n:T) SET n.v = 2 RETURN n.v"),
    ("reader", "CREATE INDEX ON :T(x)"),
    ("reader", "CREATE USER sneaky"),
    ("admin", "CREATE ROLE writers"),
    ("admin", "GRANT CREATE TO writers"),
    ("admin", "SET ROLE FOR reader TO writers"),
    ("reader", "CREATE (:ViaRole)"),
    ("reader", "RETURN roles(), username()"),
    ("admin", "DENY CREATE TO reader"),
    ("reader", "CREATE (:Denied)"),
    ("admin", "SHOW PRIVILEGES FOR reader"),
    ("admin", "REVOKE CREATE FROM reader"),
    ("admin", "SHOW PRIVILEGES FOR reader"),
    ("reader", "CREATE (:AfterRevoke)"),
    ("admin", "SHOW ROLES"),
    ("admin", "SHOW USERS"),
    ("reader", "SHOW CURRENT USER"),
    ("admin", "RETURN roles('memgraph')"),
    ("admin", "RETURN roles(123)"),
    ("reader", "SET PASSWORD TO 'newpw'"),
    ("admin", "CREATE USER p IDENTIFIED BY $pw", {"pw": "x"}),
    ("admin", "CREATE USER q IDENTIFIED BY $nope"),
    ("admin", "GRANT ALL PRIVILEGES TO p"),
    ("admin", "SHOW PRIVILEGES FOR p"),
    ("admin", "DROP ROLE writers"),
    ("admin", "DROP USER ghost"),
    ("admin", "DROP USER reader"),
    ("admin", "SHOW USERS"),
    ("admin", "MATCH (n) RETURN labels(n) ORDER BY labels(n)[0]"),
]

FINE_GRAINED = [
    (None, "CREATE (:Public {v: 1})-[:LINK {w: 1}]->(:Secret {v: 2})"),
    (None, "CREATE (:Public {v: 3})"),
    (None, "CREATE USER admin"),
    ("admin", "CREATE USER frank IDENTIFIED BY 'f'"),
    ("admin", "GRANT MATCH TO frank"),
    ("admin", "GRANT READ ON LABELS :Public TO frank"),
    ("frank", "MATCH (n) RETURN labels(n), n.v ORDER BY n.v"),
    ("frank", "MATCH (n:Public) SET n.v = 99"),
    ("admin", "GRANT SET, DELETE TO frank"),
    ("frank", "MATCH (n:Public {v: 1}) SET n.v = 99 RETURN n.v"),
    ("admin", "GRANT UPDATE ON LABELS :Public TO frank"),
    ("frank", "MATCH (n:Public {v: 1}) SET n.v = 99 RETURN n.v"),
    ("frank", "MATCH (n:Public {v: 3}) DELETE n"),
    ("frank", "MATCH ()-[r]->() RETURN type(r)"),
    ("admin", "GRANT READ ON EDGE_TYPES :LINK TO frank"),
    ("frank", "MATCH ()-[r]->() RETURN type(r), r.w"),
    ("admin", "SHOW PRIVILEGES FOR frank"),
    ("admin", "REVOKE READ ON LABELS :Public FROM frank"),
    ("frank", "MATCH (n) RETURN count(n)"),
    ("admin", "CREATE ROLE locked"),
    ("admin", "GRANT NOTHING ON LABELS * TO locked"),
    ("admin", "CREATE USER dave"),
    ("admin", "GRANT MATCH TO dave"),
    ("admin", "SET ROLE FOR dave TO locked"),
    ("dave", "MATCH (n) RETURN count(n)"),
    ("admin", "GRANT CREATE_DELETE ON LABELS :Public TO frank"),
    ("admin", "GRANT CREATE TO frank"),
    ("frank", "CREATE (:Public {v: 7})"),
    ("frank", "CREATE (:Secret {v: 8})"),
    ("admin", "MATCH (n) RETURN labels(n), n.v ORDER BY n.v"),
]

USER_PROFILES = [
    (None, "CREATE PROFILE p1 LIMIT sessions 5"),
    (None, "CREATE PROFILE p1 LIMIT sessions 5"),
    (None, "CREATE PROFILE small LIMIT transactions_memory 1MB"),
    (None, "CREATE PROFILE bad LIMIT bananas 3"),
    (None, "SHOW PROFILES"),
    (None, "SET PROFILE FOR ann TO p1"),
    (None, "SET PROFILE FOR bob TO nope"),
    (None, "SHOW PROFILE FOR ann"),
    (None, "SHOW PROFILE FOR bob"),
    (None, "SHOW USERS FOR PROFILE p1"),
    (None, "UPDATE PROFILE p1 LIMIT sessions UNLIMITED"),
    (None, "SHOW PROFILE p1"),
    (None, "SET PROFILE FOR miser TO small"),
    ("miser", "UNWIND range(1, 200000) AS i RETURN count(i)"),
    ("miser", "UNWIND range(1, 200000) AS i WITH collect(i) AS c "
              "RETURN size(c)"),
    ("ann", "UNWIND range(1, 200000) AS i WITH collect(i) AS c "
            "RETURN size(c)"),
    (None, "CLEAR PROFILE FOR ann"),
    (None, "SHOW USERS FOR PROFILE p1"),
    (None, "DROP PROFILE p1"),
    (None, "DROP PROFILE p1"),
    (None, "SHOW PROFILES"),
]

PASSWORD_POLICY = [
    (None, "CREATE USER weak IDENTIFIED BY 'short'"),
    (None, "CREATE USER nopw"),
    (None, "CREATE USER strong IDENTIFIED BY 'longenough1'"),
    ("strong", "SET PASSWORD TO 'nope'"),
    ("strong", "SET PASSWORD TO 'alsolongenough2'"),
    ("strong", "SET PASSWORD TO null"),
    ("strong", "SHOW USERS"),
]


def license_script(key, organization="Acme"):
    return [
        (None, "SHOW LICENSE INFO"),
        (None, f"SET DATABASE SETTING 'organization.name' TO "
               f"'{organization}'"),
        (None, f"SET DATABASE SETTING 'enterprise.license' TO '{key}'"),
        (None, "SHOW LICENSE INFO"),
        (None, "SHOW DATABASE SETTINGS"),
    ]


SCRIPTS = {
    "rbac": (RBAC, None),
    "fine_grained": (FINE_GRAINED, None),
    "user_profiles": (USER_PROFILES, None),
    "password_policy": (PASSWORD_POLICY,
                        {"auth_password_strength_regex": ".{8,}",
                         "auth_password_permit_null": False}),
    "license_valid": (license_script(jlicense.generate_key(
        "Acme", "enterprise", memory_limit=3 << 30)), None),
    "license_port_key": (license_script(tlicense.generate_key(
        "Acme", "oem")), None),
    "license_other_organization": (license_script(
        jlicense.generate_key("Other")), None),
    "license_expired": (license_script(jlicense.generate_key(
        "Acme", valid_until=1000)), None),
    "license_malformed": (license_script("mgtpu-bad.sig"), None),
}


@pytest.mark.parametrize("name", SCRIPTS)
def test_script(name):
    script, config = SCRIPTS[name]
    outcomes = play(script, config)
    assert_same(outcomes)
    # the scripts hold successes and errors both
    kinds = {got[0] for _, _, got in outcomes}
    assert "ok" in kinds
    if not name.startswith("license"):
        assert "error" in kinds


def test_the_first_user_is_the_administrator():
    outcomes = play(RBAC[:5])
    assert outcomes[3][2][0] == "error"           # anonymous write
    assert outcomes[4][2][0] == "ok"              # the first user: admin


# --------------------------------------------------------------------------
# stores and keys across the packages
# --------------------------------------------------------------------------

def populate(auth_mod, path):
    a = auth_mod.Auth(path)
    a.create_user("admin", "adminpw")
    a.create_user("reader", "readerpw")
    a.create_user("nopw")
    a.create_role("analysts")
    a.set_role("reader", "analysts")
    a.grant("reader", ["MATCH", "SET"])
    a.deny("reader", ["DELETE"])
    a.grant("analysts", ["CREATE"])
    a.grant_fine_grained("reader", "label", ["Public"], "READ")
    a.grant_fine_grained("reader", "edge_type", ["*"], "UPDATE")
    return a


def describe(a):
    """What a store answers, as plain values."""
    out = {"users": a.users(), "roles": a.roles()}
    for u in a.users():
        out[u] = {"roles": a.user_roles(u),
                  "privileges": a.effective_privileges(u),
                  "labels": [a.fine_grained_checker(u).label_level(x)
                             for x in ("Public", "Secret")],
                  "edge_types": [a.fine_grained_checker(u)
                                 .edge_type_level(x) for x in ("LINK",)]}
    out["logins"] = [a.authenticate(u, p) for u, p in
                     (("admin", "adminpw"), ("admin", "x"),
                      ("reader", "readerpw"), ("nopw", ""),
                      ("ghost", "x"))]
    return out


@pytest.mark.parametrize("writer,reader", [(jauth, tauth), (tauth, jauth)],
                         ids=["jax_writes", "port_writes"])
def test_each_auth_loads_the_others_json_file(tmp_path, writer, reader):
    path = str(tmp_path / "auth.json")
    written = populate(writer, path)
    loaded = reader.Auth(path)
    assert describe(loaded) == describe(written)
    # and it writes the file back as the other reads it
    loaded.create_user("late", "latepw")
    again = writer.Auth(path)
    assert again.users() == ["admin", "late", "nopw", "reader"]
    assert again.authenticate("late", "latepw")


class DictSettings(dict):
    pass


@pytest.mark.parametrize("minted_by", [jlicense, tlicense],
                         ids=["jax_key", "port_key"])
@pytest.mark.parametrize("args", [("Acme", "enterprise", 0, 0),
                                  ("Acme", "oem", 4102444800, 1 << 30),
                                  ("Acme", "ai-platform", 1000, 0)],
                         ids=["perpetual", "dated", "expired"])
def test_a_license_key_validates_alike_in_both(minted_by, args):
    key = minted_by.generate_key(*args)
    for org in ("Acme", "Other"):
        settings = DictSettings({jlicense.LICENSE_SETTING: key,
                                 jlicense.ORGANIZATION_SETTING: org})
        want = jlicense.LicenseChecker(settings)
        got = tlicense.LicenseChecker(settings)
        assert got.info() == want.info()
        assert got.memory_limit() == want.memory_limit()


# --------------------------------------------------------------------------
# SSO modules
# --------------------------------------------------------------------------

MODULES = os.path.join(REPO, "memgraph_tpu_torch", "auth",
                       "reference_modules")


@pytest.mark.parametrize("script", sorted(os.listdir(MODULES)))
def test_a_module_script_imports_neither_jax_nor_the_jax_package(script):
    tree = ast.parse(open(os.path.join(MODULES, script)).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{script}: a relative import"
            tops.add(node.module.split(".")[0])
    assert not tops & {"jax", "jaxlib", "memgraph_tpu",
                       "memgraph_tpu_torch"}, tops


def test_an_sso_module_authenticates_alike(tmp_path, monkeypatch):
    import json
    users = tmp_path / "users.json"
    users.write_text(json.dumps({"users": {
        "sso_ann": {"password": "s3cret", "role": "analysts"},
        "sso_bob": {"password": "pw"}}}))
    monkeypatch.setenv("AUTH_USERFILE", str(users))
    answers = []
    for auth_mod, module_mod, pkg in ((jauth, jmodule, "memgraph_tpu"),
                                      (tauth, tmodule,
                                       "memgraph_tpu_torch")):
        exe = os.path.join(REPO, pkg, "auth", "reference_modules",
                           "userfile.py")
        mappings = module_mod.parse_module_mappings(
            f"basic:{exe};userfile:{exe};bad:")
        assert list(mappings) == ["userfile"]
        a = auth_mod.Auth(module_mappings=mappings)
        try:
            got = [a.authenticate_external("userfile", u, p)
                   for u, p in (("sso_ann", "s3cret"), ("sso_ann", "no"),
                                ("sso_bob", "pw"), ("ghost", "x"))]
            got.append(a.authenticate_external("saml", "sso_ann", "s3cret"))
            got.append((a.users(), a.roles(), a.user_roles("sso_ann"),
                        a.authenticate("sso_ann", "s3cret")))
        finally:
            for m in mappings.values():
                m.close()
        answers.append(got)
    assert answers[1] == answers[0]
    assert answers[0][0] == "sso_ann" and answers[0][1] is None


def test_a_module_that_never_answers_denies_within_its_timeout(tmp_path):
    exe = tmp_path / "silent.py"
    exe.write_text(f"#!{sys.executable}\nimport time\ntime.sleep(60)\n")
    exe.chmod(0o755)
    m = tmodule.AuthModule(str(exe), timeout=1.0)
    try:
        assert m.call({"username": "x", "response": "y"}) is None
    finally:
        m.close()
