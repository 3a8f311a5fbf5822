"""openCypher recursive-descent parser.

Grammar shape follows the openCypher specification (the reference parses
with ANTLR against frontend/opencypher/grammar/Cypher.g4 plus extensions in
MemgraphCypher.g4); this is a fresh hand-written implementation covering the
query surface the engine executes: reading/writing clauses, expressions with
full precedence, patterns incl. variable-length edges, CALL ... YIELD,
UNION, DDL (indexes/constraints), transactions, EXPLAIN/PROFILE, and the
admin/info query families.

Copy of memgraph_tpu/query/frontend/parser.py for the port (its imports the port's own).
"""

from __future__ import annotations

from typing import Optional

from ...exceptions import SyntaxException
from . import ast as A
from .lexer import T, Token, tokenize


def parse(text: str):
    """Parse one statement (trailing ';' tolerated). Returns an AST root:
    CypherQuery | IndexQuery | ConstraintQuery | InfoQuery | ... """
    p = Parser(tokenize(text))
    p._source = text
    return p.parse_statement()


class Parser:
    def __init__(self, tokens: list[Token]) -> None:
        self.toks = tokens
        self.i = 0
        self._source: str | None = None  # original text (verbatim columns)

    # --- token helpers ------------------------------------------------------

    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def peek(self, k=1) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def advance(self) -> Token:
        tok = self.toks[self.i]
        if tok.type != T.EOF:
            self.i += 1
        return tok

    def at(self, type_: str) -> bool:
        return self.cur.type == type_

    def at_kw(self, *names: str) -> bool:
        return self.cur.is_kw(*names)

    def _at_profile_word(self) -> bool:
        """PROFILE/PROFILES at the cursor (keyword or identifier)."""
        return self.cur.is_kw("PROFILE") or (
            self.cur.type == T.IDENT
            and self.cur.value.upper() in ("PROFILE", "PROFILES"))

    def _peek_is_profile(self) -> bool:
        nxt = self.peek()
        return nxt.is_kw("PROFILE") or (
            nxt.type == T.IDENT and nxt.value.upper() == "PROFILE")

    def accept(self, type_: str) -> Optional[Token]:
        if self.cur.type == type_:
            return self.advance()
        return None

    def accept_kw(self, *names: str) -> Optional[Token]:
        if self.cur.is_kw(*names):
            return self.advance()
        return None

    def expect(self, type_: str) -> Token:
        if self.cur.type != type_:
            self.error(f"expected {type_!r}, got {self._desc(self.cur)}")
        return self.advance()

    def expect_kw(self, *names: str) -> Token:
        if not self.cur.is_kw(*names):
            self.error(f"expected {'/'.join(names)}, got {self._desc(self.cur)}")
        return self.advance()

    @staticmethod
    def _desc(tok: Token) -> str:
        if tok.type == T.EOF:
            return "end of input"
        return repr(tok.value if tok.value is not None else tok.type)

    def error(self, msg: str):
        tok = self.cur
        raise SyntaxException(f"line {tok.line}:{tok.col} {msg}")

    def name_token(self) -> str:
        """Identifier or any keyword used as a name (Cypher allows both;
        keywords keep their ORIGINAL case — `:User` must intern "User",
        not "user", even though USER is a keyword)."""
        if self.at(T.IDENT):
            return self.advance().value
        if self.cur.type == T.KEYWORD:
            tok = self.advance()
            return tok.raw if tok.raw is not None else tok.value.lower()
        self.error(f"expected a name, got {self._desc(self.cur)}")

    # --- statement dispatch -------------------------------------------------

    def parse_statement(self):
        explain = profile = False
        if self.accept_kw("EXPLAIN"):
            explain = True
        elif self.accept_kw("PROFILE"):
            profile = True

        node = self._dispatch()
        if isinstance(node, A.CypherQuery):
            node.explain = explain
            node.profile = profile
        elif explain or profile:
            self.error("EXPLAIN/PROFILE is only supported for Cypher queries")
        self.accept(";")
        if not self.at(T.EOF):
            self.error(f"unexpected input after statement: {self._desc(self.cur)}")
        return node

    def _dispatch(self):
        if self.at_kw("USE"):
            self.advance()
            self.accept_kw("DATABASE")
            return A.MultiDatabaseQuery("use", name=self.name_token())
        if self.at(T.IDENT) and self.cur.value.upper() in ("SUSPEND",
                                                          "RESUME"):
            # hot/cold tenants (reference: specs/hot-cold-databases.md)
            action = self.advance().value.lower()
            self.expect_kw("DATABASE")
            return A.MultiDatabaseQuery(action, name=self.name_token())
        if self.at(T.IDENT) and self.cur.value.upper() == "CLEAR" and \
                self.peek().type == T.IDENT and \
                self.peek().value.upper() == "TENANT":
            self.advance()
            return self.parse_tenant_profile("clear")
        if self.at(T.IDENT) and self.cur.value.upper() == "CLEAR" and \
                self._peek_is_profile():
            # CLEAR PROFILE FOR user (MemgraphCypher.g4:981)
            self.advance(); self.advance()
            self.expect_kw("FOR")
            return A.UserProfileQuery("clear", user=self.name_token())
        if self.at(T.IDENT) and self.cur.value.upper() == "UPDATE" and \
                self._peek_is_profile():
            # UPDATE PROFILE p LIMIT k v, ... (MemgraphCypher.g4:974)
            self.advance(); self.advance()
            name = self.name_token()
            limits = {}
            if self.accept_kw("LIMIT"):
                limits = self.parse_limit_list()
            return A.UserProfileQuery("update", name=name, limits=limits)
        if self.at(T.IDENT) and self.cur.value.upper() == "ALTER" and \
                self.peek().type == T.IDENT and \
                self.peek().value.upper() == "TENANT":
            self.advance()
            return self.parse_tenant_profile("alter")
        if self.at_kw("CREATE"):
            nxt = self.peek()
            if nxt.type == T.IDENT and nxt.value.upper() == "TENANT":
                self.advance()
                return self.parse_tenant_profile("create")
            if self._peek_is_profile():
                # CREATE PROFILE p [LIMIT k v, ...]
                self.advance(); self.advance()
                name = self.name_token()
                limits = {}
                if self.accept_kw("LIMIT"):
                    limits = self.parse_limit_list()
                return A.UserProfileQuery("create", name=name,
                                          limits=limits)
            if nxt.is_kw("DATABASE"):
                self.advance(); self.advance()
                return A.MultiDatabaseQuery("create", name=self.name_token())
            if nxt.type == T.IDENT and nxt.value.upper() in (
                    "KAFKA", "PULSAR", "FILE") and \
                    self.peek(2).is_kw("STREAM"):
                return self.parse_create_stream()
            if nxt.is_kw("STREAM"):
                return self.parse_create_stream()
            if nxt.is_kw("INDEX"):
                return self.parse_create_index()
            if nxt.is_kw("EDGE"):
                return self.parse_create_edge_index()
            if nxt.is_kw("CONSTRAINT"):
                return self.parse_constraint("create")
            if nxt.is_kw("SNAPSHOT"):
                self.advance(); self.advance()
                return A.SnapshotQuery("create")
            if nxt.is_kw("TRIGGER"):
                return self.parse_create_trigger()
            if nxt.is_kw("USER"):
                return self.parse_auth()
            if nxt.is_kw("ROLE"):
                self.advance(); self.advance()
                return A.AuthQuery("create_role", role=self.name_token())
            if nxt.type == "IDENT" and str(nxt.value).upper() == "ENUM":
                self.advance(); self.advance()
                name = self.name_token()
                if not (self.at(T.IDENT)
                        and self.cur.value.upper() == "VALUES"):
                    self.error("expected VALUES in CREATE ENUM")
                self.advance()
                self.expect("{")
                values = [self.name_token()]
                while self.accept(","):
                    values.append(self.name_token())
                self.expect("}")
                return A.EnumQuery("create", name, values)
            return self.parse_cypher_query()
        if self.at_kw("DROP"):
            nxt = self.peek()
            if nxt.type == T.IDENT and nxt.value.upper() == "TENANT":
                self.advance()
                return self.parse_tenant_profile("drop")
            if self._peek_is_profile():
                self.advance(); self.advance()
                return A.UserProfileQuery("drop", name=self.name_token())
            if nxt.is_kw("INDEX"):
                return self.parse_drop_index()
            if nxt.is_kw("EDGE"):
                return self.parse_drop_edge_index()
            if nxt.is_kw("CONSTRAINT"):
                return self.parse_constraint("drop")
            if nxt.is_kw("TRIGGER"):
                self.advance(); self.advance()
                return A.TriggerQuery("drop", name=self.name_token())
            if nxt.is_kw("REPLICA"):
                self.advance(); self.advance()
                return A.ReplicationQuery("drop", name=self.name_token())
            if nxt.is_kw("STREAM"):
                self.advance(); self.advance()
                return A.StreamQuery("drop", name=self.name_token())
            if nxt.is_kw("DATABASE"):
                self.advance(); self.advance()
                return A.MultiDatabaseQuery("drop", name=self.name_token())
            if nxt.is_kw("USER"):
                return self.parse_auth()
            if nxt.is_kw("ROLE"):
                self.advance(); self.advance()
                return A.AuthQuery("drop_role", role=self.name_token())
            self.error("unsupported DROP statement")
        if self.at_kw("SHOW"):
            return self.parse_show()
        if self.at_kw("BEGIN"):
            self.advance()
            return A.TransactionQuery("begin")
        if self.at_kw("COMMIT"):
            self.advance()
            return A.TransactionQuery("commit")
        if self.at_kw("ROLLBACK"):
            self.advance()
            return A.TransactionQuery("rollback")
        if self.at_kw("TERMINATE"):
            self.advance()
            self.expect_kw("TRANSACTIONS")
            ids = [self.parse_expression()]
            while self.accept(","):
                ids.append(self.parse_expression())
            return A.TerminateTransactionsQuery(ids)
        if self.at_kw("RECOVER"):
            self.advance()
            self.expect_kw("SNAPSHOT")
            if self.accept_kw("FROM"):
                # remote/explicit source: file path, http(s):// or s3://
                # (reference: storage.hpp:158-168 remote snapshot load)
                return A.SnapshotQuery("recover",
                                       source=self.expect(T.STRING).value)
            return A.SnapshotQuery("recover")
        if self.at_kw("DUMP"):
            self.advance()
            self.expect_kw("DATABASE")
            return A.DumpQuery()
        if self.at_kw("ANALYZE"):
            self.advance()
            self.expect_kw("GRAPH")
            labels = []
            if self.accept_kw("ON"):
                self.expect_kw("LABELS")
                if not self.accept("*"):   # * = all labels (grammar:636)
                    labels.append(self._colon_label())
                    while self.accept(","):
                        labels.append(self._colon_label())
            action = "analyze"
            if self.accept_kw("DELETE"):
                if self.at_kw("STATS") or (
                        self.at(T.IDENT)
                        and self.cur.value.upper() == "STATISTICS"):
                    self.advance()
                else:
                    self.error("expected STATISTICS after DELETE")
                action = "delete"
            return A.AnalyzeGraphQuery(action, labels)
        if self.at_kw("SET"):
            nxt = self.peek()
            if nxt.type == T.IDENT and nxt.value.upper() == "INSTANCE":
                self.advance(); self.advance()
                name = self.name_token()
                self.expect_kw("TO")
                self.expect_kw("MAIN")
                return A.CoordinatorQuery("set_main", name=name)
            if nxt.type == T.IDENT and nxt.value.upper() == "TENANT":
                self.advance()
                return self.parse_tenant_profile("assign")
            if self._peek_is_profile():
                # SET PROFILE FOR user TO profile
                self.advance(); self.advance()
                self.expect_kw("FOR")
                user = self.name_token()
                self.expect_kw("TO")
                return A.UserProfileQuery("assign", user=user,
                                          name=self.name_token())
            if nxt.is_kw("GLOBAL", "SESSION", "NEXT"):
                return self.parse_isolation_or_storage()
            if nxt.is_kw("STORAGE"):
                return self.parse_isolation_or_storage()
            if nxt.is_kw("REPLICATION"):
                return self.parse_set_replication_role()
            if nxt.is_kw("DATABASE"):
                self.advance(); self.advance()
                if not (self.at(T.IDENT)
                        and self.cur.value.upper() == "SETTING"):
                    self.error("expected SETTING after SET DATABASE")
                self.advance()
                name = self.expect(T.STRING).value
                self.expect_kw("TO")
                value = self.expect(T.STRING).value
                return A.SettingQuery("set", name, value)
            if nxt.is_kw("PASSWORD"):
                return self.parse_auth()
            if nxt.is_kw("ROLE"):
                self.advance(); self.advance()
                self.expect_kw("FOR")
                user = self.name_token()
                self.expect_kw("TO")
                return A.AuthQuery("set_role", user=user,
                                   role=self.name_token())
            return self.parse_cypher_query()
        if self.at(T.IDENT) and self.cur.value.upper() == "ALTER" and \
                self.peek().type == T.IDENT and \
                str(self.peek().value).upper() == "ENUM":
            self.advance(); self.advance()
            name = self.name_token()
            if not (self.at(T.IDENT) and self.cur.value.upper() == "ADD"):
                self.error("expected ADD VALUE in ALTER ENUM")
            self.advance()
            if not (self.at(T.IDENT) and self.cur.value.upper() == "VALUE"):
                self.error("expected VALUE after ADD")
            self.advance()
            return A.EnumQuery("add_value", name, [self.name_token()])
        if self.at_kw("GRANT") or self.at_kw("DENY"):
            action = self.advance().value.lower()
            first = self.name_token().upper()
            # fine-grained: GRANT <LEVEL> ON LABELS :a, :b | * TO name
            # (reference grammar: MemgraphCypher.g4 grantPrivilege with
            # READ/UPDATE/CREATE_DELETE/NOTHING ON LABELS/EDGE_TYPES)
            if first in ("READ", "UPDATE", "CREATE_DELETE", "NOTHING") \
                    and self.at_kw("ON"):
                self.advance()
                kind_tok = self.name_token().upper()
                if kind_tok not in ("LABELS", "EDGE_TYPES"):
                    self.error("expected LABELS or EDGE_TYPES")
                items = self.parse_fg_items()
                self.expect_kw("TO")
                target = self.name_token()
                level = "NOTHING" if action == "deny" else first
                return A.AuthQuery("grant_fine_grained", user=target,
                                   fg_kind=kind_tok.lower(),
                                   fg_items=items, fg_level=level)
            privs = [first]
            if privs == ["ALL"]:
                self.accept_kw("PRIVILEGES")
            while self.accept(","):
                privs.append(self.name_token().upper())
            self.expect_kw("TO")
            target = self.name_token()
            return A.AuthQuery(action, user=target, privileges=privs)
        if self.at_kw("REVOKE"):
            self.advance()
            first = self.name_token().upper()
            if first in ("READ", "UPDATE", "CREATE_DELETE", "NOTHING") \
                    and self.at_kw("ON"):
                self.advance()
                kind_tok = self.name_token().upper()
                if kind_tok not in ("LABELS", "EDGE_TYPES"):
                    self.error("expected LABELS or EDGE_TYPES")
                items = self.parse_fg_items()
                self.expect_kw("FROM")
                target = self.name_token()
                return A.AuthQuery("revoke_fine_grained", user=target,
                                   fg_kind=kind_tok.lower(), fg_items=items)
            privs = [first]
            if privs == ["ALL"]:
                self.accept_kw("PRIVILEGES")
            while self.accept(","):
                privs.append(self.name_token().upper())
            self.expect_kw("FROM")
            target = self.name_token()
            return A.AuthQuery("revoke", user=target, privileges=privs)
        if self.at_kw("REGISTER"):
            if self.peek().type == T.IDENT and \
                    self.peek().value.upper() == "INSTANCE":
                return self.parse_register_instance()
            return self.parse_register_replica()
        if self.at(T.IDENT) and self.cur.value.upper() == "UNREGISTER":
            self.advance()
            if not (self.at(T.IDENT)
                    and self.cur.value.upper() == "INSTANCE"):
                self.error("expected INSTANCE")
            self.advance()
            return A.CoordinatorQuery("unregister", name=self.name_token())
        if self.at_kw("START"):
            self.advance()
            if self.accept_kw("ALL"):
                self.expect_kw("STREAMS")
                return A.StreamQuery("start_all")
            self.expect_kw("STREAM")
            return A.StreamQuery("start", name=self.name_token())
        if self.at_kw("STOP"):
            self.advance()
            if self.accept_kw("ALL"):
                self.expect_kw("STREAMS")
                return A.StreamQuery("stop_all")
            self.expect_kw("STREAM")
            return A.StreamQuery("stop", name=self.name_token())
        if self.at_kw("CHECK"):
            self.advance()
            self.expect_kw("STREAM")
            return A.StreamQuery("check", name=self.name_token())
        if self.at_kw("FREE"):
            self.advance()
            self.expect_kw("MEMORY")
            return A.InfoQuery("free_memory")
        if self.at_kw("SESSION") and self.peek().type == T.IDENT and \
                self.peek().value.upper() == "TRACE":
            self.advance()
            self.advance()
            if self.accept_kw("ON"):
                return A.SessionTraceQuery(True)
            if self.at(T.IDENT) and self.cur.value.upper() == "OFF":
                self.advance()
                return A.SessionTraceQuery(False)
            self.error("expected ON or OFF after SESSION TRACE")
        if self.at_kw("ENABLE"):
            self.advance()
            self.expect_kw("TTL")
            period = None
            if self.accept_kw("EVERY"):
                period = self.expect(T.STRING).value
            return A.TtlQuery("enable", period)
        if self.at_kw("DISABLE"):
            self.advance()
            self.expect_kw("TTL")
            return A.TtlQuery("disable")
        return self.parse_cypher_query()

    def _colon_label(self) -> str:
        self.expect(":")
        return self.name_token()

    # --- DDL ---------------------------------------------------------------

    def parse_create_index(self) -> A.IndexQuery:
        self.expect_kw("CREATE")
        self.expect_kw("INDEX")
        self.expect_kw("ON")
        label = self._colon_label()
        props: list[str] = []
        if self.accept("("):
            props.append(self.name_token())
            while self.accept(","):
                props.append(self.name_token())
            self.expect(")")
        kind = "label_property" if props else "label"
        return A.IndexQuery("create", kind, label, props)

    def parse_drop_index(self) -> A.IndexQuery:
        self.expect_kw("DROP")
        self.expect_kw("INDEX")
        self.expect_kw("ON")
        label = self._colon_label()
        props: list[str] = []
        if self.accept("("):
            props.append(self.name_token())
            while self.accept(","):
                props.append(self.name_token())
            self.expect(")")
        kind = "label_property" if props else "label"
        return A.IndexQuery("drop", kind, label, props)

    def parse_create_edge_index(self) -> A.IndexQuery:
        self.expect_kw("CREATE")
        self.expect_kw("EDGE")
        self.expect_kw("INDEX")
        self.expect_kw("ON")
        self.expect(":")
        etype = self.name_token()
        return A.IndexQuery("create", "edge_type", None, [], etype)

    def parse_drop_edge_index(self) -> A.IndexQuery:
        self.expect_kw("DROP")
        self.expect_kw("EDGE")
        self.expect_kw("INDEX")
        self.expect_kw("ON")
        self.expect(":")
        etype = self.name_token()
        return A.IndexQuery("drop", "edge_type", None, [], etype)

    def parse_constraint(self, action: str) -> A.ConstraintQuery:
        self.advance()  # CREATE/DROP
        self.expect_kw("CONSTRAINT")
        self.expect_kw("ON")
        self.expect("(")
        var = self.name_token()
        self.expect(":")
        label = self.name_token()
        self.expect(")")
        self.expect_kw("ASSERT")
        if self.accept_kw("EXISTS"):
            self.expect("(")
            self._qualified_prop(var)
            prop = self._last_prop
            self.expect(")")
            return A.ConstraintQuery(action, "exists", label, [prop])
        # n.a IS UNIQUE / n.a, n.b IS UNIQUE / n.a IS TYPED STRING
        props = [self._qualified_prop(var)]
        while self.accept(","):
            props.append(self._qualified_prop(var))
        self.expect_kw("IS")
        if self.accept_kw("UNIQUE"):
            return A.ConstraintQuery(action, "unique", label, props)
        self.expect_kw("TYPED")
        type_name = self.name_token()
        return A.ConstraintQuery(action, "type", label, props, type_name)

    _last_prop: str = ""

    def _qualified_prop(self, var: str) -> str:
        name = self.name_token()
        if name != var:
            self.error(f"unknown variable {name!r} in constraint")
        self.expect(".")
        self._last_prop = self.name_token()
        return self._last_prop

    def parse_show(self):
        self.expect_kw("SHOW")
        if self.accept_kw("INDEX"):
            self.expect_kw("INFO")
            return A.InfoQuery("index")
        if self.accept_kw("CONSTRAINT"):
            self.expect_kw("INFO")
            return A.InfoQuery("constraint")
        if self.accept_kw("STORAGE"):
            self.expect_kw("INFO")
            return A.InfoQuery("storage")
        if self.accept_kw("BUILD"):
            self.expect_kw("INFO")
            return A.InfoQuery("build")
        if self.accept_kw("METRICS"):
            self.accept_kw("INFO")
            return A.InfoQuery("metrics")
        if self.accept_kw("QUERY"):
            # SHOW QUERY STATS: bounded top-K fingerprint
            # statistics from observability/stats.py
            self.expect_kw("STATS")
            return A.InfoQuery("query_stats")
        if self.at(T.IDENT) and self.cur.value.upper() == "LICENSE":
            self.advance()
            self.expect_kw("INFO")
            return A.InfoQuery("license")
        if self.at(T.IDENT) and self.cur.value.upper() == "ACTIVE":
            # SHOW ACTIVE USERS INFO (reference: MemgraphCypher.g4:1032
            # systemInfoQuery activeUsersInfo)
            self.advance()
            if not (self.at(T.IDENT) and self.cur.value.upper() == "USERS"):
                self.error("expected USERS after SHOW ACTIVE")
            self.advance()
            self.expect_kw("INFO")
            return A.InfoQuery("active_users")
        if self.accept_kw("TRANSACTIONS"):
            return A.ShowTransactionsQuery()
        if self.accept_kw("SNAPSHOT"):  # SHOW SNAPSHOTS
            return A.SnapshotQuery("show")
        if self.accept_kw("TRIGGERS"):
            return A.TriggerQuery("show")
        if self.accept_kw("DATABASES"):
            return A.MultiDatabaseQuery("show")
        if self.accept_kw("DATABASE"):
            if self.at(T.IDENT) and self.cur.value.upper() == "SETTINGS":
                self.advance()
                return A.SettingQuery("show_all")
            if self.at(T.IDENT) and self.cur.value.upper() == "SETTING":
                self.advance()
                return A.SettingQuery("show_one",
                                      self.expect(T.STRING).value)
            return A.InfoQuery("database")
        if self.accept_kw("SCHEMA"):
            self.expect_kw("INFO")
            return A.InfoQuery("schema")
        if self.accept_kw("REPLICAS"):
            return A.ReplicationQuery("show_replicas")
        if self.accept_kw("REPLICATION"):
            self.expect_kw("ROLE")
            return A.ReplicationQuery("show_role")
        if self.accept_kw("STREAMS"):
            return A.StreamQuery("show")
        if self.at(T.IDENT) and self.cur.value.upper() == "USERS":
            self.advance()
            if self.at_kw("FOR"):
                # SHOW USERS FOR PROFILE p (MemgraphCypher.g4:979)
                self.advance()
                if not self._at_profile_word():
                    self.error("expected PROFILE after SHOW USERS FOR")
                self.advance()
                return A.UserProfileQuery("users_for",
                                          name=self.name_token())
            return A.AuthQuery("show_users")
        if self._at_profile_word():
            plural = self.cur.value.upper() == "PROFILES"
            self.advance()
            if plural:
                return A.UserProfileQuery("show")
            if self.accept_kw("FOR"):
                return A.UserProfileQuery("show_for",
                                          user=self.name_token())
            return A.UserProfileQuery("show", name=self.name_token())
        if self.at(T.IDENT) and self.cur.value.upper() == "TENANT":
            self.advance()
            if not (self.at_kw("PROFILE") or (
                    self.at(T.IDENT) and self.cur.value.upper()
                    in ("PROFILE", "PROFILES"))):
                self.error("expected PROFILE(S) after SHOW TENANT")
            plural = self.advance().value.upper() == "PROFILES"
            name = None if plural else self.name_token()
            return A.TenantProfileQuery("show", name=name)
        if self.at(T.IDENT) and self.cur.value.upper() == "CURRENT":
            self.advance()
            if self.at_kw("USER") or (self.at(T.IDENT)
                                      and self.cur.value.upper() == "USER"):
                self.advance()
                return A.AuthQuery("show_current_user")
            self.error("expected USER after SHOW CURRENT")
        if self.at(T.IDENT) and self.cur.value.upper() == "ROLES":
            self.advance()
            return A.AuthQuery("show_roles")
        if self.accept_kw("PRIVILEGES"):
            self.expect_kw("FOR")
            return A.AuthQuery("show_privileges", user=self.name_token())
        if self.accept_kw("VERSION"):
            return A.InfoQuery("version")
        if self.at(T.IDENT) and self.cur.value.upper() == "ENUMS":
            self.advance()
            return A.EnumQuery("show")
        if self.at(T.IDENT) and self.cur.value.upper() == "INSTANCES":
            self.advance()
            return A.CoordinatorQuery("show")
        self.error("unsupported SHOW statement")

    def parse_register_instance(self) -> A.CoordinatorQuery:
        self.expect_kw("REGISTER")
        self.advance()  # INSTANCE
        name = self.name_token()
        self.expect_kw("ON")
        mgmt = self.expect(T.STRING).value
        self.expect_kw("WITH")
        repl = self.expect(T.STRING).value
        bolt = None
        # optional bolt endpoint so coordinators can serve ROUTE tables
        # (reference: REGISTER INSTANCE ... WITH CONFIG {"bolt_server": ...})
        if self.at(T.IDENT) and self.cur.value.upper() == "BOLT":
            self.advance()
            bolt = self.expect(T.STRING).value
        return A.CoordinatorQuery("register", name=name, mgmt_address=mgmt,
                                  replication_address=repl,
                                  bolt_address=bolt)

    def parse_create_stream(self) -> A.StreamQuery:
        self.expect_kw("CREATE")
        kind = "kafka"
        if self.at(T.IDENT) and self.cur.value.upper() in (
                "KAFKA", "PULSAR", "FILE"):
            kind = self.advance().value.lower()
        self.expect_kw("STREAM")
        name = self.name_token()
        q = A.StreamQuery("create", name=name, kind=kind)
        while True:
            if self.accept_kw("TOPICS"):
                if self.at(T.STRING):
                    q.topics.append(self.advance().value)
                else:
                    q.topics.append(self.name_token())
                while self.accept(","):
                    if self.at(T.STRING):
                        q.topics.append(self.advance().value)
                    else:
                        q.topics.append(self.name_token())
                continue
            if self.accept_kw("TRANSFORM"):
                parts = [self.name_token()]
                while self.accept("."):
                    parts.append(self.name_token())
                q.transform = ".".join(parts)
                continue
            if self.accept_kw("BATCH_SIZE"):
                q.batch_size = self.expect(T.INT).value
                continue
            if self.accept_kw("BATCH_INTERVAL"):
                q.batch_interval_ms = self.expect(T.INT).value
                continue
            if self.accept_kw("BOOTSTRAP_SERVERS"):
                q.bootstrap_servers = self.expect(T.STRING).value
                continue
            if self.accept_kw("SERVICE_URL"):
                q.service_url = self.expect(T.STRING).value
                continue
            if self.accept_kw("CONSUMER_GROUP"):
                q.consumer_group = self.expect(T.STRING).value
                continue
            break
        if not q.topics or not q.transform:
            self.error("CREATE STREAM requires TOPICS and TRANSFORM")
        return q

    def parse_set_replication_role(self) -> A.ReplicationQuery:
        self.expect_kw("SET")
        self.expect_kw("REPLICATION")
        self.expect_kw("ROLE")
        self.expect_kw("TO")
        if self.accept_kw("MAIN"):
            return A.ReplicationQuery("set_role_main")
        self.expect_kw("REPLICA")
        port = 10000
        if self.accept_kw("WITH"):
            self.expect_kw("PORT")
            port = self.expect(T.INT).value
        return A.ReplicationQuery("set_role_replica", port=port)

    def parse_register_replica(self) -> A.ReplicationQuery:
        self.expect_kw("REGISTER")
        self.expect_kw("REPLICA")
        name = self.name_token()
        mode = "SYNC"
        if self.accept_kw("SYNC"):
            mode = "SYNC"
        elif self.accept_kw("ASYNC"):
            mode = "ASYNC"
        elif self.accept_kw("STRICT_SYNC"):
            mode = "STRICT_SYNC"
        self.expect_kw("TO")
        addr = self.expect(T.STRING).value
        return A.ReplicationQuery("register", name=name, mode=mode,
                                  address=addr)

    def parse_isolation_or_storage(self):
        self.expect_kw("SET")
        if self.accept_kw("STORAGE"):
            self.expect_kw("MODE")
            if self.accept_kw("IN_MEMORY_ANALYTICAL"):
                return A.StorageModeQuery("IN_MEMORY_ANALYTICAL")
            tok = self.advance()
            mode = str(tok.value).upper()
            if mode == "ANALYTICAL":
                mode = "IN_MEMORY_ANALYTICAL"
            elif mode == "TRANSACTIONAL":
                mode = "IN_MEMORY_TRANSACTIONAL"
            return A.StorageModeQuery(mode)
        scope_tok = self.expect_kw("GLOBAL", "SESSION", "NEXT")
        scope = scope_tok.value.lower()
        self.expect_kw("TRANSACTION")
        self.expect_kw("ISOLATION")
        self.expect_kw("LEVEL")
        if self.accept_kw("SNAPSHOT"):
            self.expect_kw("ISOLATION")
            return A.IsolationLevelQuery("SNAPSHOT_ISOLATION", scope)
        self.expect_kw("READ")
        if self.accept_kw("COMMITTED"):
            return A.IsolationLevelQuery("READ_COMMITTED", scope)
        self.expect_kw("UNCOMMITTED")
        return A.IsolationLevelQuery("READ_UNCOMMITTED", scope)

    def parse_create_trigger(self) -> A.TriggerQuery:
        self.expect_kw("CREATE")
        self.expect_kw("TRIGGER")
        name = self.name_token()
        event = None
        if self.accept_kw("ON"):
            parts = []
            while self.cur.type == T.KEYWORD and self.cur.value in (
                    "CREATE", "UPDATE", "DELETE", "VERTICES", "EDGES"):
                parts.append(self.advance().value)
            event = " ".join(parts) if parts else None
        phase_tok = self.expect_kw("BEFORE", "AFTER")
        self.expect_kw("COMMIT")
        self.expect_kw("EXECUTE")
        # statement: rest of the input until EOF/';'
        start = self.cur.pos
        # capture raw text from token stream positions
        depth = 0
        last = self.cur
        while not self.at(T.EOF) and not (self.at(";") and depth == 0):
            last = self.advance()
        raw_end = last.pos + (len(str(last.value)) if last.value else 1)
        statement = self._source_slice(start)
        return A.TriggerQuery("create", name=name, event=event,
                              phase=phase_tok.value, statement=statement)

    _source: str = ""

    def _source_slice(self, start: int) -> str:
        # Parser doesn't retain source by default; tokenizer pos is enough
        # only if the caller provided it. parse() wires it below.
        return self._source[start:].rstrip("; \n\t") if self._source else ""

    def parse_fg_items(self) -> list:
        if self.accept("*"):
            return ["*"]
        items = []
        self.expect(":")
        items.append(self.name_token())
        while self.accept(","):
            self.expect(":")
            items.append(self.name_token())
        return items

    def parse_auth(self) -> A.AuthQuery:
        first = self.advance()  # CREATE/DROP/SET
        if first.value == "SET":
            self.expect_kw("PASSWORD")
            self.expect_kw("TO")
            pw = self.parse_expression()
            return A.AuthQuery("set_password", password=pw)
        self.expect_kw("USER")
        user = self.name_token()
        if first.value == "DROP":
            return A.AuthQuery("drop_user", user=user)
        pw = None
        # reference grammar: CREATE USER user ( IDENTIFIED BY literal )?
        # (MemgraphCypher.g4:498)
        if self.at(T.IDENT) and self.cur.value.upper() == "IDENTIFIED":
            self.advance()
            self.expect_kw("BY")
            pw = self.parse_expression()
        elif self.accept_kw("PASSWORD"):
            pw = self.parse_expression()
        return A.AuthQuery("create_user", user=user, password=pw)

    # --- Cypher query -------------------------------------------------------

    def parse_cypher_query(self) -> A.CypherQuery:
        commit_frequency = self.parse_periodic_commit()
        first = self.parse_single_query()
        unions = []
        while self.at_kw("UNION"):
            self.advance()
            union_all = bool(self.accept_kw("ALL"))
            unions.append((union_all, self.parse_single_query()))
        mem = None
        if self.at_kw("QUERY"):
            # trailing `QUERY MEMORY LIMIT n MB|KB` / `QUERY MEMORY
            # UNLIMITED` (reference grammar Cypher.g4:134-136)
            self.advance()
            mem = self.parse_memory_limit()
        if commit_frequency is not None and unions:
            self.error("periodic commit is not allowed with UNION")
        return A.CypherQuery(first, unions, memory_limit=mem,
                             commit_frequency=commit_frequency)

    def parse_periodic_commit(self):
        """Leading `USING PERIODIC COMMIT n` pre-query directive
        (reference: MemgraphCypher.g4:405,413). Other USING directives
        (INDEX / HOPS LIMIT / PARALLEL EXECUTION) attach to MATCH and are
        parsed there; only PERIODIC COMMIT legally precedes the first
        clause (`USING PERIODIC COMMIT 500 LOAD CSV ... CREATE ...`)."""
        if not self.at_kw("USING"):
            return None
        self.advance()
        self.expect_kw("PERIODIC")
        self.expect_kw("COMMIT")
        if self.at(T.PARAM):
            freq = A.Parameter(self.advance().value)
        else:
            freq = self.expect(T.INT).value
            if freq < 1:
                self.error("periodic commit frequency must be >= 1")
        return freq

    def parse_tenant_profile(self, action: str) -> "A.TenantProfileQuery":
        """TENANT PROFILE grammar (reference MemgraphCypher.g4:995-1001):
        CREATE TENANT PROFILE p LIMIT k v[, ...] / ALTER ... SET ... /
        DROP TENANT PROFILE p / SET TENANT PROFILE ON DATABASE db TO p /
        CLEAR TENANT PROFILE ON DATABASE db. Caller consumed the leading
        verb; cursor sits at TENANT."""
        self.advance()                  # TENANT
        if not (self.at_kw("PROFILE") or (
                self.at(T.IDENT)
                and self.cur.value.upper() == "PROFILE")):
            self.error("expected PROFILE after TENANT")
        self.advance()
        if action == "assign":
            self.expect_kw("ON")
            self.expect_kw("DATABASE")
            db = self.name_token()
            self.expect_kw("TO")
            return A.TenantProfileQuery("assign", name=self.name_token(),
                                        database=db)
        if action == "clear":
            self.expect_kw("ON")
            self.expect_kw("DATABASE")
            return A.TenantProfileQuery("clear",
                                        database=self.name_token())
        name = self.name_token()
        if action == "drop":
            return A.TenantProfileQuery("drop", name=name)
        if action == "create":
            self.expect_kw("LIMIT")
        else:                           # alter
            self.expect_kw("SET")
        return A.TenantProfileQuery(action, name=name,
                                    limits=self.parse_limit_list())

    def parse_limit_list(self) -> dict:
        """k v pairs: `memory_limit 100MB, ...`; UNLIMITED -> None."""
        limits: dict = {}
        while True:
            key = self.name_token().lower()
            if self.accept_kw("UNLIMITED"):
                limits[key] = None
            else:
                amount = self.expect(T.INT).value
                if self.at(T.IDENT) and self.cur.value.upper() in ("MB",
                                                                   "KB"):
                    unit = self.advance().value.upper()
                    amount *= 1024 * 1024 if unit == "MB" else 1024
                limits[key] = amount
            if not self.accept(","):
                return limits

    def parse_memory_limit(self) -> "Optional[int]":
        self.expect_kw("MEMORY")
        if self.accept_kw("UNLIMITED"):
            return None
        self.expect_kw("LIMIT")
        amount = self.expect(T.INT).value
        if amount < 1:
            self.error("memory limit must be positive")
        unit = self.name_token().upper()
        if unit == "MB":
            return amount * 1024 * 1024
        if unit == "KB":
            return amount * 1024
        self.error("expected MB or KB after the memory limit")

    def parse_single_query(self) -> A.SingleQuery:
        clauses: list[A.Clause] = []
        while True:
            clause = self.try_parse_clause()
            if clause is None:
                break
            clauses.append(clause)
        if not clauses:
            self.error("expected a query clause")
        return A.SingleQuery(clauses)

    def try_parse_clause(self) -> Optional[A.Clause]:
        if self.at_kw("MATCH"):
            return self.parse_match(optional=False)
        if self.at_kw("OPTIONAL"):
            self.advance()
            self.expect_kw("MATCH")
            return self.parse_match(optional=True, consumed=True)
        if self.at_kw("CREATE"):
            self.advance()
            return A.Create(self.parse_pattern_list())
        if self.at_kw("MERGE"):
            return self.parse_merge()
        if self.at_kw("SET"):
            self.advance()
            return A.SetClause(self.parse_set_items())
        if self.at_kw("REMOVE"):
            return self.parse_remove()
        if self.at_kw("DELETE"):
            self.advance()
            return self.parse_delete(detach=False)
        if self.at_kw("DETACH"):
            self.advance()
            self.expect_kw("DELETE")
            return self.parse_delete(detach=True)
        if self.at_kw("RETURN"):
            self.advance()
            return A.Return(self.parse_return_body())
        if self.at_kw("WITH"):
            self.advance()
            body = self.parse_return_body()
            where = None
            if self.accept_kw("WHERE"):
                where = self.parse_expression()
            return A.With(body, where)
        if self.at_kw("UNWIND"):
            self.advance()
            expr = self.parse_expression()
            self.expect_kw("AS")
            var = self.name_token()
            return A.Unwind(expr, var)
        if self.at_kw("CALL"):
            return self.parse_call()
        if self.at_kw("FOREACH"):
            return self.parse_foreach()
        if self.at_kw("LOAD"):
            return self.parse_load()
        return None

    def parse_load(self):
        self.expect_kw("LOAD")
        if self.accept_kw("CSV"):
            self.expect_kw("FROM")
            file_expr = self.parse_expression()
            with_header = False
            if self.accept_kw("WITH"):
                self.expect_kw("HEADER")
                with_header = True
            elif self.accept_kw("NO"):
                self.expect_kw("HEADER")
            ignore_bad = False
            if self.at(T.IDENT) and self.cur.value.upper() == "IGNORE":
                self.advance()
                if self.at(T.IDENT) and self.cur.value.upper() == "BAD":
                    self.advance()
                ignore_bad = True
            delimiter = quote = None
            while True:
                if self.accept_kw("FIELDTERMINATOR"):
                    delimiter = self.parse_expression()
                    continue
                if self.at(T.IDENT) and self.cur.value.upper() == "DELIMITER":
                    self.advance()
                    delimiter = self.parse_expression()
                    continue
                if self.at(T.IDENT) and self.cur.value.upper() == "QUOTE":
                    self.advance()
                    quote = self.parse_expression()
                    continue
                break
            self.expect_kw("AS")
            var = self.name_token()
            return A.LoadCsv(file_expr, var, with_header, ignore_bad,
                             delimiter, quote)
        kind = self.name_token().upper()
        if kind == "JSONL":
            self.expect_kw("FROM")
            file_expr = self.parse_expression()
            self.expect_kw("AS")
            return A.LoadJsonl(file_expr, self.name_token())
        if kind == "PARQUET":
            self.expect_kw("FROM")
            file_expr = self.parse_expression()
            self.expect_kw("AS")
            return A.LoadParquet(file_expr, self.name_token())
        self.error(f"unsupported LOAD source {kind}")

    def parse_match(self, optional: bool, consumed=False) -> A.Match:
        if not consumed:
            self.expect_kw("MATCH")
        patterns = self.parse_pattern_list()
        index_hints = []
        hops_limit = None
        parallel = False
        while self.at_kw("USING"):
            self.advance()
            if self.accept_kw("PARALLEL"):
                self.expect_kw("EXECUTION")
                parallel = True
            elif self.accept_kw("INDEX"):
                var = self.name_token()
                self.expect(":")
                label = self.name_token()
                props = []
                if self.accept("("):
                    props.append(self.name_token())
                    while self.accept(","):
                        props.append(self.name_token())
                    self.expect(")")
                index_hints.append(A.IndexHint(var, label, props))
            elif self.accept_kw("HOPS"):
                self.expect_kw("LIMIT")
                hops_limit = self.expect(T.INT).value
            else:
                self.error("expected INDEX, HOPS LIMIT or PARALLEL "
                           "EXECUTION after USING")
        where = None
        if self.accept_kw("WHERE"):
            where = self.parse_expression()
        return A.Match(patterns, where, optional, index_hints, hops_limit,
                       parallel)

    def parse_merge(self) -> A.Merge:
        self.expect_kw("MERGE")
        pattern = self.parse_pattern()
        on_create, on_match = [], []
        while self.at_kw("ON"):
            self.advance()
            which = self.expect_kw("CREATE", "MATCH").value
            self.expect_kw("SET")
            items = self.parse_set_items()
            (on_create if which == "CREATE" else on_match).extend(items)
        return A.Merge(pattern, on_create, on_match)

    def parse_set_items(self) -> list[A.SetItem]:
        items = [self.parse_set_item()]
        while self.accept(","):
            items.append(self.parse_set_item())
        return items

    def parse_set_item(self) -> A.SetItem:
        target = self.parse_expression(no_top_equals=True)
        if self.accept("="):
            value = self.parse_expression()
            if isinstance(target, A.PropertyLookup):
                return A.SetItem("prop", target, value)
            if isinstance(target, A.Identifier):
                return A.SetItem("var_assign", target, value)
            self.error("invalid SET target")
        if self.accept("+="):
            value = self.parse_expression()
            return A.SetItem("var_update", target, value)
        if isinstance(target, A.LabelsTest):
            return A.SetItem("label", target.expr, target.labels)
        self.error("invalid SET item")

    def parse_remove(self) -> A.Remove:
        self.expect_kw("REMOVE")
        items = [self.parse_remove_item()]
        while self.accept(","):
            items.append(self.parse_remove_item())
        return A.Remove(items)

    def parse_remove_item(self) -> A.RemoveItem:
        expr = self.parse_expression(no_top_equals=True)
        if isinstance(expr, A.PropertyLookup):
            return A.RemoveItem("prop", expr)
        if isinstance(expr, A.LabelsTest):
            return A.RemoveItem("label", expr.expr, expr.labels)
        self.error("invalid REMOVE item")

    def parse_delete(self, detach: bool) -> A.Delete:
        exprs = [self.parse_expression()]
        while self.accept(","):
            exprs.append(self.parse_expression())
        return A.Delete(exprs, detach)

    def parse_return_body(self) -> A.ReturnBody:
        distinct = bool(self.accept_kw("DISTINCT"))
        star = False
        items: list[tuple[A.Expr, Optional[str]]] = []
        if self.accept("*"):
            star = True
            while self.accept(","):
                items.append(self.parse_return_item())
        else:
            items.append(self.parse_return_item())
            while self.accept(","):
                items.append(self.parse_return_item())
        order_by: list[A.SortItem] = []
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            order_by.append(self.parse_sort_item())
            while self.accept(","):
                order_by.append(self.parse_sort_item())
        skip = limit = None
        if self.accept_kw("SKIP"):
            skip = self.parse_expression()
        if self.accept_kw("LIMIT"):
            limit = self.parse_expression()
        return A.ReturnBody(distinct, items, star, order_by, skip, limit)

    def parse_return_item(self):
        start = self.cur.pos
        expr = self.parse_expression()
        end = self.cur.pos  # first token NOT part of the expression
        if self.accept_kw("AS"):
            return (expr, self.name_token(), None)
        # unaliased item: the column name is the VERBATIM source text of
        # the expression, case and spacing included (openCypher TCK
        # ColumnNameAcceptance "Keeping used expression")
        verbatim = (self._source[start:end].strip()
                    if self._source is not None else None)
        return (expr, None, verbatim)

    def parse_sort_item(self) -> A.SortItem:
        expr = self.parse_expression()
        asc = True
        if self.accept_kw("ASC", "ASCENDING"):
            asc = True
        elif self.accept_kw("DESC", "DESCENDING"):
            asc = False
        return A.SortItem(expr, asc)

    def parse_call(self):
        self.expect_kw("CALL")
        if self.at("{"):
            self.advance()
            sub = self.parse_single_query()
            self.expect("}")
            batch_rows = None
            if self.accept_kw("IN"):
                self.expect_kw("TRANSACTIONS")
                self.expect_kw("OF")  # reference grammar: OF n ROWS required
                batch_rows = self.expect(T.INT).value
                if batch_rows < 1:
                    self.error("IN TRANSACTIONS batch size must be >= 1")
                if not (self.at(T.IDENT)
                        and self.cur.value.upper() == "ROWS") \
                        and not self.at_kw("ROW"):
                    self.error("expected ROWS after the batch size")
                self.advance()
            return A.CallSubquery(sub, batch_rows)
        parts = [self.name_token()]
        while self.accept("."):
            parts.append(self.name_token())
        name = ".".join(parts)
        # args=None (no parens) is distinct from args=[] (empty parens):
        # standalone CALL without parens takes arguments implicitly from
        # query parameters; in-query CALL requires explicit parens
        # (TCK ProcedureCallAcceptance: InvalidArgumentPassingMode)
        args: Optional[list[A.Expr]] = None
        if self.accept("("):
            args = []
            if not self.at(")"):
                args.append(self.parse_expression())
                while self.accept(","):
                    args.append(self.parse_expression())
            self.expect(")")
        mem_limit = None
        if self.at_kw("PROCEDURE"):
            # CALL proc() PROCEDURE MEMORY LIMIT n MB|KB (Cypher.g4:138)
            self.advance()
            mem_limit = self.parse_memory_limit()
        yields: list[tuple[str, Optional[str]]] = []
        yield_star = False
        yield_dash = False
        where = None
        if self.accept_kw("YIELD"):
            if self.accept("*"):
                yield_star = True
            elif self.accept("-"):
                yield_dash = True  # explicitly yield nothing
            else:
                yields.append(self.parse_yield_item())
                while self.accept(","):
                    yields.append(self.parse_yield_item())
            if self.accept_kw("WHERE"):
                where = self.parse_expression()
        return A.CallProcedure(name, args, yields, yield_star, where,
                               yield_dash)

    def parse_yield_item(self):
        field = self.name_token()
        alias = None
        if self.accept_kw("AS"):
            alias = self.name_token()
        return (field, alias)

    def parse_foreach(self) -> A.Foreach:
        self.expect_kw("FOREACH")
        self.expect("(")
        var = self.name_token()
        self.expect_kw("IN")
        expr = self.parse_expression()
        self.expect("|")
        updates: list[A.Clause] = []
        while not self.at(")"):
            clause = self.try_parse_clause()
            if clause is None:
                self.error("expected an update clause in FOREACH")
            updates.append(clause)
        self.expect(")")
        return A.Foreach(var, expr, updates)

    # --- patterns -----------------------------------------------------------

    def parse_pattern_list(self) -> list[A.Pattern]:
        patterns = [self.parse_pattern()]
        while self.accept(","):
            patterns.append(self.parse_pattern())
        return patterns

    def parse_pattern(self) -> A.Pattern:
        variable = None
        if self.at(T.IDENT) and self.peek().type == "=":
            variable = self.advance().value
            self.advance()  # '='
        elements = [self.parse_node_pattern()]
        while self.at("-") or self.at("<-") or self.at("--") or self.at("<"):
            edge = self.parse_edge_pattern()
            node = self.parse_node_pattern()
            elements.append(edge)
            elements.append(node)
        return A.Pattern(variable, elements)

    def parse_node_pattern(self) -> A.NodePattern:
        self.expect("(")
        variable = None
        labels: list[str] = []
        props = None
        if self.at(T.IDENT) or (self.cur.type == T.KEYWORD
                                and not self.at(")")
                                and self.peek().type in (":", ")", "{")):
            variable = self.name_token()
        while self.accept(":"):
            labels.append(self.name_token())
        if self.at("{") or self.at(T.PARAM):
            props = self.parse_map_or_param()
        self.expect(")")
        return A.NodePattern(variable, labels, props)

    def parse_edge_pattern(self) -> A.EdgePattern:
        # arrows: -[..]-> | <-[..]- | -[..]- | --> | <-- | --
        direction = "both"
        if self.accept("<-"):
            direction = "in"
            left_consumed = True
        elif self.accept("<"):
            self.expect("-")
            direction = "in"
        elif self.accept("--"):
            # bare '--' or '-->' handled below
            if self.accept(">"):
                return A.EdgePattern(None, [], "out")
            return A.EdgePattern(None, [], "both")
        else:
            self.expect("-")

        variable = None
        types: list[str] = []
        props = None
        var_length = False
        min_hops = max_hops = None
        algo = None
        weight_lambda = None
        filter_lambda = None
        total_weight = None
        if self.accept("["):
            if self.at(T.IDENT) and self.peek().type in (":", "]", "*", "{"):
                variable = self.advance().value
            if self.accept(":"):
                types.append(self.name_token())
                while self.accept("|"):
                    self.accept(":")
                    types.append(self.name_token())
            if self.accept("*"):
                var_length = True
                from .lexer import T as TT
                if self.at(TT.IDENT) and self.cur.value.upper() in (
                        "BFS", "WSHORTEST", "ALLSHORTEST", "KSHORTEST"):
                    algo = self.advance().value.lower()
                if self.at(TT.INT):
                    min_hops = A.Literal(self.advance().value)
                    if self.accept(".."):
                        if self.at(TT.INT):
                            max_hops = A.Literal(self.advance().value)
                    else:
                        max_hops = min_hops
                elif self.accept(".."):
                    if self.at(TT.INT):
                        max_hops = A.Literal(self.advance().value)
                elif self.at(T.FLOAT):
                    # "*1.5" is invalid; but "*1..2" lexes as INT '..' INT
                    self.error("invalid variable-length bounds")
                # lambdas: weight first for WSHORTEST/ALLSHORTEST, then an
                # optional filter lambda (reference: MemgraphCypher grammar)
                if algo in ("wshortest", "allshortest", "kshortest") \
                        and self.at("("):
                    weight_lambda = self._parse_lambda()
                    if self.at(T.IDENT) and self.peek().type in ("]", "("):
                        total_weight = self.advance().value
                if self.at("("):
                    filter_lambda = self._parse_lambda()
            if self.at("{") or self.at(T.PARAM):
                props = self.parse_map_or_param()
            self.expect("]")
        # closing arrow
        if direction == "in":
            if self.accept("->"):   # bare '<-->' lexes as '<-' + '->'
                direction = "both"
            else:
                self.expect("-")
                if self.accept(">"):
                    direction = "both"  # <-[..]-> treated as undirected
        else:
            if self.accept("->"):
                direction = "out"
            elif self.accept("-"):
                if self.accept(">"):
                    direction = "out"
                else:
                    direction = "both"
            elif self.accept(">"):
                direction = "out"
            else:
                self.error("malformed relationship pattern")
        return A.EdgePattern(variable, types, direction, props, var_length,
                             min_hops, max_hops, algo, weight_lambda,
                             filter_lambda, total_weight)

    def _parse_lambda(self) -> A.Lambda:
        self.expect("(")
        edge_var = self.name_token()
        self.expect(",")
        node_var = self.name_token()
        self.expect("|")
        expr = self.parse_expression()
        self.expect(")")
        return A.Lambda(edge_var, node_var, expr)

    def parse_map_or_param(self):
        if self.at(T.PARAM):
            return A.Parameter(self.advance().value)
        self.expect("{")
        out: dict[str, A.Expr] = {}
        if not self.at("}"):
            while True:
                key = self.name_token() if not self.at(T.STRING) else self.advance().value
                self.expect(":")
                out[key] = self.parse_expression()
                if not self.accept(","):
                    break
        self.expect("}")
        return out

    # --- expressions (precedence climbing) ---------------------------------

    def parse_expression(self, no_top_equals: bool = False) -> A.Expr:
        if no_top_equals:
            return self._parse_or_stop_equals()
        return self.parse_or()

    def _parse_or_stop_equals(self) -> A.Expr:
        # For SET items: parse a primary+postfix chain only (target position)
        return self.parse_postfix(self.parse_primary())

    def parse_or(self) -> A.Expr:
        left = self.parse_xor()
        while self.at_kw("OR"):
            self.advance()
            left = A.Binary("OR", left, self.parse_xor())
        return left

    def parse_xor(self) -> A.Expr:
        left = self.parse_and()
        while self.at_kw("XOR"):
            self.advance()
            left = A.Binary("XOR", left, self.parse_and())
        return left

    def parse_and(self) -> A.Expr:
        left = self.parse_not()
        while self.at_kw("AND"):
            self.advance()
            left = A.Binary("AND", left, self.parse_not())
        return left

    def parse_not(self) -> A.Expr:
        if self.accept_kw("NOT"):
            return A.Unary("NOT", self.parse_not())
        return self.parse_comparison()

    _CMP = ("=", "<>", "<", ">", "<=", ">=")

    def parse_comparison(self) -> A.Expr:
        left = self.parse_additive()
        # chained comparisons: a < b < c → (a<b) AND (b<c)
        comparisons = []
        while self.cur.type in self._CMP:
            op = self.advance().type
            right = self.parse_additive()
            comparisons.append((op, right))
        if not comparisons:
            return self._parse_special_predicates(left)
        result = None
        prev = left
        for op, right in comparisons:
            cmp_node = A.Binary(op, prev, right)
            result = cmp_node if result is None else A.Binary("AND", result,
                                                              cmp_node)
            prev = right
        return result

    def _parse_special_predicates(self, left: A.Expr) -> A.Expr:
        while True:
            if self.at_kw("IS"):
                save = self.i
                self.advance()
                if self.accept_kw("NULL"):
                    left = A.IsNull(left, negated=False)
                    continue
                if self.accept_kw("NOT"):
                    if self.accept_kw("NULL"):
                        left = A.IsNull(left, negated=True)
                        continue
                self.i = save
                break
            if self.at_kw("IN"):
                self.advance()
                left = A.Binary("IN", left, self.parse_additive())
                continue
            if self.at_kw("STARTS"):
                self.advance()
                self.expect_kw("WITH")
                left = A.Binary("STARTS WITH", left, self.parse_additive())
                continue
            if self.at_kw("ENDS"):
                self.advance()
                self.expect_kw("WITH")
                left = A.Binary("ENDS WITH", left, self.parse_additive())
                continue
            if self.at_kw("CONTAINS"):
                self.advance()
                left = A.Binary("CONTAINS", left, self.parse_additive())
                continue
            if self.at("=~"):
                self.advance()
                left = A.Binary("=~", left, self.parse_additive())
                continue
            break
        return left

    def parse_additive(self) -> A.Expr:
        left = self.parse_multiplicative()
        while self.at("+") or self.at("-"):
            op = self.advance().type
            left = A.Binary(op, left, self.parse_multiplicative())
        return left

    def parse_multiplicative(self) -> A.Expr:
        left = self.parse_power()
        while self.at("*") or self.at("/") or self.at("%"):
            op = self.advance().type
            left = A.Binary(op, left, self.parse_power())
        return left

    def parse_power(self) -> A.Expr:
        left = self.parse_unary()
        if self.at("^"):
            self.advance()
            return A.Binary("^", left, self.parse_power())  # right-assoc
        return left

    def parse_unary(self) -> A.Expr:
        if self.at("-"):
            self.advance()
            return A.Unary("-", self.parse_unary())
        if self.at("+"):
            self.advance()
            return A.Unary("+", self.parse_unary())
        return self.parse_postfix(self.parse_primary())

    def parse_postfix(self, expr: A.Expr) -> A.Expr:
        while True:
            if self.at("."):
                self.advance()
                expr = A.PropertyLookup(expr, self.name_token())
                continue
            if self.at("["):
                self.advance()
                if self.accept(".."):
                    hi = None if self.at("]") else self.parse_expression()
                    self.expect("]")
                    expr = A.Slice(expr, None, hi)
                    continue
                index = None if self.at("..") else self.parse_expression()
                if self.accept(".."):
                    hi = None if self.at("]") else self.parse_expression()
                    self.expect("]")
                    expr = A.Slice(expr, index, hi)
                    continue
                self.expect("]")
                expr = A.Subscript(expr, index)
                continue
            if self.at(":") and isinstance(expr, (A.Identifier,
                                                  A.PropertyLookup,
                                                  A.FunctionCall,
                                                  A.LabelsTest)):
                # labels test: n:Person:Employee
                labels = []
                while self.accept(":"):
                    labels.append(self.name_token())
                if isinstance(expr, A.LabelsTest):
                    expr.labels.extend(labels)
                else:
                    expr = A.LabelsTest(expr, labels)
                continue
            break
        return expr

    def parse_primary(self) -> A.Expr:
        tok = self.cur
        if tok.type == T.INT or tok.type == T.FLOAT or tok.type == T.STRING:
            self.advance()
            return A.Literal(tok.value)
        if tok.type == T.PARAM:
            self.advance()
            return A.Parameter(tok.value)
        if tok.is_kw("TRUE"):
            self.advance()
            return A.Literal(True)
        if tok.is_kw("FALSE"):
            self.advance()
            return A.Literal(False)
        if tok.is_kw("NULL"):
            self.advance()
            return A.Literal(None)
        if tok.is_kw("COUNT") and self.peek().type == "(" \
                and self.peek(2).type == "*":
            self.advance(); self.advance(); self.advance()
            self.expect(")")
            return A.CountStar()
        if tok.is_kw("CASE"):
            return self.parse_case()
        if tok.is_kw("EXISTS") and self.peek().type == "(":
            self.advance()
            self.expect("(")
            if self.at("("):
                pattern = self.parse_pattern()
                self.expect(")")
                return A.PatternExpr(pattern)
            expr = self.parse_expression()
            self.expect(")")
            if not isinstance(expr, (A.PropertyLookup, A.Identifier,
                                     A.Subscript, A.PatternExpr)):
                # TCK SemanticErrorAcceptance: InvalidArgumentExpression
                raise SyntaxException(
                    "InvalidArgumentExpression: exists() expects a "
                    "property access or a pattern")
            return A.IsNull(expr, negated=True)
        if tok.is_kw("ALL", "ANY", "NONE", "SINGLE") and self.peek().type == "(":
            kind = self.advance().value
            self.expect("(")
            var = self.name_token()
            self.expect_kw("IN")
            lst = self.parse_expression()
            self.expect_kw("WHERE")
            where = self.parse_expression()
            self.expect(")")
            return A.Quantifier(kind, var, lst, where)
        if (tok.type == T.IDENT and tok.value.lower() == "reduce"
                and self.peek().type == "("):
            self.advance()
            self.expect("(")
            acc = self.name_token()
            self.expect("=")
            init = self.parse_expression()
            self.expect(",")
            var = self.name_token()
            self.expect_kw("IN")
            lst = self.parse_expression()
            self.expect("|")
            expr = self.parse_expression()
            self.expect(")")
            return A.Reduce(acc, init, var, lst, expr)
        if tok.is_kw("COALESCE") and self.peek().type == "(":
            self.advance()
            return self._finish_function_call("coalesce")
        if tok.type == "(":
            # sub-expression OR a pattern expression like (n)-[:X]->(m)
            save = self.i
            try:
                pattern = self.parse_pattern()
                if (len(pattern.elements) > 1
                        and (self.at(T.EOF) or not self.at("("))):
                    return A.PatternExpr(pattern, exists_form=False)
                raise SyntaxException("not a pattern")
            except SyntaxException:
                self.i = save
            self.advance()
            expr = self.parse_expression()
            self.expect(")")
            return expr
        if tok.type == "[":
            return self.parse_list_or_comprehension()
        if tok.type == "{":
            items = self.parse_map_or_param()
            return A.MapLiteral(items)
        if tok.type == T.IDENT or tok.type == T.KEYWORD:
            if self.peek().type == "::":
                enum_name = self.name_token()
                self.advance()  # '::'
                return A.EnumLiteral(enum_name, self.name_token())
            # function call or identifier (possibly namespaced)
            if self.peek().type == "(" or (self.peek().type == "."
                                           and self._looks_like_ns_call()):
                return self.parse_function_or_ident()
            name = self.name_token()
            return A.Identifier(name)
        self.error(f"unexpected token {self._desc(tok)} in expression")

    def _looks_like_ns_call(self) -> bool:
        """ident '.' ident ... '(' — namespaced function call."""
        k = self.i
        toks = self.toks
        if toks[k].type not in (T.IDENT, T.KEYWORD):
            return False
        k += 1
        saw_dot = False
        while (k + 1 < len(toks) and toks[k].type == "."
               and toks[k + 1].type in (T.IDENT, T.KEYWORD)):
            saw_dot = True
            k += 2
        return saw_dot and k < len(toks) and toks[k].type == "("

    def parse_function_or_ident(self) -> A.Expr:
        parts = [self.name_token()]
        while self.at(".") and self.peek().type in (T.IDENT, T.KEYWORD):
            # only consume dots that lead to '(' eventually
            if not self._dots_lead_to_call():
                break
            self.advance()
            parts.append(self.name_token())
        name = ".".join(parts)
        if self.at("("):
            return self._finish_function_call(name.lower())
        if len(parts) == 1:
            return A.Identifier(parts[0])
        # ident.prop fallback
        expr: A.Expr = A.Identifier(parts[0])
        for p in parts[1:]:
            expr = A.PropertyLookup(expr, p)
        return expr

    def _dots_lead_to_call(self) -> bool:
        k = self.i
        toks = self.toks
        while (k + 1 < len(toks) and toks[k].type == "."
               and toks[k + 1].type in (T.IDENT, T.KEYWORD)):
            k += 2
        return k < len(toks) and toks[k].type == "("

    def _finish_function_call(self, name: str) -> A.FunctionCall:
        self.expect("(")
        distinct = bool(self.accept_kw("DISTINCT"))
        args: list[A.Expr] = []
        if not self.at(")"):
            if self.accept("*"):
                self.expect(")")
                if name == "count":
                    return A.CountStar()
                self.error(f"'*' argument not supported for {name}()")
            args.append(self.parse_expression())
            while self.accept(","):
                args.append(self.parse_expression())
        self.expect(")")
        return A.FunctionCall(name, args, distinct)

    def parse_case(self) -> A.CaseExpr:
        self.expect_kw("CASE")
        test = None
        if not self.at_kw("WHEN"):
            test = self.parse_expression()
        whens: list[tuple[A.Expr, A.Expr]] = []
        while self.accept_kw("WHEN"):
            cond = self.parse_expression()
            self.expect_kw("THEN")
            whens.append((cond, self.parse_expression()))
        default = None
        if self.accept_kw("ELSE"):
            default = self.parse_expression()
        self.expect_kw("END")
        if not whens:
            self.error("CASE requires at least one WHEN")
        return A.CaseExpr(test, whens, default)

    def parse_list_or_comprehension(self) -> A.Expr:
        self.expect("[")
        if self.at("]"):
            self.advance()
            return A.ListLiteral([])
        # pattern comprehension: [(n)-[]->(m) ... | expr], optionally with
        # a named path [p = (n)-->() | p] (reference grammar
        # Cypher.g4:334 patternComprehension)
        if self.at("(") or (self.at(T.IDENT) and self.peek().type == "="):
            save = self.i
            try:
                pattern = self.parse_pattern()
                if len(pattern.elements) > 1 and (self.at("|")
                                                  or self.at_kw("WHERE")):
                    where = None
                    if self.accept_kw("WHERE"):
                        where = self.parse_expression()
                    self.expect("|")
                    proj = self.parse_expression()
                    self.expect("]")
                    return A.PatternComprehension(pattern, where, proj)
                raise SyntaxException("not a pattern comprehension")
            except SyntaxException:
                self.i = save
        # lookahead: name IN → comprehension (the variable may lex as a
        # KEYWORD, e.g. `[key IN keys(r) | ...]` — KEY is a keyword)
        if (self.cur.type in (T.IDENT, T.KEYWORD)
                and self.peek().is_kw("IN")):
            var = self.name_token()
            self.advance()  # IN
            lst = self.parse_expression()
            where = None
            proj = None
            if self.accept_kw("WHERE"):
                where = self.parse_expression()
            if self.accept("|"):
                proj = self.parse_expression()
            self.expect("]")
            return A.ListComprehension(var, lst, where, proj)
        items = [self.parse_expression()]
        while self.accept(","):
            items.append(self.parse_expression())
        self.expect("]")
        return A.ListLiteral(items)


def parse_with_source(text: str):
    """parse() variant that retains source for trigger statements."""
    p = Parser(tokenize(text))
    p._source = text
    return p.parse_statement()
