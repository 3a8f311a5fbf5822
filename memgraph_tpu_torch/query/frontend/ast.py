"""openCypher AST.

Lean dataclass tree mirroring the shape of the reference's AST
(memgraph/src/query/frontend/ast/ast.hpp, 4.5k lines) at the altitude
this engine needs: expressions, patterns, clauses, queries.

Copy of memgraph_tpu/query/frontend/ast.py for the port (its imports the port's own).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


# --- expressions -------------------------------------------------------------

class Expr:
    __slots__ = ()


@dataclass
class Literal(Expr):
    value: object


@dataclass
class Parameter(Expr):
    name: str


@dataclass
class Identifier(Expr):
    name: str


@dataclass
class PropertyLookup(Expr):
    expr: Expr
    prop: str


@dataclass
class LabelsTest(Expr):
    expr: Expr
    labels: list[str]


@dataclass
class Unary(Expr):
    op: str  # '-', '+', 'NOT'
    expr: Expr


@dataclass
class Binary(Expr):
    op: str  # '+','-','*','/','%','^','=','<>','<','>','<=','>=',
             # 'AND','OR','XOR','IN','STARTS WITH','ENDS WITH','CONTAINS','=~'
    left: Expr
    right: Expr


@dataclass
class IsNull(Expr):
    expr: Expr
    negated: bool


@dataclass
class Subscript(Expr):
    expr: Expr
    index: Expr


@dataclass
class Slice(Expr):
    expr: Expr
    lo: Optional[Expr]
    hi: Optional[Expr]


@dataclass
class ListLiteral(Expr):
    items: list[Expr]


@dataclass
class MapLiteral(Expr):
    items: dict[str, Expr]


@dataclass
class FunctionCall(Expr):
    name: str            # lowercased, may be namespaced "ns.fn"
    args: list[Expr]
    distinct: bool = False


@dataclass
class CountStar(Expr):
    pass


@dataclass
class CaseExpr(Expr):
    test: Optional[Expr]               # CASE <test> WHEN ... (simple form)
    whens: list[tuple[Expr, Expr]]
    default: Optional[Expr]


@dataclass
class ListComprehension(Expr):
    var: str
    list_expr: Expr
    where: Optional[Expr]
    projection: Optional[Expr]


@dataclass
class Quantifier(Expr):
    kind: str  # 'ALL','ANY','NONE','SINGLE'
    var: str
    list_expr: Expr
    where: Expr


@dataclass
class Reduce(Expr):
    acc: str
    init: Expr
    var: str
    list_expr: Expr
    expr: Expr


@dataclass
class PatternExpr(Expr):
    """Pattern used as predicate/expression: exists((n)-[]->(m)))."""
    pattern: "Pattern"
    exists_form: bool = True


@dataclass
class PatternComprehension(Expr):
    """[(n)-[r]->(m) WHERE pred | projection]"""
    pattern: "Pattern"
    where: Optional[Expr]
    projection: Expr


# --- patterns ----------------------------------------------------------------

@dataclass
class NodePattern:
    variable: Optional[str]
    labels: list[str]
    properties: object = None     # dict[str, Expr] | Parameter | None


@dataclass
class Lambda:
    """(edge_var, node_var | expr) — weight/filter lambdas on expansions."""
    edge_var: str
    node_var: str
    expr: Expr


@dataclass
class EdgePattern:
    variable: Optional[str]
    types: list[str]
    direction: str                # 'out' (->), 'in' (<-), 'both' (--)
    properties: object = None
    var_length: bool = False
    min_hops: Optional[Expr] = None
    max_hops: Optional[Expr] = None
    algo: Optional[str] = None    # 'bfs' | 'wshortest' | 'allshortest'
    weight_lambda: Optional[Lambda] = None
    filter_lambda: Optional[Lambda] = None
    total_weight: Optional[str] = None


@dataclass
class Pattern:
    """Alternating [Node, Edge, Node, Edge, Node...] chain."""
    variable: Optional[str]
    elements: list


# --- clauses -----------------------------------------------------------------

class Clause:
    __slots__ = ()


@dataclass
class IndexHint:
    variable: str
    label: str
    properties: list[str]


@dataclass
class Match(Clause):
    patterns: list[Pattern]
    where: Optional[Expr] = None
    optional: bool = False
    index_hints: list = field(default_factory=list)
    hops_limit: Optional[int] = None
    parallel: bool = False       # USING PARALLEL EXECUTION hint


@dataclass
class Create(Clause):
    patterns: list[Pattern]


@dataclass
class Merge(Clause):
    pattern: Pattern
    on_create: list = field(default_factory=list)   # list[SetItem]
    on_match: list = field(default_factory=list)


@dataclass
class SetItem:
    kind: str      # 'prop' (n.p = e), 'var_assign' (n = expr),
                   # 'var_update' (n += expr), 'label' (n:Label:...)
    target: Expr   # PropertyLookup or Identifier
    value: object  # Expr or list[str] for labels


@dataclass
class SetClause(Clause):
    items: list[SetItem]


@dataclass
class RemoveItem:
    kind: str      # 'prop' or 'label'
    target: Expr
    labels: list[str] = field(default_factory=list)


@dataclass
class Remove(Clause):
    items: list[RemoveItem]


@dataclass
class Delete(Clause):
    exprs: list[Expr]
    detach: bool = False


@dataclass
class SortItem:
    expr: Expr
    ascending: bool = True


@dataclass
class ReturnBody:
    distinct: bool
    # (expr, explicit alias | None, verbatim source text | None)
    items: list[tuple[Expr, Optional[str], Optional[str]]]
    star: bool
    order_by: list[SortItem] = field(default_factory=list)
    skip: Optional[Expr] = None
    limit: Optional[Expr] = None


@dataclass
class Return(Clause):
    body: ReturnBody


@dataclass
class With(Clause):
    body: ReturnBody
    where: Optional[Expr] = None


@dataclass
class Unwind(Clause):
    expr: Expr
    variable: str


@dataclass
class CallProcedure(Clause):
    name: str
    args: Optional[list[Expr]]   # None = no parens (implicit/param args)
    yields: list[tuple[str, Optional[str]]]   # (field, alias)
    yield_star: bool = False
    where: Optional[Expr] = None
    yield_dash: bool = False     # CALL proc() YIELD - (explicitly nothing)
    memory_limit: Optional[int] = None   # PROCEDURE MEMORY LIMIT, bytes


@dataclass
class CallSubquery(Clause):
    """CALL { <single query> } [IN TRANSACTIONS OF n ROWS]."""
    query: "SingleQuery"
    batch_rows: Optional[int] = None


@dataclass
class Foreach(Clause):
    variable: str
    expr: Expr
    updates: list[Clause]


@dataclass
class LoadCsv(Clause):
    file: Expr
    variable: str
    with_header: bool = True
    ignore_bad: bool = False
    delimiter: Optional[Expr] = None
    quote: Optional[Expr] = None


@dataclass
class LoadJsonl(Clause):
    file: Expr
    variable: str


@dataclass
class LoadParquet(Clause):
    file: Expr
    variable: str


# --- queries -----------------------------------------------------------------

@dataclass
class SingleQuery:
    clauses: list[Clause]


@dataclass
class CypherQuery:
    query: SingleQuery
    unions: list[tuple[bool, SingleQuery]] = field(default_factory=list)
    # [(all?, query)]
    explain: bool = False
    profile: bool = False
    memory_limit: Optional[int] = None   # QUERY MEMORY LIMIT, bytes
    # USING PERIODIC COMMIT n: int literal or Parameter (reference:
    # MemgraphCypher.g4:413 periodicCommit pre-query directive)
    commit_frequency: Optional[object] = None


# --- administrative / DDL queries -------------------------------------------

@dataclass
class IndexQuery:
    action: str                     # 'create' | 'drop'
    kind: str                       # 'label' | 'label_property' | 'edge_type'
    label: Optional[str]
    properties: list[str] = field(default_factory=list)
    edge_type: Optional[str] = None


@dataclass
class ConstraintQuery:
    action: str                     # 'create' | 'drop'
    kind: str                       # 'exists' | 'unique' | 'type'
    label: str
    properties: list[str]
    data_type: Optional[str] = None


@dataclass
class InfoQuery:
    kind: str   # 'storage' | 'index' | 'constraint' | 'build' | 'metrics'


@dataclass
class TransactionQuery:
    action: str  # 'begin' | 'commit' | 'rollback'
    metadata: Optional[dict] = None


@dataclass
class ShowTransactionsQuery:
    pass


@dataclass
class TerminateTransactionsQuery:
    ids: list[Expr] = field(default_factory=list)


@dataclass
class SnapshotQuery:
    action: str  # 'create' | 'recover' | 'show'
    source: Optional[str] = None   # RECOVER SNAPSHOT FROM "<uri>"


@dataclass
class DumpQuery:
    pass


@dataclass
class AnalyzeGraphQuery:
    action: str = "analyze"  # 'analyze' | 'delete'
    labels: list[str] = field(default_factory=list)


@dataclass
class IsolationLevelQuery:
    level: str
    scope: str  # 'global' | 'session' | 'next'


@dataclass
class StorageModeQuery:
    mode: str   # 'IN_MEMORY_ANALYTICAL' | 'IN_MEMORY_TRANSACTIONAL'


@dataclass
class TriggerQuery:
    action: str                     # 'create' | 'drop' | 'show'
    name: Optional[str] = None
    event: Optional[str] = None     # e.g. 'CREATE' / 'UPDATE' / 'DELETE' / None
    phase: Optional[str] = None     # 'BEFORE' | 'AFTER'
    statement: Optional[str] = None


@dataclass
class SessionTraceQuery:
    enabled: bool


@dataclass
class EnumQuery:
    action: str                 # create | add_value | show
    name: Optional[str] = None
    values: list[str] = field(default_factory=list)


@dataclass
class EnumLiteral(Expr):
    enum_name: str
    value_name: str
    # evaluator's memo: (weakref-to-storage, EnumValue); excluded from
    # structural equality so ORDER BY column rewriting still matches
    resolved: object = field(default=None, compare=False, repr=False)


@dataclass
class SettingQuery:
    action: str                 # set | show_one | show_all
    name: Optional[str] = None
    value: Optional[str] = None


@dataclass
class MultiDatabaseQuery:
    action: str        # create | drop | use | show | suspend | resume
    name: Optional[str] = None


@dataclass
class TenantProfileQuery:
    action: str        # create | alter | drop | show | assign | clear
    name: Optional[str] = None
    limits: Optional[dict] = None      # key -> bytes | None (UNLIMITED)
    database: Optional[str] = None


@dataclass
class UserProfileQuery:
    """Per-user profiles (reference: MemgraphCypher.g4:974-991,
    auth/profiles/user_profiles.cpp)."""
    action: str        # create | update | drop | show | show_for |
    #                    users_for | assign | clear
    name: Optional[str] = None         # profile name
    user: Optional[str] = None
    limits: Optional[dict] = None


@dataclass
class CoordinatorQuery:
    action: str                 # register | unregister | set_main | show
    name: Optional[str] = None
    mgmt_address: Optional[str] = None
    replication_address: Optional[str] = None
    bolt_address: Optional[str] = None


@dataclass
class StreamQuery:
    action: str            # create | drop | start | stop | start_all |
                           # stop_all | show | check
    name: Optional[str] = None
    kind: str = "kafka"    # kafka | pulsar | file
    topics: list[str] = field(default_factory=list)
    transform: Optional[str] = None
    batch_size: int = 100
    batch_interval_ms: int = 100
    bootstrap_servers: str = ""
    service_url: str = ""
    consumer_group: str = ""


@dataclass
class TtlQuery:
    action: str            # enable | disable
    period: Optional[str] = None   # e.g. "1s", "5m"


@dataclass
class ReplicationQuery:
    action: str                 # set_role_main | set_role_replica |
                                # register | drop | show_replicas | show_role
    name: Optional[str] = None
    mode: Optional[str] = None  # SYNC | ASYNC | STRICT_SYNC
    address: Optional[str] = None
    port: Optional[int] = None


@dataclass
class AuthQuery:
    action: str   # create_user | drop_user | set_password | show_users |
                  # create_role | drop_role | set_role | show_roles |
                  # grant | deny | revoke | show_privileges
    user: Optional[str] = None
    password: Optional[object] = None
    role: Optional[str] = None
    privileges: list[str] = field(default_factory=list)
    fg_kind: Optional[str] = None       # labels | edge_types
    fg_items: list[str] = field(default_factory=list)
    fg_level: Optional[str] = None      # READ | UPDATE | CREATE_DELETE | NOTHING
