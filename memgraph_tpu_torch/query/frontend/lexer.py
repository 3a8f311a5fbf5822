"""openCypher tokenizer.

Hand-written (the environment has no parser-generator runtime; the reference
uses ANTLR4 — memgraph/src/query/frontend/opencypher/grammar/).
Covers the full lexical surface needed by the parser: identifiers, backtick
escapes, keywords (case-insensitive), numbers (int/float/hex/octal/
scientific), single/double-quoted strings with escapes, parameters, all
operators/punctuation, and both comment styles.

Copy of memgraph_tpu/query/frontend/lexer.py for the port (its imports the port's own).
"""

from __future__ import annotations

from dataclasses import dataclass

from ...exceptions import SyntaxException

KEYWORDS = {
    "MATCH", "OPTIONAL", "WHERE", "RETURN", "CREATE", "MERGE", "SET",
    "REMOVE", "DELETE", "DETACH", "WITH", "UNWIND", "AS", "ORDER", "BY",
    "SKIP", "LIMIT", "ASC", "ASCENDING", "DESC", "DESCENDING", "DISTINCT",
    "AND", "OR", "XOR", "NOT", "IN", "STARTS", "ENDS", "CONTAINS", "IS",
    "NULL", "TRUE", "FALSE", "CASE", "WHEN", "THEN", "ELSE", "END", "ON",
    "CALL", "YIELD", "UNION", "ALL", "ANY", "NONE", "SINGLE", "EXISTS",
    "INDEX", "DROP", "CONSTRAINT", "ASSERT", "UNIQUE", "BEGIN", "COMMIT",
    "ROLLBACK", "EXPLAIN", "PROFILE", "SHOW", "INFO", "STORAGE", "DATABASE",
    "TRANSACTIONS", "TERMINATE", "FOREACH", "LOAD", "CSV", "FROM", "HEADER",
    "NO", "ROW", "FIELDTERMINATOR", "COALESCE", "COUNT", "EDGE", "TYPED",
    "SNAPSHOT", "RECOVER", "DUMP", "ANALYZE", "GRAPH", "FREE", "MEMORY",
    "QUERY", "UNLIMITED", "PROCEDURE",
    "ISOLATION", "LEVEL", "NEXT", "READ", "COMMITTED", "UNCOMMITTED",
    "GLOBAL", "SESSION", "TRANSACTION", "STATS", "TRIGGER", "TRIGGERS",
    "AFTER", "BEFORE", "EXECUTE", "CREATED", "UPDATED", "DELETED", "VERTICES",
    "EDGES", "MODE", "ANALYTICAL", "TRANSACTIONAL", "STREAM", "STREAMS",
    "START", "STOP", "TOPICS", "TRANSFORM", "BATCH_SIZE", "BATCH_INTERVAL",
    "CONSUMER_GROUP", "BOOTSTRAP_SERVERS", "CHECK", "SERVICE_URL", "TTL",
    "AT", "EVERY", "ENABLE", "DISABLE", "USING", "PERIODIC", "HOPS",
    "PARALLEL", "EXECUTION",
    "KEY", "OF", "TYPE", "POINT", "TEXT", "VECTORS", "PASSWORD", "USER",
    "ROLE", "PRIVILEGES", "GRANT", "DENY", "REVOKE", "TO", "FOR", "METRICS",
    "REPLICA", "REPLICAS", "MAIN", "REPLICATION", "REGISTER", "SYNC", "USE", "DATABASES",
    "ASYNC", "STRICT_SYNC", "PORT", "SERVER", "VERSION", "BUILD", "SCHEMA",
    "LABELS", "REQUIRE", "ID",
}


class T:
    """Token types."""
    IDENT = "IDENT"
    KEYWORD = "KEYWORD"
    INT = "INT"
    FLOAT = "FLOAT"
    STRING = "STRING"
    PARAM = "PARAM"          # $name or $0
    EOF = "EOF"
    # punctuation/operators carry their literal text as type
    # e.g. '(', ')', '[', ']', '{', '}', ',', ':', ';', '.', '..',
    # '+', '-', '*', '/', '%', '^', '=', '<>', '<', '>', '<=', '>=',
    # '=~', '|', '->', '<-', '--', '+=', '.."


@dataclass
class Token:
    type: str        # T.IDENT / T.KEYWORD / ... or literal punctuation
    value: object    # text for idents/keywords, parsed value for literals
    pos: int
    line: int
    col: int
    raw: str | None = None   # original source text (keywords keep case)

    def is_kw(self, *names: str) -> bool:
        return self.type == T.KEYWORD and self.value in names

    def __repr__(self) -> str:  # pragma: no cover
        return f"Token({self.type!r}, {self.value!r})"


_PUNCT3 = ()
_PUNCT2 = ("<>", "<=", ">=", "=~", "->", "<-", "--", "+=", "..", "||", "::")
_PUNCT1 = ("(", ")", "[", "]", "{", "}", ",", ":", ";", ".", "+", "-", "*",
           "/", "%", "^", "=", "<", ">", "|", "&")


def tokenize(text: str) -> list[Token]:
    tokens: list[Token] = []
    i = 0
    n = len(text)
    line = 1
    line_start = 0

    def err(msg, pos):
        raise SyntaxException(
            f"line {line}:{pos - line_start + 1} {msg}")

    while i < n:
        c = text[i]
        # whitespace
        if c in " \t\r\n":
            if c == "\n":
                line += 1
                line_start = i + 1
            i += 1
            continue
        # comments
        if text.startswith("//", i):
            j = text.find("\n", i)
            i = n if j < 0 else j
            continue
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            if j < 0:
                err("unterminated block comment", i)
            line += text.count("\n", i, j)
            i = j + 2
            continue
        col = i - line_start + 1
        # strings
        if c in "'\"":
            value, j = _scan_string(text, i, err)
            tokens.append(Token(T.STRING, value, i, line, col))
            i = j
            continue
        # backtick-escaped identifier
        if c == "`":
            j = text.find("`", i + 1)
            if j < 0:
                err("unterminated escaped identifier", i)
            tokens.append(Token(T.IDENT, text[i + 1:j], i, line, col))
            i = j + 1
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            tok, j = _scan_number(text, i, line, col, err)
            # disambiguate "1..2" (range) from float "1."
            tokens.append(tok)
            i = j
            continue
        # parameters
        if c == "$":
            j = i + 1
            if j < n and text[j] == "`":
                k = text.find("`", j + 1)
                if k < 0:
                    err("unterminated escaped parameter name", i)
                tokens.append(Token(T.PARAM, text[j + 1:k], i, line, col))
                i = k + 1
                continue
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            if j == i + 1:
                err("invalid parameter name", i)
            tokens.append(Token(T.PARAM, text[i + 1:j], i, line, col))
            i = j
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_":
            j = i + 1
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            word = text[i:j]
            upper = word.upper()
            if upper in KEYWORDS:
                tokens.append(Token(T.KEYWORD, upper, i, line, col, word))
            else:
                tokens.append(Token(T.IDENT, word, i, line, col))
            i = j
            continue
        # punctuation (longest match)
        matched = False
        for p in _PUNCT2:
            if text.startswith(p, i):
                tokens.append(Token(p, p, i, line, col))
                i += len(p)
                matched = True
                break
        if matched:
            continue
        if c in _PUNCT1:
            tokens.append(Token(c, c, i, line, col))
            i += 1
            continue
        err(f"unexpected character {c!r}", i)

    tokens.append(Token(T.EOF, None, n, line, n - line_start + 1))
    return tokens


def _scan_string(text, i, err):
    quote = text[i]
    out = []
    j = i + 1
    n = len(text)
    while j < n:
        c = text[j]
        if c == "\\":
            if j + 1 >= n:
                err("unterminated string", i)
            e = text[j + 1]
            mapping = {"n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f",
                       "'": "'", '"': '"', "\\": "\\", "/": "/"}
            if e in mapping:
                out.append(mapping[e])
                j += 2
            elif e == "u":
                if j + 6 > n:
                    err("bad unicode escape", j)
                out.append(chr(int(text[j + 2:j + 6], 16)))
                j += 6
            elif e == "U":
                if j + 10 > n:
                    err("bad unicode escape", j)
                out.append(chr(int(text[j + 2:j + 10], 16)))
                j += 10
            else:
                out.append(e)
                j += 2
            continue
        if c == quote:
            return "".join(out), j + 1
        out.append(c)
        j += 1
    err("unterminated string", i)


def _scan_number(text, i, line, col, err):
    n = len(text)
    j = i
    if text.startswith("0x", i) or text.startswith("0X", i):
        j = i + 2
        while j < n and text[j] in "0123456789abcdefABCDEF":
            j += 1
        return Token(T.INT, int(text[i:j], 16), i, line, col), j
    is_float = False
    while j < n and text[j].isdigit():
        j += 1
    if j < n and text[j] == "." and not text.startswith("..", j):
        if j + 1 < n and text[j + 1].isdigit():
            is_float = True
            j += 1
            while j < n and text[j].isdigit():
                j += 1
    if j < n and text[j] in "eE":
        k = j + 1
        if k < n and text[k] in "+-":
            k += 1
        if k < n and text[k].isdigit():
            is_float = True
            j = k
            while j < n and text[j].isdigit():
                j += 1
    raw = text[i:j]
    if is_float:
        value = float(raw)
        if value in (float("inf"), float("-inf")):
            # FloatingPointOverflow (TCK SemanticErrorAcceptance):
            # a literal too large for f64 is a compile-time error
            err(f"FloatingPointOverflow: float literal {raw!r} is out of "
                f"range", i)
        return Token(T.FLOAT, value, i, line, col), j
    # leading-zero octal (Cypher legacy)
    if len(raw) > 1 and raw[0] == "0" and all(ch in "01234567" for ch in raw[1:]):
        return Token(T.INT, int(raw, 8), i, line, col), j
    return Token(T.INT, int(raw), i, line, col), j
