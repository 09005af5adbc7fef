"""PQL tokenizer + recursive-descent parser.

Reference analog: pql/scanner.go + pql/parser.go.  Token inventory matches
pql/token.go:22-46 (IDENT STRING INTEGER FLOAT EQ COMMA LPAREN RPAREN
LBRACK RBRACK); the grammar matches parser.go:66-260:

    query    := call*
    call     := IDENT '(' children? args? ')'
    children := call (',' call)*          (children precede args)
    args     := IDENT '=' value (',' IDENT '=' value)*
    value    := IDENT | STRING | INTEGER | FLOAT | '[' list ']'

``true``/``false``/``null`` idents become Python True/False/None; other
bare idents become strings (parser.go:172-183).  Identifiers may contain
letters, digits, ``_ - .`` after a leading letter (scanner.go:274-280);
numbers are integers or single-dot floats with optional leading minus
(scanner.go:155-180).

This implementation is a regex tokenizer + index-cursor parser (the
Python-native shape) rather than a rune scanner with unread stacks.
"""

from __future__ import annotations

import re
import threading

from pilosa_tpu_torch.analysis import lockcheck
from typing import Any, NamedTuple

from pilosa_tpu_torch.pql.ast import Call, Query


class ParseError(Exception):
    def __init__(self, message: str, line: int = 0, char: int = 0):
        super().__init__(f"{message} (line {line}, char {char})")
        self.message = message
        self.line = line
        self.char = char


_TOKEN_RE = re.compile(
    r"""
    (?P<WS>\s+)
  | (?P<IDENT>[A-Za-z][A-Za-z0-9_.-]*)
  | (?P<FLOAT>-?\d+\.\d*|-?\.\d+)
  | (?P<INTEGER>-?\d+)
  | (?P<STRING>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<EQ>=)
  | (?P<COMMA>,)
  | (?P<LPAREN>\()
  | (?P<RPAREN>\))
  | (?P<LBRACK>\[)
  | (?P<RBRACK>\])
  | (?P<ILLEGAL>.)
    """,
    re.VERBOSE | re.DOTALL,
)


class Token(NamedTuple):
    kind: str
    lit: str
    pos: int  # byte offset into the source; line/char derived on error


_UNESCAPE_RE = re.compile(r"\\(.)")


def _line_char(src: str, pos: int) -> tuple[int, int]:
    """Derive (line, char) from a source offset.  Position bookkeeping is
    deferred to error paths so the tokenize hot loop (thousands of tokens
    per batched query request) does no per-token arithmetic."""
    line = src.count("\n", 0, pos) + 1
    char = pos - (src.rfind("\n", 0, pos) + 1)
    return line, char


def tokenize(src: str) -> list[Token]:
    tokens: list[Token] = []
    append = tokens.append
    for m in _TOKEN_RE.finditer(src):
        kind = m.lastgroup
        if kind == "WS":
            continue
        lit = m.group()
        if kind == "ILLEGAL":
            raise ParseError(f"illegal character {lit!r}", *_line_char(src, m.start()))
        if kind == "STRING":
            lit = _UNESCAPE_RE.sub(r"\1", lit[1:-1])
        append(Token(kind, lit, m.start()))
    append(Token("EOF", "", len(src)))
    return tokens


class _Parser:
    def __init__(self, tokens: list[Token], src: str = ""):
        self.tokens = tokens
        self.src = src
        self.i = 0

    def fail(self, message: str, t: Token):
        raise ParseError(message, *_line_char(self.src, t.pos))

    def peek(self) -> Token:
        return self.tokens[self.i]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "EOF":
            # analysis-ok: check-then-act: _Parser is a per-parse stack object; it never crosses threads
            self.i += 1
        return t

    def expect(self, kind: str) -> Token:
        t = self.next()
        if t.kind != kind:
            self.fail(f"expected {kind}, found {t.lit!r}", t)
        return t

    def parse_query(self) -> Query:
        calls = []
        while self.peek().kind != "EOF":
            calls.append(self.parse_call())
        return Query(calls=calls)

    def parse_call(self) -> Call:
        name_tok = self.next()
        if name_tok.kind != "IDENT":
            self.fail(f"expected identifier, found: {name_tok.lit!r}", name_tok)
        self.expect("LPAREN")
        children = self.parse_children()
        args: dict[str, Any] = {}
        if self.peek().kind != "RPAREN":
            if children and self.peek().kind == "COMMA":
                self.next()
            args = self.parse_args()
        self.expect("RPAREN")
        return Call(name=name_tok.lit, args=args, children=children)

    def parse_children(self) -> list[Call]:
        children: list[Call] = []
        while (
            self.peek().kind == "IDENT"
            and self.i + 1 < len(self.tokens)
            and self.tokens[self.i + 1].kind == "LPAREN"
        ):
            children.append(self.parse_call())
            if self.peek().kind == "COMMA":
                # Only consume the comma if another child follows; otherwise
                # leave it for the args transition in parse_call.
                if (
                    self.i + 1 < len(self.tokens)
                    and self.tokens[self.i + 1].kind == "IDENT"
                    and self.i + 2 < len(self.tokens)
                    and self.tokens[self.i + 2].kind == "LPAREN"
                ):
                    self.next()
                else:
                    break
            else:
                break
        return children

    def parse_args(self) -> dict[str, Any]:
        args: dict[str, Any] = {}
        while True:
            if self.peek().kind == "RPAREN":
                return args
            key_tok = self.expect("IDENT")
            eq = self.next()
            if eq.kind != "EQ":
                self.fail(f"expected equals sign, found {eq.lit!r}", eq)
            value = self.parse_value()
            if key_tok.lit in args:
                self.fail(f"argument key already used: {key_tok.lit}", key_tok)
            args[key_tok.lit] = value
            t = self.peek()
            if t.kind == "RPAREN":
                return args
            if t.kind != "COMMA":
                self.fail(f"expected comma or right paren, found {t.lit!r}", t)
            self.next()

    def parse_value(self, in_list: bool = False) -> Any:
        t = self.next()
        if t.kind == "IDENT":
            if t.lit == "true":
                return True
            if t.lit == "false":
                return False
            if t.lit == "null" and not in_list:
                return None
            return t.lit
        if t.kind == "STRING":
            return t.lit
        if t.kind == "INTEGER":
            return int(t.lit)
        if t.kind == "FLOAT":
            return float(t.lit)
        if t.kind == "LBRACK" and not in_list:
            values = []
            while True:
                values.append(self.parse_value(in_list=True))
                sep = self.next()
                if sep.kind == "RBRACK":
                    return values
                if sep.kind != "COMMA":
                    self.fail(f"expected comma, found {sep.lit!r}", sep)
        self.fail(f"invalid argument value: {t.lit!r}", t)


_NATIVE_VALUES = {3: True, 4: False, 5: None}  # PN_V_TRUE/FALSE/NULL


def _parse_native(src: str):
    """Native C++ fast path (native/pilosa_native.cpp pn_pql_parse): the
    flat preorder call tree is rebuilt into Call objects here.  Returns
    None whenever the source needs the slow path — unsupported constructs
    OR any syntax error, so error messages always come from the Python
    parser and are byte-identical with or without the .so."""
    from pilosa_tpu_torch import native

    try:
        raw = src.encode("utf-8")
    except UnicodeEncodeError:
        return None
    flat = native.pql_parse_flat(raw)
    if flat is None:
        return None
    (n, cname_s, cname_e, cnchild, cnargs, cargs_off,
     n_args, ak_s, ak_e, atype, aint, av_s, av_e) = flat
    # Slice to the used prefixes before tolist: the arrays are allocated at
    # source-length capacity, far larger than the parsed counts.
    cname_s = cname_s[:n].tolist()
    cname_e = cname_e[:n].tolist()
    cnchild = cnchild[:n].tolist()
    cnargs = cnargs[:n].tolist()
    cargs_off = cargs_off[:n].tolist()
    ak_s, ak_e = ak_s[:n_args].tolist(), ak_e[:n_args].tolist()
    atype, aint = atype[:n_args].tolist(), aint[:n_args].tolist()
    av_s, av_e = av_s[:n_args].tolist(), av_e[:n_args].tolist()

    def build(i: int) -> tuple[Call, int]:
        children = []
        j = i + 1
        for _ in range(cnchild[i]):
            child, j = build(j)
            children.append(child)
        args: dict[str, Any] = {}
        off = cargs_off[i]
        for a in range(off, off + cnargs[i]):
            t = atype[a]
            if t == 0:
                v: Any = aint[a]
            elif t in (1, 2):
                v = raw[av_s[a]:av_e[a]].decode("utf-8")
            else:
                v = _NATIVE_VALUES[t]
            args[raw[ak_s[a]:ak_e[a]].decode("utf-8")] = v
        return Call(name=raw[cname_s[i]:cname_e[i]].decode("utf-8"), args=args, children=children), j

    calls = []
    i = 0
    while i < n:
        call, i = build(i)
        calls.append(call)
    return Query(calls=calls)


# Singleton-write fast lane: `SetBit(k=1, frame="f", k2=2)`-shaped
# sources are the server's hottest parse (one per ingest request), and
# even the native parser's flat-array rebuild costs ~100 us of Python
# per call; this regex + split handles the flat no-nesting, no-list,
# int-or-plain-string argument shape in a few us.  Anything it can't
# express falls through to the normal parsers, so semantics and error
# messages are unchanged.
_SIMPLE_WRITE = re.compile(r"^\s*(SetBit|ClearBit)\s*\(([^()\[\]]*)\)\s*$")
_SIMPLE_STR = re.compile(r'^"[^"\\]*"$')


def _parse_simple_write(src: str):
    m = _SIMPLE_WRITE.match(src)
    if m is None:
        return None
    name, body = m.group(1), m.group(2)
    args: dict = {}
    for part in body.split(","):
        part = part.strip()
        if not part:
            return None
        k, eq, v = part.partition("=")
        if not eq:
            return None
        k, v = k.strip(), v.strip()
        if not k.isidentifier() or k in args:
            return None  # duplicate keys: the full parsers reject them
        if v.isascii() and v.isdigit():
            args[k] = int(v)
        elif _SIMPLE_STR.match(v):
            args[k] = v[1:-1]
        else:
            return None  # floats, bools, escapes, lists: slow path
    return Query(calls=[Call(name=name, args=args)])


def parse(src: str) -> Query:
    q = _parse_simple_write(src)
    if q is not None:
        return q
    q = _parse_native(src)
    if q is not None:
        return q
    return _Parser(tokenize(src), src).parse_query()


# Prepared-query cache: dashboards and importers re-send identical PQL
# request bodies; parsing is the dominant host cost of a large batched
# request, so identical sources hit a process-wide LRU.  Safe to share
# because the executor never mutates a parsed AST in place (TopN phase 2
# goes through Call.clone, executor analog of ast.go Clone).  Built
# through the named-global seam: bounded, every mutation under the
# "pql.parse_memo" lock, registered for the lockset detector and the
# /metrics inventory, and self-bypassing under an exploration run so
# cold-vs-warm cannot change a scenario's yield structure (this retired
# the PR 12 driver-thread warm-up in analysis/scenarios.py).  The key
# bound keeps megabyte import bodies out of the memo.
_PARSE_MEMO = lockcheck.named_global(
    "pql.parse_memo", max_entries=512, max_key_len=1 << 16
)


def parse_cached(src: str) -> Query:
    q = _PARSE_MEMO.get(src)
    if q is None:
        q = parse(src)  # outside the lock: a slow parse never serializes
        _PARSE_MEMO.put(src, q)
    return q
