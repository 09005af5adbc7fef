"""Name-based intra-package call graph for reachability queries.

The lockstep-determinism rule needs "code reachable from the batch
execution entry points".  Python offers no cheap sound call graph, so
this is the standard project-linter over-approximation:

- every function/method in the package is a node keyed by
  (file, dotted scope);
- a call ``foo(...)`` / ``obj.foo(...)`` adds edges to every node whose
  BARE name is ``foo``, preferring same-file definitions when any
  exist (a same-file ``def foo`` almost always IS the callee);
- bare names on :data:`STOPLIST` (overwhelmingly stdlib/builtin method
  names — ``start``, ``get``, ``append`` ...) produce no edges, which
  keeps ``thread.start()`` from "reaching" ``Server.start`` and
  dragging the whole server into the reachable set.

Over-approximation errs toward MORE findings, which the suppression /
baseline machinery absorbs; the stoplist errs toward fewer, and is the
documented soundness hole (DEVELOPMENT.md).
"""

from __future__ import annotations

import ast

# Bare callee names never followed: stdlib/builtin collisions.
STOPLIST = frozenset(
    {
        "start", "join", "run", "close", "flush", "open", "read", "write",
        "append", "extend", "insert", "pop", "get", "put", "add", "remove",
        "discard", "clear", "copy", "update", "setdefault", "keys", "values",
        "items", "sort", "reverse", "index",
        "wait", "notify", "notify_all", "acquire", "release", "locked",
        "set", "is_set",
        "encode", "decode", "split", "rsplit", "strip", "lstrip", "rstrip",
        "lower", "upper", "replace", "format", "startswith", "endswith",
        "send", "recv", "sendall", "sendto", "recvfrom", "connect", "bind",
        "listen", "accept", "fileno", "seek", "tell", "truncate",
        "readline", "readinto", "makefile", "shutdown", "detach",
        "load", "loads", "dump", "dumps", "pack", "unpack", "unpack_from",
        "group", "match", "search", "sub", "findall", "finditer",
        "sleep", "exists", "abspath", "dirname", "basename", "relpath",
        "cancel", "total_seconds", "now", "utcnow",
    }
)


class _FuncInfo:
    __slots__ = ("key", "rel", "scope", "node", "bare", "calls")

    def __init__(self, rel: str, scope: str, node: ast.AST):
        self.rel = rel
        self.scope = scope
        self.key = (rel, scope)
        self.node = node
        self.bare = scope.rsplit(".", 1)[-1]
        self.calls: set[str] = set()  # bare callee names


def _callee_bare_name(call: ast.Call) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


class CallGraph:
    def __init__(self, files):
        # bare name -> [FuncInfo]
        self.by_bare: dict[str, list[_FuncInfo]] = {}
        self.funcs: dict[tuple, _FuncInfo] = {}
        for sf in files:
            self._index_file(sf)

    def _index_file(self, sf) -> None:
        rel = sf.rel

        class V(ast.NodeVisitor):
            def __init__(self):
                self.scope: list[str] = []
                self.stack: list[_FuncInfo] = []

            def visit_ClassDef(inner, node):
                inner.scope.append(node.name)
                inner.generic_visit(node)
                inner.scope.pop()

            def visit_FunctionDef(inner, node):
                inner.scope.append(node.name)
                info = _FuncInfo(rel, ".".join(inner.scope), node)
                self.funcs[info.key] = info
                self.by_bare.setdefault(info.bare, []).append(info)
                inner.stack.append(info)
                inner.generic_visit(node)
                inner.stack.pop()
                inner.scope.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Lambda(inner, node):
                # lambdas belong to the enclosing function's body
                inner.generic_visit(node)

            def visit_Call(inner, node):
                name = _callee_bare_name(node)
                if name and inner.stack:
                    inner.stack[-1].calls.add(name)
                inner.generic_visit(node)

        V().visit(sf.tree)

    def _resolve(self, caller: _FuncInfo, bare: str) -> list[_FuncInfo]:
        if bare in STOPLIST:
            return []
        cands = self.by_bare.get(bare, [])
        if not cands:
            return []
        same_file = [c for c in cands if c.rel == caller.rel]
        return same_file or cands

    def reachable_from(self, seeds) -> set[tuple]:
        """BFS over name edges from an iterable of (rel, scope) keys (or
        FuncInfo); returns the reachable set of keys, seeds included."""
        work = []
        for s in seeds:
            info = s if isinstance(s, _FuncInfo) else self.funcs.get(tuple(s))
            if info is not None:
                work.append(info)
        seen = {f.key for f in work}
        while work:
            cur = work.pop()
            for bare in cur.calls:
                for nxt in self._resolve(cur, bare):
                    if nxt.key not in seen:
                        seen.add(nxt.key)
                        work.append(nxt)
        return seen

    def seeds_matching(self, rel: str, prefix: str) -> list[_FuncInfo]:
        return [
            f
            for f in self.funcs.values()
            if f.rel == rel and f.bare.startswith(prefix)
        ]
