"""The project-invariant rules (generation 4: eleven of them).

Each rule returns Finding objects; the engine applies suppressions,
fingerprints, and the baseline.  See DEVELOPMENT.md ("Static analysis &
concurrency checking", "Race detection & native conformance", and
"Free-threading readiness") for the catalog and the rationale per rule.
(The twelfth check, ``stale-suppression``, lives in the engine itself:
it needs the post-suppression state of every other rule's findings.)
"""

from __future__ import annotations

import ast
import os

from pilosa_tpu_torch.analysis.callgraph import CallGraph
from pilosa_tpu_torch.analysis.engine import Finding
from pilosa_tpu_torch.analysis import registry as regmod

LOCKSTEP_ENTRY_FILE = "parallel/service.py"
LOCKSTEP_ENTRY_PREFIX = "_exec_batch"

# Budget-carrying hops: the executor→client edges forward a Deadline;
# the replica tier's forward paths (router._forward, the catch-up
# replay) forward either the remaining Deadline or an explicit socket
# bound (timeout_s) — a hop with neither resets the budget on the peer
# (or holds the sequencer lock for the full 30 s default timeout).
HOP_METHODS = ("execute_query", "execute_remote", "execute_remote_call",
               "_forward", "_replay_one")
DEADLINE_PARAMS = ("deadline", "opt", "opts", "options", "timeout_s")
# Keywords that count as forwarding the budget on a hop.
_BUDGET_KWARGS = ("deadline", "timeout_s")

_LOG_METHODS = ("warning", "error", "exception", "critical", "info", "debug")


def run_rule(rule: str, files, root: str) -> list[Finding]:
    fn = {
        "lockstep-determinism": rule_lockstep_determinism,
        "lock-discipline": rule_lock_discipline,
        "stats-registry": rule_stats_registry,
        "exception-hygiene": rule_exception_hygiene,
        "deadline-propagation": rule_deadline_propagation,
        "guarded-fields": rule_guarded_fields,
        "native-abi": rule_native_abi,
        "global-mutable-state": rule_global_mutable_state,
        "check-then-act": rule_check_then_act,
        "env-knob-outside-config": rule_env_knob_outside_config,
    }[rule]
    return fn(files, root)


# -- 1. lockstep-determinism ------------------------------------------------
#
# Every rank must resolve every decision identically: rank 0 decides,
# flags ride the wire (coalescing, expiry, sampling, epochs).  Rank-local nondeterminism in code reachable from the
# batch execution entry points is how that invariant silently breaks.


def _unparse(node: ast.expr) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover
        return ""


def _is_set_expr(node: ast.expr) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


class _DeterminismVisitor(ast.NodeVisitor):
    """Scans ONE function body (nested defs are their own call-graph
    nodes and scanned separately; lambdas are inlined here)."""

    def __init__(self, rel: str, scope: str, out: list):
        self.rel = rel
        self.scope = scope
        self.out = out
        self._top = True

    def _flag(self, node, msg: str) -> None:
        self.out.append(
            Finding("lockstep-determinism", self.rel, node.lineno, self.scope, msg)
        )

    def visit_FunctionDef(self, node):
        if self._top:
            self._top = False
            self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        pass

    def visit_Call(self, node: ast.Call) -> None:
        text = _unparse(node.func)
        if text in ("time.time", "time.time_ns"):
            self._flag(node, "rank-local wall clock (decide on rank 0, ship the flag)")
        elif text.startswith("random.") or text.startswith(("np.random.", "numpy.random.")):
            self._flag(node, f"unseeded module-level randomness ({text}) diverges across ranks")
        elif text.startswith(("uuid.", "secrets.")) or text == "os.urandom":
            self._flag(node, f"{text}() is rank-local entropy")
        elif text in ("os.getenv", "os.environ.get"):
            self._flag(node, "environment read: ranks may be launched with differing env")
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if _unparse(node.value) == "os.environ":
            self._flag(node, "environment read: ranks may be launched with differing env")
        self.generic_visit(node)

    def _check_iter(self, it: ast.expr) -> None:
        if _is_set_expr(it):
            self._flag(
                it,
                "iteration over a set: order depends on PYTHONHASHSEED and "
                "diverges across rank processes (sort it first)",
            )
        elif isinstance(it, ast.Call) and isinstance(it.func, ast.Name):
            if it.func.id in ("list", "tuple", "enumerate", "iter") and it.args \
                    and _is_set_expr(it.args[0]):
                self._flag(
                    it,
                    "set materialized in iteration order: order depends on "
                    "PYTHONHASHSEED across rank processes (sort it first)",
                )

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)

    def visit_comprehension(self, node) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)


def rule_lockstep_determinism(files, root: str) -> list[Finding]:
    graph = CallGraph(files)
    seeds = graph.seeds_matching(LOCKSTEP_ENTRY_FILE, LOCKSTEP_ENTRY_PREFIX)
    if not seeds:
        return []
    reachable = graph.reachable_from(seeds)
    out: list[Finding] = []
    for key in sorted(reachable):
        info = graph.funcs[key]
        _DeterminismVisitor(info.rel, info.scope, out).visit(info.node)
    return out


# -- 2. lock-discipline (static half) --------------------------------------
#
# The runtime half is lockcheck.py (PILOSA_TPU_LOCK_CHECK=1).  This
# half keeps its coverage honest: a raw threading primitive is a lock
# the checker cannot see.

_RAW_PRIMS = ("threading.Lock", "threading.RLock", "threading.Condition")
# lockcheck IS the instrumentation; sched.py is the interleaving
# explorer whose own machinery (baton semaphores, the SchedLock
# fall-through inners) must be invisible to the checker by
# construction — instrumenting the scheduler with itself would turn
# every grant into a yield point.
_EXEMPT_FILES = ("analysis/lockcheck.py", "analysis/sched.py")


def rule_lock_discipline(files, root: str) -> list[Finding]:
    out: list[Finding] = []
    for sf in files:
        if sf.rel in _EXEMPT_FILES:
            continue

        from pilosa_tpu_torch.analysis.engine import ScopedVisitor

        class V(ScopedVisitor):
            def visit_Call(inner, node):
                text = _unparse(node.func)
                if text in _RAW_PRIMS:
                    kind = text.rsplit(".", 1)[-1]
                    factory = {
                        "Lock": "named_lock",
                        "RLock": "named_rlock",
                        "Condition": "named_condition",
                    }[kind]
                    out.append(
                        Finding(
                            "lock-discipline", sf.rel, node.lineno,
                            inner.scope_name(),
                            f"raw threading.{kind}() invisible to the lock "
                            f"checker; use lockcheck.{factory}(\"<name>\")",
                        )
                    )
                inner.generic_visit(node)

        V().visit(sf.tree)
    return out


# -- 3. stats-registry ------------------------------------------------------


def rule_stats_registry(files, root: str) -> list[Finding]:
    out: list[Finding] = []
    sites, unresolved = regmod.collect_stat_sites(files)
    rpath = regmod.registry_path(root)
    rel_reg = "analysis/" + regmod.REGISTRY_NAME
    if not os.path.exists(rpath):
        out.append(
            Finding(
                "stats-registry", rel_reg, 1, "<registry>",
                "counters registry missing; generate it with "
                "`python -m pilosa_tpu_torch.analysis --write-registry`",
            )
        )
        return out
    with open(rpath, encoding="utf-8") as f:
        committed = f.read()
    names = regmod.registered_names(committed)
    for s in sites:
        if s.name not in names:
            out.append(
                Finding(
                    "stats-registry", s.rel, s.line, s.scope,
                    f"stats name `{s.name}` not in the counters registry — "
                    "typo, or regenerate with `python -m pilosa_tpu_torch.analysis "
                    "--write-registry`",
                )
            )
    for rel, line, scope, kind in unresolved:
        out.append(
            Finding(
                "stats-registry", rel, line, scope,
                f"stats .{kind}() name is not statically recoverable; use a "
                "literal or f-string so the registry can document it",
            )
        )
    # Exposition drift gate: /metrics names derive MECHANICALLY from
    # these registry names (metrics.prom_name), so the only ways the
    # exposition can drift from the registry are a registered series
    # whose mangled form is not a valid Prometheus metric name, or two
    # DISTINCT registered series colliding onto one mangled name.
    from pilosa_tpu_torch import metrics as metrics_mod

    kinds_by_name: dict[str, str] = {}
    for s in sites:
        k = "counter" if s.kind == "count" else s.kind
        # A name emitted as both a counter and something else maps with
        # its counter suffix (_total widens the namespace, so prefer it
        # for the collision check).
        if kinds_by_name.get(s.name) != "counter":
            kinds_by_name[s.name] = k
    for a, b, prom in metrics_mod.registry_collisions(kinds_by_name):
        if not b:
            out.append(
                Finding(
                    "stats-registry", rel_reg, 1, "<exposition>",
                    f"stats name `{a}` renders an invalid Prometheus "
                    f"metric name `{prom}` at /metrics — rename the series",
                )
            )
        else:
            out.append(
                Finding(
                    "stats-registry", rel_reg, 1, "<exposition>",
                    f"stats names `{a}` and `{b}` collide at /metrics as "
                    f"`{prom}` — rename one of them",
                )
            )
    regenerated = regmod.render_registry(sites)
    if regenerated != committed:
        added = sorted(regmod.registered_names(regenerated) - names)
        removed = sorted(names - regmod.registered_names(regenerated))
        detail = []
        if added:
            detail.append(f"missing from registry: {', '.join(added[:6])}")
        if removed:
            detail.append(f"stale in registry: {', '.join(removed[:6])}")
        out.append(
            Finding(
                "stats-registry", rel_reg, 1, "<registry>",
                "counters registry is stale ("
                + ("; ".join(detail) or "formatting drift")
                + ") — regenerate with `python -m pilosa_tpu_torch.analysis "
                "--write-registry` and commit the diff",
            )
        )
    return out


# -- 4. exception-hygiene ---------------------------------------------------
#
# The syncer once skipped peers silently in five places; this rule
# stops the pattern recurring: a broad handler must leave a trace — a
# stat, a log line, a re-raise, USE of the caught exception (collected,
# returned to the caller, ...), or an explicit analysis-ok tag.


def _body_has_raise(body) -> bool:
    for node in body:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Raise):
                return True
    return False


def _body_uses_name(body, name: str) -> bool:
    if not name:
        return False
    for node in body:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and sub.id == name:
                return True
    return False


def _body_records(body) -> bool:
    """A stats emission, a logging-ish call, or a recording helper
    (``self._note_peer_error(...)``-style ``_note_*`` methods, the
    project idiom for counted skips) anywhere in the handler."""
    for node in body:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            fn = sub.func
            if isinstance(fn, ast.Attribute):
                if fn.attr in regmod.STAT_METHODS and regmod._receiver_is_stats(fn.value):
                    return True
                if fn.attr in _LOG_METHODS or fn.attr == "print_exc":
                    return True
                if fn.attr.startswith("_note"):
                    return True
            elif isinstance(fn, ast.Name) and fn.id == "print":
                return True
    return False


def _is_broad_handler(h: ast.ExceptHandler) -> bool:
    t = h.type
    if t is None:
        return True  # bare except:
    if isinstance(t, ast.Name):
        return t.id in ("Exception", "BaseException")
    if isinstance(t, ast.Tuple):
        return any(
            isinstance(e, ast.Name) and e.id in ("Exception", "BaseException")
            for e in t.elts
        )
    return False


def rule_exception_hygiene(files, root: str) -> list[Finding]:
    out: list[Finding] = []
    for sf in files:
        if sf.rel.startswith("analysis/"):
            continue

        from pilosa_tpu_torch.analysis.engine import ScopedVisitor

        class V(ScopedVisitor):
            def visit_ExceptHandler(inner, node):
                if _is_broad_handler(node) and not (
                    _body_has_raise(node.body)
                    or _body_uses_name(node.body, node.name)
                    or _body_records(node.body)
                ):
                    out.append(
                        Finding(
                            "exception-hygiene", sf.rel, node.lineno,
                            inner.scope_name(),
                            "broad except swallows the error with no stat, "
                            "log, re-raise, or use of the exception — count "
                            "it or tag the site",
                        )
                    )
                inner.generic_visit(node)

        V().visit(sf.tree)
    return out


# -- 5. deadline-propagation ------------------------------------------------
#
# The deadline contract: every hop forwards the REMAINING budget.  A function
# that holds a deadline (parameter or ExecOptions) and performs an HTTP
# hop without `deadline=` silently resets the budget on the peer.


class _DeadlineVisitor(ast.NodeVisitor):
    def __init__(self, rel: str, out: list):
        self.rel = rel
        self.out = out
        self.scope: list[str] = []

    def visit_ClassDef(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def visit_FunctionDef(self, node):
        self.scope.append(node.name)
        args = node.args
        names = [
            a.arg
            for a in (
                args.posonlyargs + args.args + args.kwonlyargs
                + ([args.vararg] if args.vararg else [])
                + ([args.kwarg] if args.kwarg else [])
            )
        ]
        has_deadline = any(n in DEADLINE_PARAMS for n in names)
        if not has_deadline:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Attribute) and sub.attr == "deadline":
                    has_deadline = True
                    break
        if has_deadline:
            scope = ".".join(self.scope)
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                fn = sub.func
                if not (isinstance(fn, ast.Attribute) and fn.attr in HOP_METHODS):
                    continue
                kw_names = {k.arg for k in sub.keywords}
                if not kw_names.intersection(_BUDGET_KWARGS) and None not in kw_names:
                    self.out.append(
                        Finding(
                            "deadline-propagation", self.rel, sub.lineno, scope,
                            f".{fn.attr}(...) hop without deadline= (or "
                            "timeout_s= on the replica forward paths) — the "
                            "peer restarts the budget instead of inheriting "
                            "the remaining one",
                        )
                    )
        self.generic_visit(node)
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef


def rule_deadline_propagation(files, root: str) -> list[Finding]:
    out: list[Finding] = []
    for sf in files:
        if sf.rel.startswith("analysis/"):
            continue
        _DeadlineVisitor(sf.rel, out).visit(sf.tree)
    return out


# -- 6. guarded-fields (static half of the lockset race detector) ------------
#
# lockcheck's runtime half sees attribute REBINDS under the enabled
# checker; this half covers what setattr interception cannot — in-place
# container mutation (`self._store.pop(...)`, `self._transfers[k] = v`)
# — and what a test run may never execute.  A field declared in
# ``_guarded_by_`` that is mutated in a method with NO named-lock
# acquisition anywhere on its intra-package call paths is a finding.
#
# Over-approximation notes (both directions documented): lock
# acquisition is matched by NAME SHAPE (`with self.<lock-ish attr>` /
# `.acquire()` where the attribute looks like a lock: contains "mu",
# "lock", "cv", or "cond"), not by lock identity — a caller holding a
# DIFFERENT `_mu` shadows a real miss (fewer findings, same honesty
# trade as the callgraph stoplist); reachability is the same name-based
# call graph, so an unreachable-looking mutator errs toward MORE
# findings, absorbed by suppressions.  Lifecycle methods (`__init__`,
# `open`, `close`, context-manager plumbing) are exempt — the static
# analog of the runtime init-phase single-thread exemption.

_LIFECYCLE_EXEMPT = ("__init__", "__new__", "__enter__", "__exit__",
                     "open", "close")

# Method names that mutate their receiver in place.
_MUTATOR_METHODS = frozenset({
    "pop", "popitem", "clear", "update", "setdefault", "append", "extend",
    "insert", "remove", "discard", "add", "move_to_end", "sort", "reverse",
})

_LOCKISH_RE = None  # compiled lazily (module import cost)


def _is_lockish_name(name: str) -> bool:
    global _LOCKISH_RE
    if _LOCKISH_RE is None:
        import re

        _LOCKISH_RE = re.compile(r"mu|lock|cv|cond", re.IGNORECASE)
    return bool(_LOCKISH_RE.search(name))


def _acquires_lock(fn_node: ast.AST) -> bool:
    """Does this function body acquire something lock-shaped — a
    ``with`` over a lock-ish attribute/name (conditions included) or an
    explicit ``.acquire()`` call?"""
    for sub in ast.walk(fn_node):
        if isinstance(sub, (ast.With, ast.AsyncWith)):
            for item in sub.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    expr = expr.func
                last = None
                if isinstance(expr, ast.Attribute):
                    last = expr.attr
                elif isinstance(expr, ast.Name):
                    last = expr.id
                if last and _is_lockish_name(last):
                    return True
        elif isinstance(sub, ast.Call):
            fn = sub.func
            if isinstance(fn, ast.Attribute) and fn.attr == "acquire":
                return True
    return False


def _collect_guarded_decls(sf) -> list[tuple[str, dict]]:
    """(class name, {field: lockname}) for every class in the file with
    a literal ``_guarded_by_`` dict."""
    out = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for stmt in node.body:
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id == "_guarded_by_"
                and isinstance(stmt.value, ast.Dict)
            ):
                decl = {}
                for k, v in zip(stmt.value.keys, stmt.value.values):
                    if (
                        isinstance(k, ast.Constant) and isinstance(k.value, str)
                        and isinstance(v, ast.Constant) and isinstance(v.value, str)
                    ):
                        decl[k.value] = v.value
                if decl:
                    out.append((node.name, decl))
    return out


def _guarded_mutations(cls_node: ast.ClassDef, fields):
    """(method node, field, kind, lineno) for every mutation of a
    declared field inside the class body.  ``kind`` is 'rebind' /
    'item' / 'call'."""
    hits = []

    def field_of(expr) -> str | None:
        # self.<field>  or  self.<field>[...]
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in fields
        ):
            return expr.attr
        return None

    for stmt in cls_node.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Assign):
                for tgt in sub.targets:
                    f = field_of(tgt)
                    if f:
                        kind = "item" if isinstance(tgt, ast.Subscript) else "rebind"
                        hits.append((stmt, f, kind, sub.lineno))
            elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                f = field_of(sub.target)
                if f:
                    kind = "item" if isinstance(sub.target, ast.Subscript) else "rebind"
                    hits.append((stmt, f, kind, sub.lineno))
            elif isinstance(sub, ast.Delete):
                for tgt in sub.targets:
                    f = field_of(tgt)
                    if f:
                        hits.append((stmt, f, "item", sub.lineno))
            elif isinstance(sub, ast.Call):
                fn = sub.func
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in _MUTATOR_METHODS
                ):
                    f = field_of(fn.value)
                    if f:
                        hits.append((stmt, f, "call", sub.lineno))
    return hits


def rule_guarded_fields(files, root: str) -> list[Finding]:
    graph = CallGraph(files)
    # Functions (by callgraph key) that acquire a lock-shaped object.
    locked: set[tuple] = set()
    for key, info in graph.funcs.items():
        if _acquires_lock(info.node):
            locked.add(key)
    # Reverse name-based edges: callee key -> caller keys.
    rev: dict[tuple, set] = {}
    for key, info in graph.funcs.items():
        for bare in info.calls:
            for callee in graph._resolve(info, bare):
                rev.setdefault(callee.key, set()).add(key)

    def any_locked_path(key: tuple) -> bool:
        """True when the method, or ANY transitive caller chain within
        the package, acquires a lock — or when a chain originates in a
        lifecycle method (`__init__`/`open`/...): the static analog of
        the runtime detector's init-phase single-thread exemption."""
        seen = {key}
        work = [key]
        while work:
            cur = work.pop()
            if cur in locked:
                return True
            info = graph.funcs.get(cur)
            if info is not None and cur != key and info.bare in _LIFECYCLE_EXEMPT:
                return True
            for caller in rev.get(cur, ()):
                if caller not in seen:
                    seen.add(caller)
                    work.append(caller)
        return False

    out: list[Finding] = []
    for sf in files:
        if sf.rel.startswith("analysis/"):
            continue
        decls = _collect_guarded_decls(sf)
        if not decls:
            continue
        by_name = {d[0]: d[1] for d in decls}
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef) or node.name not in by_name:
                continue
            fields = by_name[node.name]
            for meth, field, kind, lineno in _guarded_mutations(node, fields):
                if meth.name in _LIFECYCLE_EXEMPT:
                    continue
                key = (sf.rel, f"{node.name}.{meth.name}")
                if key not in graph.funcs:
                    continue  # nested beyond the graph's scope
                if any_locked_path(key):
                    continue
                out.append(
                    Finding(
                        "guarded-fields", sf.rel, lineno,
                        f"{node.name}.{meth.name}",
                        f"`self.{field}` is declared guarded by "
                        f"`{fields[field]}` but this {kind} mutation has no "
                        "named-lock acquisition on any call path — take the "
                        "lock (or document why the site is exempt)",
                    )
                )
    return out


# -- 7. native-abi -----------------------------------------------------------
#
# The ctypes bridge is ~30 hand-declared signatures where drift is
# memory corruption, not an exception (the 22-argument pn_write_batch
# being the worst case).  analysis/abi.py reduces the extern "C"
# definitions, the argtypes/restype table, and the .so's export list to
# width-class tuples and fails on any missing symbol, arity mismatch,
# or width mismatch.  Findings anchor at the native.py declaration.

NATIVE_PY_REL = "native.py"
NATIVE_CPP_NAME = "pilosa_native.cpp"
NATIVE_SO_NAME = "libpilosa_native.so"


def rule_native_abi(files, root: str) -> list[Finding]:
    from pilosa_tpu_torch.analysis import abi

    if not any(sf.rel == NATIVE_PY_REL for sf in files):
        return []  # tree without a native bridge (fixture packages)
    native_dir = os.path.join(os.path.dirname(os.path.abspath(root)), "native")
    cpp = os.path.join(native_dir, NATIVE_CPP_NAME)
    if not os.path.exists(cpp):
        return []  # source-only install: nothing to conform against
    so = os.path.join(native_dir, NATIVE_SO_NAME)
    out: list[Finding] = []
    for issue in abi.check_abi(cpp, os.path.join(root, NATIVE_PY_REL),
                               so_path=so):
        out.append(
            Finding(
                "native-abi", NATIVE_PY_REL, issue.line, issue.name,
                issue.message,
            )
        )
    return out


# -- 8/9. the GIL-dependence analyzer (generation 3) --------------------------
#
# Both hot lanes now do their heavy lifting GIL-released; the next
# multiplier is free-threaded or multi-worker serving (ROADMAP item 2),
# and that refactor is only safe once every place the code silently
# relies on the GIL is found.  Two rules split the hazard space:
#
# ``global-mutable-state`` — a module-level container binding that some
# function mutates at runtime has no lock contract at all: under the
# GIL each individual dict op is atomic, free-threaded it is a torn
# structure.  The fix the finding points at is the
# ``lockcheck.named_global`` registered-memo seam (bounded, lock-named,
# lockset-detector-fed), freezing the binding at import, or a reasoned
# suppression.
#
# ``check-then-act`` — a compound test-then-use on SHARED state
# (``if k in d: d[k]``, ``d.get(k)`` ... ``d[k] = ``, ``d.setdefault``,
# ``self.f += 1``) is atomic only because the GIL never switches
# threads mid-statement-pair.  Scope: functions reachable from the
# handler/lockstep/router entry points through a chain that never
# acquires a lock (the same name-based graph guarded-fields uses);
# receivers limited to ``self.<attr>`` and module-level globals (locals
# are thread-private by construction).
#
# Both rules share the documented over-approximation trades: name-based
# reachability errs toward MORE findings (absorbed by suppressions);
# the function-wide lock-acquisition check errs toward FEWER (a
# function locking ANYTHING anywhere exempts all its shapes — the same
# honesty trade as guarded-fields' lock-name shape matching).
# ``self.stat_*`` read-modify-writes are exempt by convention: the
# project's approximate counters lose increments under free threading,
# never correctness, and the convention is inventoried in
# DEVELOPMENT.md ("Free-threading readiness").

# Entry files whose every function is a seed: each is executed by a
# distinct thread population in a serving process (HTTP worker threads,
# lockstep rank threads, router probe/forward threads).
SERVING_ENTRY_FILES = ("server/handler.py", "parallel/service.py",
                       "replica/router.py")

_MUTABLE_FACTORIES = frozenset({
    "dict", "list", "set", "bytearray", "OrderedDict", "defaultdict",
    "deque", "Counter", "WeakKeyDictionary", "WeakValueDictionary",
})


def _serving_reachable(graph: CallGraph) -> set[tuple]:
    """Forward-reachable set from every serving entry function, with
    lifecycle methods excluded from the SEEDS (construction/open run
    once on one thread) but not from traversal."""
    seeds = []
    for rel in SERVING_ENTRY_FILES:
        seeds.extend(
            f for f in graph.seeds_matching(rel, "")
            if f.bare not in _LIFECYCLE_EXEMPT
        )
    if not seeds:
        return set()
    return graph.reachable_from(seeds)


def _module_mutable_bindings(sf) -> dict[str, int]:
    """Module-level ``name = <mutable container>`` bindings: dict/list/
    set displays and comprehensions, and the stdlib container factory
    calls.  A binding whose RHS is ``lockcheck.named_global(...)`` is
    the sanctioned seam and is not a container display, so it never
    becomes a candidate."""
    out: dict[str, int] = {}
    for stmt in sf.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            tgt, value = stmt.targets[0], stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            tgt, value = stmt.target, stmt.value
        else:
            continue
        if not isinstance(tgt, ast.Name):
            continue
        mutable = isinstance(
            value, (ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp,
                    ast.SetComp)
        )
        if not mutable and isinstance(value, ast.Call):
            fn = value.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else ""
            )
            mutable = name in _MUTABLE_FACTORIES
        if mutable:
            out[tgt.id] = stmt.lineno
    return out


def _global_mutations(fn_node: ast.AST, names) -> list[tuple[str, str, int]]:
    """(name, kind, lineno) for every runtime mutation of a module-level
    binding inside one function body: item stores/deletes, in-place
    mutator calls, and ``global``-declared rebinds/augments."""
    declared_global: set[str] = set()
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Global):
            declared_global.update(n for n in sub.names if n in names)
    hits: list[tuple[str, str, int]] = []

    def bare(expr) -> str | None:
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        if isinstance(expr, ast.Name) and expr.id in names:
            return expr.id
        return None

    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Assign):
            for tgt in sub.targets:
                if isinstance(tgt, ast.Subscript):
                    n = bare(tgt)
                    if n:
                        hits.append((n, "item", sub.lineno))
                elif isinstance(tgt, ast.Name) and tgt.id in declared_global:
                    hits.append((tgt.id, "rebind", sub.lineno))
        elif isinstance(sub, ast.AugAssign):
            if isinstance(sub.target, ast.Subscript):
                n = bare(sub.target)
                if n:
                    hits.append((n, "item", sub.lineno))
            elif (isinstance(sub.target, ast.Name)
                  and sub.target.id in declared_global):
                hits.append((sub.target.id, "rebind", sub.lineno))
        elif isinstance(sub, ast.Delete):
            for tgt in sub.targets:
                if isinstance(tgt, ast.Subscript):
                    n = bare(tgt)
                    if n:
                        hits.append((n, "item", sub.lineno))
        elif isinstance(sub, ast.Call):
            fn = sub.func
            if isinstance(fn, ast.Attribute) and fn.attr in _MUTATOR_METHODS:
                n = bare(fn.value)
                if n:
                    hits.append((n, "call", sub.lineno))
    return hits


def rule_global_mutable_state(files, root: str) -> list[Finding]:
    graph = CallGraph(files)
    reachable = _serving_reachable(graph)
    out: list[Finding] = []
    for sf in files:
        if sf.rel.startswith("analysis/"):
            continue
        bindings = _module_mutable_bindings(sf)
        if not bindings:
            continue
        # name -> first serving-reachable mutation (scope, kind, line)
        witness: dict[str, tuple[str, str, int]] = {}
        for key, info in sorted(graph.funcs.items()):
            if info.rel != sf.rel or key not in reachable:
                continue
            for name, kind, lineno in _global_mutations(info.node, bindings):
                if name not in witness:
                    witness[name] = (info.scope, kind, lineno)
        for name in sorted(witness):
            scope, kind, lineno = witness[name]
            out.append(
                Finding(
                    "global-mutable-state", sf.rel, bindings[name], "<module>",
                    f"module-level mutable `{name}` is mutated at runtime "
                    f"({kind} in {scope}:{lineno}, serving-reachable) with no "
                    "lock contract — a free-threaded host tears it: freeze "
                    "it at import, register it via lockcheck.named_global("
                    "...), or tag why it is safe",
                )
            )
    return out


class _CheckThenActVisitor(ast.NodeVisitor):
    """Scans ONE function body for compound test-then-use shapes on
    shared receivers (``self.<attr>`` / module globals).  Nested defs
    are their own call-graph nodes; their hits are deduped by line."""

    def __init__(self, rel: str, scope: str, module_names, out: list):
        self.rel = rel
        self.scope = scope
        self.module_names = module_names
        self.out = out
        self._gets: dict[str, int] = {}       # recv text -> first .get line
        self._stores: dict[str, int] = {}     # recv text -> first d[k]= line

    def _recv(self, expr) -> str | None:
        """Shared-receiver filter: self.<attr> or a module-level name.
        Lock-ish receivers are the serialization mechanism itself."""
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and not _is_lockish_name(expr.attr)
        ):
            return f"self.{expr.attr}"
        if isinstance(expr, ast.Name) and expr.id in self.module_names:
            return expr.id
        return None

    def _flag(self, lineno: int, msg: str) -> None:
        self.out.append(
            Finding("check-then-act", self.rel, lineno, self.scope, msg)
        )

    def visit_If(self, node: ast.If) -> None:
        test = node.test
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test = test.operand
        if (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.ops[0], (ast.In, ast.NotIn))
        ):
            recv = self._recv(test.comparators[0])
            if recv is not None:
                # Either branch acting on the tested receiver is the
                # race: `if k in d: use d[k]` reads an entry a peer can
                # delete; `if k not in d: d[k] = ...` double-fills.
                hit = False
                for stmt in node.body + node.orelse:
                    for sub in ast.walk(stmt):
                        if (
                            isinstance(sub, ast.Subscript)
                            and self._recv(sub.value) == recv
                        ):
                            hit = True
                            break
                    if hit:
                        break
                if hit:
                    self._flag(
                        node.lineno,
                        f"membership test on `{recv}` guards a subscript "
                        "use — the entry can appear/vanish between test "
                        "and use without the GIL; hold a named lock "
                        "across the pair (or use one atomic operation)",
                    )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            recv = self._recv(fn.value)
            if recv is not None:
                if fn.attr == "setdefault":
                    self._flag(
                        node.lineno,
                        f"`{recv}.setdefault(...)` on shared state — the "
                        "default may be constructed and inserted twice "
                        "free-threaded; hold a named lock across the "
                        "lookup-or-create",
                    )
                elif fn.attr == "get":
                    self._gets.setdefault(recv, node.lineno)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript):
                recv = self._recv(tgt.value)
                if recv is not None:
                    self._stores.setdefault(recv, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        tgt = node.target
        if isinstance(tgt, ast.Subscript):
            recv = self._recv(tgt.value)
            if recv is not None:
                self._stores.setdefault(recv, node.lineno)
        elif isinstance(tgt, ast.Attribute):
            recv = self._recv(tgt)
            # self.stat_* counters are approximate by convention
            # (inventoried in DEVELOPMENT.md): a torn increment loses a
            # count, never correctness.
            if recv is not None and not tgt.attr.startswith("stat"):
                self._flag(
                    node.lineno,
                    f"unlocked read-modify-write of shared `{recv}` — the "
                    "load and store can interleave with another thread's "
                    "free-threaded; hold a named lock (approximate stat_* "
                    "counters are the documented exception)",
                )
        self.generic_visit(node)

    def finish(self) -> None:
        """Pair the recorded .get() probes with item stores on the same
        receiver: the with_tags-style lazy-singleton shape."""
        for recv, gline in sorted(self._gets.items()):
            if recv in self._stores:
                self._flag(
                    gline,
                    f"`{recv}.get(...)` at line {gline} paired with "
                    f"`{recv}[...] = ` at line {self._stores[recv]} — the "
                    "get-then-store races free-threaded (two threads both "
                    "miss, both store); hold a named lock across the pair",
                )


def rule_check_then_act(files, root: str) -> list[Finding]:
    graph = CallGraph(files)
    reachable = _serving_reachable(graph)
    out: list[Finding] = []
    for sf in files:
        if sf.rel.startswith("analysis/"):
            continue
        module_names = _module_mutable_bindings(sf)
        raw: list[Finding] = []
        seen_lines: set[int] = set()
        for key, info in sorted(graph.funcs.items()):
            if info.rel != sf.rel or key not in reachable:
                continue
            if info.bare in _LIFECYCLE_EXEMPT:
                continue
            if _acquires_lock(info.node):
                # The function serializes SOMETHING itself; its compound
                # shapes are assumed covered (documented fewer-findings
                # trade — same shape-matching honesty as guarded-fields).
                continue
            v = _CheckThenActVisitor(sf.rel, info.scope, module_names, raw)
            v.visit(info.node)
            v.finish()
        for f in raw:
            # Nested defs re-walk enclosing statements: keep the first
            # finding per line.
            if f.line not in seen_lines:
                seen_lines.add(f.line)
                out.append(f)
    return out


# -- 10. env-knob-outside-config (generation 4) -------------------------------
#
# The knob-plumbing contract: every tuning knob that
# ``config.py`` owns flows CLI > env > config file > default through a
# Config field and arrives at its consumer as a constructor argument.
# A raw ``os.environ`` read of an owned knob anywhere else creates a
# second, precedence-free spelling that silently shadows the config
# file — exactly the drift the unification removed.  The owned set is
# DERIVED from config.py's own env reads (no second list to maintain):
# add a knob to ``Config.apply_env`` and every stray read of it
# becomes a finding.  Deliberate exceptions carry suppressions: the
# executor's deprecated direct-construction fallbacks, and the
# lockstep service's rank-process reads (ranks inherit the launcher's
# env wholesale; no config file is plumbed to them).  Gate/diagnostic
# variables config.py does not read (PILOSA_TPU_LOCK_CHECK,
# PILOSA_TPU_FAULT_SPEC, ...) are out of scope by construction.

CONFIG_REL = "config.py"
_ENV_GET_CALLS = ("os.getenv", "os.environ.get")


def _env_read_name(node: ast.AST) -> str | None:
    """The constant env-var name a node reads, or None: matches
    ``os.getenv("X")`` / ``os.environ.get("X"[, d])`` /
    ``os.environ["X"]``."""
    if isinstance(node, ast.Call):
        if _unparse(node.func) in _ENV_GET_CALLS and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                return arg.value
    elif isinstance(node, ast.Subscript):
        if _unparse(node.value) == "os.environ":
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                return sl.value
    return None


def _config_owned_knobs(sf) -> set[str]:
    """Constant PILOSA_TPU_* names config.py consumes.  Config reads
    env through ``apply_env``'s injected mapping (``env["X"]``,
    ``"X" in env``, ``env.get("X")``) as well as ``os.environ``
    directly; match all four shapes."""

    def const_str(expr) -> str | None:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        return None

    out: set[str] = set()
    for node in ast.walk(sf.tree):
        name = _env_read_name(node)
        if name is None:
            if isinstance(node, ast.Subscript) and _unparse(node.value) == "env":
                name = const_str(node.slice)
            elif (
                isinstance(node, ast.Call)
                and _unparse(node.func) == "env.get"
                and node.args
            ):
                name = const_str(node.args[0])
            elif (
                isinstance(node, ast.Compare)
                and len(node.ops) == 1
                and isinstance(node.ops[0], (ast.In, ast.NotIn))
                and _unparse(node.comparators[0]) == "env"
            ):
                name = const_str(node.left)
        if name and name.startswith("PILOSA_TPU_"):
            out.add(name)
    return out


def rule_env_knob_outside_config(files, root: str) -> list[Finding]:
    owned: set[str] = set()
    for sf in files:
        if sf.rel == CONFIG_REL:
            owned = _config_owned_knobs(sf)
            break
    if not owned:
        return []  # tree without a config module (fixture packages)
    out: list[Finding] = []
    for sf in files:
        if sf.rel == CONFIG_REL or sf.rel.startswith("analysis/"):
            continue

        from pilosa_tpu_torch.analysis.engine import ScopedVisitor

        class V(ScopedVisitor):
            def _check(inner, node):
                name = _env_read_name(node)
                if name in owned:
                    out.append(
                        Finding(
                            "env-knob-outside-config", sf.rel, node.lineno,
                            inner.scope_name(),
                            f"raw environment read of `{name}` — a "
                            "config-owned tuning knob (CLI > env > config "
                            "file > default); take it as a constructor/"
                            "Config value, or tag the deprecated fallback",
                        )
                    )

            def visit_Call(inner, node):
                inner._check(node)
                inner.generic_visit(node)

            def visit_Subscript(inner, node):
                inner._check(node)
                inner.generic_visit(node)

        V().visit(sf.tree)
    return out
