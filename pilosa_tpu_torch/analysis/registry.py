"""Generated counters registry: every /debug/vars name in one place.

``generate_counters_registry`` scans the tree for stats emissions
(``<something stats-ish>.count/gauge/histogram/set/timing("name")``)
and renders COUNTERS.md — the one document dashboards can trust.
Dynamic names (f-strings) normalize to patterns: ``f"qos.shed.{cls}"``
becomes ``qos.shed.<cls>``.

The stats-registry rule checks both directions against the COMMITTED
file: an emitted name missing from the registry OR a registry that no
longer matches regeneration fails analysis with a regenerate hint — so
a new counter cannot land undocumented, and a typo'd name shows up as
a reviewable registry diff instead of silently vanishing from
dashboards.
"""

from __future__ import annotations

import ast
import os
import re

STAT_METHODS = ("count", "gauge", "histogram", "set", "timing")
_STATS_RECV_RE = re.compile(r"(?:\b|_)stats\b|NOP_STATS", re.IGNORECASE)

REGISTRY_NAME = "COUNTERS.md"

_HEADER = """# /debug/vars counters registry

<!-- GENERATED by `python -m pilosa_tpu_torch.analysis --write-registry`; do not edit by hand.
     The stats-registry rule fails analysis when this file drifts from the tree. -->

Every stats name the tree can emit, with the emission kind(s) and the
emitting module(s).  `<x>` marks a runtime-formatted segment (f-string
interpolation), e.g. a QoS class or replica group name.

| name | kinds | emitted from |
|---|---|---|
"""


class StatSite:
    __slots__ = ("name", "kind", "rel", "line", "scope", "dynamic")

    def __init__(self, name, kind, rel, line, scope, dynamic):
        self.name = name
        self.kind = kind
        self.rel = rel
        self.line = line
        self.scope = scope
        self.dynamic = dynamic


def _receiver_is_stats(node: ast.expr) -> bool:
    """True when the call receiver reads like a stats client: any
    segment of the attribute/call chain named *stats* (self.stats,
    stats, self._stats, NOP_STATS, self.stats.with_tags(...))."""
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - exotic receiver
        return False
    return bool(_STATS_RECV_RE.search(text))


def _name_pattern(arg: ast.expr) -> tuple[str, bool] | None:
    """Literal name, or f-string normalized to a <x> pattern; None when
    the name is not statically recoverable."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, False
    if isinstance(arg, ast.JoinedStr):
        parts = []
        for v in arg.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            elif isinstance(v, ast.FormattedValue):
                try:
                    hint = ast.unparse(v.value)
                except Exception:  # pragma: no cover
                    hint = "x"
                hint = re.sub(r"\W+", ".", hint).strip(".").split(".")[-1] or "x"
                parts.append(f"<{hint}>")
        return "".join(parts), True
    # "prefix" + var concatenation
    if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add):
        left = _name_pattern(arg.left)
        if left is not None:
            return left[0] + "<x>", True
    return None


def collect_stat_sites(files) -> tuple[list[StatSite], list]:
    """All statically-recoverable stats emissions, plus the sites whose
    name expression could not be recovered (reported by the rule)."""
    sites: list[StatSite] = []
    unresolved: list = []  # (rel, line, scope, kind)
    for sf in files:

        class V(ast.NodeVisitor):
            def __init__(self):
                self.scope: list[str] = []

            def _scope(self):
                return ".".join(self.scope) or "<module>"

            def visit_ClassDef(inner, node):
                inner.scope.append(node.name)
                inner.generic_visit(node)
                inner.scope.pop()

            def visit_FunctionDef(inner, node):
                inner.scope.append(node.name)
                inner.generic_visit(node)
                inner.scope.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Call(inner, node):
                fn = node.func
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in STAT_METHODS
                    and node.args
                    and _receiver_is_stats(fn.value)
                ):
                    got = _name_pattern(node.args[0])
                    if got is None:
                        unresolved.append(
                            (sf.rel, node.lineno, inner._scope(), fn.attr)
                        )
                    else:
                        name, dynamic = got
                        sites.append(
                            StatSite(
                                name, fn.attr, sf.rel, node.lineno,
                                inner._scope(), dynamic,
                            )
                        )
                inner.generic_visit(node)

        V().visit(sf.tree)
    return sites, unresolved


def render_registry(sites: list[StatSite]) -> str:
    rows: dict[str, tuple[set, set]] = {}
    for s in sites:
        kinds, mods = rows.setdefault(s.name, (set(), set()))
        kinds.add(s.kind)
        mods.add(s.rel)
    lines = [_HEADER]
    for name in sorted(rows):
        kinds, mods = rows[name]
        lines.append(
            f"| `{name}` | {', '.join(sorted(kinds))} | {', '.join(sorted(mods))} |\n"
        )
    return "".join(lines)


def registry_path(root: str) -> str:
    return os.path.join(root, "analysis", REGISTRY_NAME)


def registered_names(text: str) -> set[str]:
    return set(re.findall(r"^\| `([^`]+)` \|", text, re.MULTILINE))


def generate_counters_registry(root: str, files=None) -> str:
    """Render the registry for the tree at ``root`` (convenience entry
    used by --write-registry and the drift check)."""
    if files is None:
        from pilosa_tpu_torch.analysis.engine import load_tree

        files = load_tree(root)
    sites, _ = collect_stat_sites(files)
    return render_registry(sites)
