"""Linter engine: file walking, suppressions, baseline, orchestration.

A Finding is identified across edits by a line-number-free FINGERPRINT
(rule + file + enclosing scope + normalized message + per-scope
occurrence index), so the checked-in baseline survives unrelated churn
above a grandfathered site.  The CLI (``python -m pilosa_tpu_torch.analysis``)
exits nonzero only on findings whose fingerprint is not baselined.

Suppression: a comment ``# analysis-ok: <rule>: <reason>`` on the
finding's line or the line directly above silences that site; the
reason is mandatory (an empty reason is itself a finding).
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field

RULES = (
    "lockstep-determinism",
    "lock-discipline",
    "stats-registry",
    "exception-hygiene",
    "deadline-propagation",
    "guarded-fields",
    "native-abi",
    "global-mutable-state",
    "check-then-act",
    "env-knob-outside-config",
    "stale-suppression",
)

# stale-suppression is engine-resident (it needs the post-suppression
# state of every other rule), not a rules.run_rule entry.
_ENGINE_RULES = ("stale-suppression",)

_SUPPRESS_RE = re.compile(r"#\s*analysis-ok:\s*([a-z-]+)\s*:\s*(.*)")


@dataclass
class Finding:
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    scope: str  # dotted enclosing def/class path, or "<module>"
    message: str
    suppressed: bool = False
    baselined: bool = False
    fingerprint: str = field(default="")

    def render(self) -> str:
        flag = " [baselined]" if self.baselined else (
            " [suppressed]" if self.suppressed else ""
        )
        return f"{self.rule}: {self.path}:{self.line} ({self.scope}) {self.message}{flag}"


@dataclass
class SourceFile:
    path: str  # absolute
    rel: str  # relative to scan root, forward slashes
    text: str
    tree: ast.AST
    # line -> (rule, reason) suppression comments
    suppressions: dict[int, tuple[str, str]]


def _scan_suppressions(text: str) -> dict[int, tuple[str, str]]:
    out: dict[int, tuple[str, str]] = {}
    try:
        toks = tokenize.generate_tokens(io.StringIO(text).readline)
        for tok in toks:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if m:
                out[tok.start[0]] = (m.group(1), m.group(2).strip())
    except tokenize.TokenError:  # pragma: no cover - unparseable file
        pass
    return out


def load_tree(root: str) -> list[SourceFile]:
    """Parse every .py file under ``root`` (the pilosa_tpu_torch package)."""
    files: list[SourceFile] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path, encoding="utf-8") as f:
                text = f.read()
            try:
                tree = ast.parse(text, filename=path)
            except SyntaxError:  # pragma: no cover - broken file
                continue
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            files.append(
                SourceFile(path, rel, text, tree, _scan_suppressions(text))
            )
    return files


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor tracking the dotted def/class scope path."""

    def __init__(self):
        self.scope: list[str] = []

    def scope_name(self) -> str:
        return ".".join(self.scope) or "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef


def apply_suppressions(findings: list[Finding], files: dict[str, SourceFile]) -> set:
    """Mark findings silenced by an ``analysis-ok`` comment on the same
    or the preceding line.  A matching comment with an EMPTY reason
    does not suppress (the reason is the point).  Returns the set of
    (path, comment line) suppressions that actually silenced something
    — the stale-suppression pass flags the rest."""
    used: set[tuple[str, int]] = set()
    for f in findings:
        sf = files.get(f.path)
        if sf is None:
            continue
        for line in (f.line, f.line - 1):
            sup = sf.suppressions.get(line)
            if sup and sup[0] == f.rule:
                # An empty-reason comment doesn't suppress, but it IS
                # attached to a live finding — stale-suppression must
                # not double-report what the empty reason already
                # surfaces as an unsuppressed finding.
                used.add((f.path, line))
                if sup[1]:
                    f.suppressed = True
                break
    return used


def stale_suppressions(
    files, used: set, active_rules: tuple
) -> list[Finding]:
    """Suppression comments whose rule fired nothing at their site: the
    tagged hazard was fixed or the code moved, and the rotting tag
    would silence the NEXT real finding there.  Only comments naming a
    rule in the active run are considered (a subset run must not call
    another rule's live tags stale); a comment naming an UNKNOWN rule
    is always a finding — it can never suppress anything."""
    out: list[Finding] = []
    for sf in files:
        for line, (rule, _reason) in sorted(sf.suppressions.items()):
            if rule == "stale-suppression":
                continue  # a meta-tag never fires "at" its own site
            known = rule in RULES
            if known and rule not in active_rules:
                continue
            if known and (sf.rel, line) in used:
                continue
            if known:
                msg = (
                    f"suppression `# analysis-ok: {rule}: ...` no longer "
                    "matches any finding at this site — the tagged hazard "
                    "was fixed or the code moved; delete the comment "
                    "(left in place it would silence the next real "
                    "finding here)"
                )
            else:
                msg = (
                    f"suppression names unknown rule `{rule}` — it can "
                    "never silence anything; fix the rule name or delete "
                    "the comment"
                )
            out.append(
                Finding("stale-suppression", sf.rel, line, "<suppression>", msg)
            )
    return out


def fingerprint_findings(findings: list[Finding]) -> None:
    """Stable ids: (rule, file, scope, normalized message) plus an
    occurrence index so N identical findings in one scope map to N
    distinct fingerprints (fixing one surfaces the regression if a
    new identical one appears)."""
    counts: dict[tuple, int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        key = (f.rule, f.path, f.scope, f.message)
        idx = counts.get(key, 0)
        counts[key] = idx + 1
        raw = "|".join((f.rule, f.path, f.scope, f.message, str(idx)))
        f.fingerprint = hashlib.sha256(raw.encode()).hexdigest()[:16]


# -- baseline ---------------------------------------------------------------


def baseline_path(root: str) -> str:
    return os.path.join(root, "analysis", "baseline.json")


def load_baseline(path: str) -> dict[str, dict]:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return data.get("entries", {})


def write_baseline(path: str, findings: list[Finding]) -> None:
    entries = {
        f.fingerprint: {
            "rule": f.rule,
            "file": f.path,
            "scope": f.scope,
            "message": f.message,
        }
        for f in findings
        if not f.suppressed
    }
    doc = {
        "comment": (
            "Grandfathered pre-existing findings; python -m "
            "pilosa_tpu_torch.analysis fails only on fingerprints not listed "
            "here. Regenerate with --write-baseline; prefer fixing or "
            "# analysis-ok: <rule>: <reason> suppressions over growing "
            "this file."
        ),
        "entries": dict(sorted(entries.items())),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")


def apply_baseline(findings: list[Finding], entries: dict[str, dict]) -> None:
    for f in findings:
        if not f.suppressed and f.fingerprint in entries:
            f.baselined = True


# -- orchestration ----------------------------------------------------------


def package_root() -> str:
    """The installed pilosa_tpu_torch package directory (the scan root)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_analysis(
    root: str | None = None,
    rules: tuple[str, ...] = RULES,
    baseline: str | None = None,
) -> list[Finding]:
    """Run the selected rules; returns ALL findings with suppressed /
    baselined flags applied.  New findings = neither flag set."""
    from pilosa_tpu_torch.analysis import rules as rulemod

    root = root or package_root()
    files = load_tree(root)
    by_rel = {sf.rel: sf for sf in files}
    findings: list[Finding] = []
    for rule in rules:
        if rule in _ENGINE_RULES:
            continue
        findings.extend(rulemod.run_rule(rule, files, root))
    used = apply_suppressions(findings, by_rel)
    if "stale-suppression" in rules:
        stale = stale_suppressions(files, used, rules)
        # Stale-suppression findings are themselves suppressible (the
        # one legitimate case: a tag kept for a flapping, platform-
        # dependent rule) — run the normal pass over just them.
        apply_suppressions(stale, by_rel)
        findings.extend(stale)
    fingerprint_findings(findings)
    bpath = baseline or baseline_path(root)
    apply_baseline(findings, load_baseline(bpath))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def new_findings(findings: list[Finding]) -> list[Finding]:
    return [f for f in findings if not f.suppressed and not f.baselined]
