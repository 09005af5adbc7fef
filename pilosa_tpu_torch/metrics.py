"""Prometheus text exposition for the expvar stats registry.

No reference analog — the reference exposes /debug/vars JSON only.  This
module renders everything an ExpvarStatsClient holds in the Prometheus
text format (``text/plain; version=0.0.4``), served at ``/metrics`` by
the server handler, the replica router, and the lockstep front end.

The metric-name mapping is MECHANICAL, so it can be checked statically:
every series name in the ``COUNTERS.md`` registry maps through
:func:`prom_name` — lowercase the expvar name, replace every character
outside ``[a-zA-Z0-9_]`` with ``_``, collapse runs, prefix ``pilosa_``,
and append ``_total`` for counters.  The stats-registry analysis rule
(``analysis/rules.py:rule_stats_registry``) runs the same mapping over
the registry and fails when a registered series would render an invalid
Prometheus name or two distinct series would collide after mangling —
the registry gate now covers the exposition, so ``/metrics`` and
``COUNTERS.md`` cannot drift silently.

Tag handling: the expvar client stores tagged series under
``name[tag1,tag2]`` keys with ``key:value`` tags (``index:foo``);
:func:`split_key` turns that suffix into Prometheus labels.  Histograms
and timings render as summaries (quantile samples from the bounded
reservoir plus exact ``_count``/``_sum``).  Sets render as a gauge ``1``
with the string value as a ``value`` label (Prometheus has no string
samples).

:func:`parse_exposition` is a strict parser/validator for the text
format — the bench preflight and the exposition tests scrape
``/metrics`` and fail on anything unparseable.
"""

from __future__ import annotations

import math
import re
from typing import Optional

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

PREFIX = "pilosa_"

_MANGLE_RX = re.compile(r"[^a-zA-Z0-9_]+")
_VALID_METRIC_RX = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_VALID_LABEL_RX = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# One sample line: name, optional {labels}, value, optional timestamp.
_SAMPLE_RX = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{([^}]*)\})?"                       # optional label set
    r"\s+(\S+)"                               # value
    r"(?:\s+(-?\d+))?$"                       # optional timestamp (ms)
)
_LABEL_RX = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def prom_name(name: str, kind: str = "") -> str:
    """The mechanical expvar-series -> Prometheus-metric-name mapping.

    ``qcache.hit`` -> ``pilosa_qcache_hit_total`` (counters get the
    conventional ``_total`` suffix); ``qos.latency_ms.read`` ->
    ``pilosa_qos_latency_ms_read``.  Registry placeholder segments like
    ``<cls>`` mangle to plain ``cls`` so registered patterns stay valid
    names for the drift gate."""
    base = _MANGLE_RX.sub("_", name.strip().lower()).strip("_")
    base = re.sub(r"__+", "_", base)
    out = PREFIX + base
    if kind == "counter":
        out += "_total"
    return out


def valid_metric_name(name: str) -> bool:
    return bool(_VALID_METRIC_RX.match(name))


def split_key(key: str) -> tuple[str, dict[str, str]]:
    """Split an expvar map key ``name[tag1,tag2]`` into (base name,
    labels).  Tags are ``key:value`` strings (``index:foo``); a bare tag
    with no colon becomes a ``tag`` label.  Duplicate label keys keep
    the last value (tags are sorted/deduped upstream)."""
    if not key.endswith("]"):
        return key, {}
    i = key.find("[")
    if i < 0:
        return key, {}
    base, raw = key[:i], key[i + 1 : -1]
    labels: dict[str, str] = {}
    for tag in raw.split(","):
        tag = tag.strip()
        if not tag:
            continue
        k, sep, v = tag.partition(":")
        if not sep:
            k, v = "tag", tag
        k = _MANGLE_RX.sub("_", k.strip().lower()).strip("_") or "tag"
        labels[k] = v.strip()
    return base, labels


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render(stats) -> str:
    """Render one stats client's full contents as Prometheus text.

    Accepts anything with ``snapshot_typed()`` (ExpvarStatsClient,
    MultiStatsClient wrapping one); a client without it (Nop) renders as
    an empty, still-valid exposition."""
    typed = stats.snapshot_typed() if hasattr(stats, "snapshot_typed") else {}
    if not typed:
        return ""
    # family name -> (type, [(labels, value), ...]); one # TYPE line per
    # family, samples grouped under it, families sorted for stable diffs.
    families: dict[str, tuple[str, list]] = {}

    def add(name: str, kind: str, labels: dict, value) -> None:
        fam = families.get(name)
        if fam is None:
            fam = families[name] = (kind, [])
        fam[1].append((labels, value))

    for key, value in typed.get("counters", {}).items():
        base, labels = split_key(key)
        add(prom_name(base, "counter"), "counter", labels, value)
    for key, value in typed.get("gauges", {}).items():
        base, labels = split_key(key)
        add(prom_name(base), "gauge", labels, value)
    for key, value in typed.get("sets", {}).items():
        base, labels = split_key(key)
        labels = dict(labels)
        labels["value"] = str(value)
        add(prom_name(base), "gauge", labels, 1)
    for key, h in typed.get("histograms", {}).items():
        base, labels = split_key(key)
        name = prom_name(base)
        for q, field in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            ql = dict(labels)
            ql["quantile"] = q
            add(name, "summary", ql, h[field])
        add(name + "_count", "summary.count", labels, h["count"])
        add(name + "_sum", "summary.sum", labels, h["sum"])
    for key, t in typed.get("timings", {}).items():
        base, labels = split_key(key)
        name = prom_name(base) + "_seconds"
        add(name + "_count", "summary.count", labels, t["count"])
        add(name + "_sum", "summary.sum", labels, t["sum"])

    lines: list[str] = []
    # _count/_sum samples belong to the summary family of their base
    # name; emit the TYPE line once for the base, then all its rows.
    emitted_types: set[str] = set()
    for name in sorted(families):
        kind, samples = families[name]
        if kind in ("counter", "gauge", "summary"):
            if name not in emitted_types:
                lines.append(f"# TYPE {name} {kind if kind != 'summary' else 'summary'}")
                emitted_types.add(name)
        elif kind in ("summary.count", "summary.sum"):
            base = name.rsplit("_", 1)[0]
            if base not in emitted_types and base not in families:
                # A timing family has no quantile rows; declare the
                # summary type on the base name before its _count/_sum.
                lines.append(f"# TYPE {base} summary")
                emitted_types.add(base)
        for labels, value in samples:
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_exposition(text: str) -> dict[str, dict]:
    """Strict parse of a Prometheus text exposition.  Returns
    ``{family: {"type": t, "samples": n}}`` (the ``_count``/``_sum``
    rows of a summary count toward their base family).  Raises
    ``ValueError`` naming the offending line on anything malformed —
    the bench preflight's contract."""
    families: dict[str, dict] = {}

    def family_of(name: str) -> str:
        for suffix in ("_count", "_sum", "_bucket"):
            if name.endswith(suffix):
                base = name[: -len(suffix)]
                if base in families:
                    return base
        return name

    for ln, line in enumerate(text.splitlines(), 1):
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 2 or parts[1] not in ("TYPE", "HELP"):
                raise ValueError(f"line {ln}: malformed comment: {line!r}")
            if parts[1] == "TYPE":
                if len(parts) != 4:
                    raise ValueError(f"line {ln}: malformed TYPE line: {line!r}")
                _, _, name, kind = parts
                if not valid_metric_name(name):
                    raise ValueError(f"line {ln}: invalid metric name {name!r}")
                if kind not in ("counter", "gauge", "summary", "histogram", "untyped"):
                    raise ValueError(f"line {ln}: unknown metric type {kind!r}")
                if name in families:
                    raise ValueError(f"line {ln}: duplicate TYPE for {name!r}")
                families[name] = {"type": kind, "samples": 0}
            continue
        m = _SAMPLE_RX.match(line)
        if m is None:
            raise ValueError(f"line {ln}: malformed sample: {line!r}")
        name, raw_labels, raw_value = m.group(1), m.group(2), m.group(3)
        if raw_labels:
            # Sequential tokenize: label pairs separated by commas, full
            # consumption required (values may themselves hold spaces or
            # commas inside the quotes).
            pos = 0
            while pos < len(raw_labels):
                lm = _LABEL_RX.match(raw_labels, pos)
                if lm is None:
                    raise ValueError(
                        f"line {ln}: malformed labels: {raw_labels!r}"
                    )
                pos = lm.end()
                if pos < len(raw_labels):
                    if raw_labels[pos] != ",":
                        raise ValueError(
                            f"line {ln}: malformed labels: {raw_labels!r}"
                        )
                    pos += 1
        if raw_value not in ("NaN", "+Inf", "-Inf"):
            try:
                float(raw_value)
            except ValueError:
                raise ValueError(f"line {ln}: bad sample value {raw_value!r}")
        fam = family_of(name)
        rec = families.get(fam)
        if rec is None:
            rec = families[fam] = {"type": "untyped", "samples": 0}
        rec["samples"] += 1
    return families


def registry_collisions(names_by_kind: dict[str, str]) -> list[tuple[str, str, str]]:
    """The drift gate's core check: map every registry series through
    :func:`prom_name` and report (series_a, series_b, prom) triples
    where two DISTINCT registered series collide after mangling, plus
    (series, "", prom) entries whose mangled form is not a valid metric
    name.  ``names_by_kind`` maps registry series name -> kind
    ("counter"/"gauge"/"histogram"/"timing"/"set")."""
    out: list[tuple[str, str, str]] = []
    seen: dict[str, str] = {}
    for name in sorted(names_by_kind):
        kind = names_by_kind[name]
        p = prom_name(name, "counter" if kind == "counter" else "")
        base_empty = not _MANGLE_RX.sub("_", name.strip().lower()).strip("_")
        if not valid_metric_name(p) or base_empty:
            out.append((name, "", p))
            continue
        prev = seen.get(p)
        if prev is not None and prev != name:
            out.append((prev, name, p))
        else:
            seen[p] = name
    return out


def clamp_float(raw: Optional[str], default: float = 0.0, lo: float = 0.0,
                hi: float = float("inf")) -> float:
    """Parse a query-string float, clamping instead of raising: a
    malformed or out-of-range ``?min-ms=`` must not 400 a debug
    endpoint (satellite fix shared by the handler, router, and
    lockstep front end)."""
    try:
        v = float(raw) if raw is not None else default
    except (TypeError, ValueError):
        return default
    if math.isnan(v):
        return default
    return min(max(v, lo), hi)


def clamp_int(raw: Optional[str], default: int = 0, lo: int = 0,
              hi: int = 1 << 30) -> int:
    """Integer twin of :func:`clamp_float` for ``?limit=``."""
    try:
        v = int(float(raw)) if raw is not None else default
    except (TypeError, ValueError):
        return default
    return min(max(v, lo), hi)
