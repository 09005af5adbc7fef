"""Deterministic fault injection for the replica serving tier.

Partial-failure orderings — shed-after-commit, crash mid-fan-out, crash
mid-replay — are the whole correctness surface of the durable write
path, and they are exactly the orderings that only ever show up in
production.  This seam makes them REPRODUCIBLE: a seeded spec string
(``PILOSA_TPU_FAULT_SPEC``) arms faults at the two crossings every
write takes — the router's per-group HTTP forward and the WAL append —
so a tier-1 test (or an operator's game-day) can replay the same
interleaving every run.

Spec grammar (``;``-separated rules)::

    spec   := rule (';' rule)*
    rule   := 'seed=' INT
            | site ['/' key] ':' action ['@' nth] ['~' prob]
    site   := 'forward' | 'wal.append' | 'catchup'
            | 'resync.digest' | 'resync.fetch' | 'resync.chunk'
            | 'resync.seed'
    action := 'drop' | 'crash' | 'delay=' MS | 'error=' STATUS

- ``site`` is the crossing: ``forward`` fires inside the router's
  per-group HTTP exchange (reads, write fan-out, catch-up replays, AND
  resync streams all cross it), ``wal.append`` inside the log append
  (before the record is durable), ``catchup`` at the top of each
  replay round.  The ``resync.*`` sites cover the automated-resync
  round (replica/resync.py): ``resync.digest`` before each digest
  fetch (key = the group asked), ``resync.fetch`` before each donor
  fragment fetch (key = donor), ``resync.chunk`` before each chunk
  push — including the resume probe — (key = laggard), and
  ``resync.seed`` inside the sequencer-locked seed-seq exchange (key =
  laggard), so torn-transfer, donor-death-mid-stream, and
  crash-before-seed orderings replay deterministically.
- ``key`` scopes a rule to one group name (``forward/g2:...``); no key
  matches every hit of the site.
- ``@nth`` fires on exactly the nth matching hit (1-based) — the
  deterministic ordering knob: ``forward/g2:drop@3`` kills the third
  crossing to g2 and nothing else.
- ``~prob`` fires each hit with probability ``prob`` drawn from the
  spec-level seeded RNG (``seed=42;forward:drop~0.01``) — same seed,
  same spec, same decisions, run after run.
- actions: ``drop`` raises a transport error (the router's failover /
  demotion trigger), ``error=503`` synthesizes an HTTP answer with that
  status, ``delay=250`` sleeps that many ms then proceeds, ``crash``
  exits the process hard (``os._exit``) — the subprocess crash tests'
  kill switch, firing BEFORE the guarded operation completes.

A rule with neither ``@nth`` nor ``~prob`` fires on every matching hit.
"""

from __future__ import annotations

import os
import random
import threading

from pilosa_tpu_torch.analysis import lockcheck
import time
from typing import Optional

SPEC_ENV = "PILOSA_TPU_FAULT_SPEC"

# Exit code for the 'crash' action: distinctive, so a harness can tell
# an injected crash from a real one.
CRASH_EXIT_CODE = 86


class FaultError(OSError):
    """An injected transport failure (the ``drop`` action).  Subclasses
    OSError so every caller's existing connect-failure handling —
    failover, demotion, catch-up abort — engages unchanged."""


class InjectedStatus(Exception):
    """An injected HTTP answer (the ``error=<status>`` action): the
    crossing synthesizes a response with this status instead of talking
    to the group."""

    def __init__(self, status: int):
        super().__init__(f"injected HTTP {status}")
        self.status = status


class _Rule:
    __slots__ = ("site", "key", "action", "arg", "nth", "prob", "hits")

    def __init__(self, site: str, key: str, action: str, arg: float,
                 nth: Optional[int], prob: Optional[float]):
        self.site = site
        self.key = key
        self.action = action
        self.arg = arg
        self.nth = nth
        self.prob = prob
        self.hits = 0

    def __repr__(self) -> str:  # debugging / stats strings
        where = f"{self.site}/{self.key}" if self.key else self.site
        when = f"@{self.nth}" if self.nth else (f"~{self.prob}" if self.prob else "")
        return f"{where}:{self.action}{when}"


def _parse_rule(raw: str) -> _Rule:
    head, _, action = raw.partition(":")
    if not action:
        raise ValueError(f"fault rule {raw!r}: missing ':action'")
    site, _, key = head.partition("/")
    nth: Optional[int] = None
    prob: Optional[float] = None
    if "~" in action:
        action, _, p = action.partition("~")
        prob = float(p)
    if "@" in action:
        action, _, n = action.partition("@")
        nth = int(n)
    action, _, arg_s = action.partition("=")
    action = action.strip()
    if action not in ("drop", "crash", "delay", "error"):
        raise ValueError(f"fault rule {raw!r}: unknown action {action!r}")
    arg = float(arg_s) if arg_s else 0.0
    return _Rule(site.strip(), key.strip(), action, arg, nth, prob)


class FaultInjector:
    """Armed fault rules; thread-safe, deterministic per (spec, seed)."""

    def __init__(self, rules: list[_Rule], seed: int = 0):
        self.rules = rules
        self._rng = random.Random(seed)
        self._mu = lockcheck.named_lock("replica.faults._mu")

    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        seed = 0
        rules = []
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("seed="):
                seed = int(raw[5:])
                continue
            rules.append(_parse_rule(raw))
        return cls(rules, seed=seed)

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultInjector"]:
        spec = (env if env is not None else os.environ).get(SPEC_ENV, "").strip()
        return cls.from_spec(spec) if spec else None

    def hit(self, site: str, key: str = "") -> None:
        """One crossing of ``site`` (optionally scoped by ``key``).
        Raises :class:`FaultError` / :class:`InjectedStatus`, sleeps, or
        exits the process when an armed rule fires; otherwise no-op."""
        fired: Optional[_Rule] = None
        with self._mu:
            for r in self.rules:
                if r.site != site or (r.key and r.key != key):
                    continue
                r.hits += 1
                if r.nth is not None:
                    if r.hits != r.nth:
                        continue
                elif r.prob is not None:
                    if self._rng.random() >= r.prob:
                        continue
                fired = r
                break
        if fired is None:
            return
        if fired.action == "delay":
            time.sleep(fired.arg / 1000.0)
            return
        if fired.action == "drop":
            raise FaultError(f"injected fault: {fired!r}")
        if fired.action == "error":
            raise InjectedStatus(int(fired.arg or 503))
        # crash: exit hard, mid-operation — the durable state on disk is
        # whatever the guarded code managed before this line.
        os._exit(CRASH_EXIT_CODE)


#: Shared no-op: lets call sites write ``self.faults.hit(...)``
#: unconditionally.
class _NopInjector:
    rules: list = []

    def hit(self, site: str, key: str = "") -> None:
        return


NOP_FAULTS = _NopInjector()
