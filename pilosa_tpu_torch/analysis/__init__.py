"""Project invariant linter + debug-mode runtime concurrency checker.

``python -m pilosa_tpu_torch.analysis`` runs eight project-specific rules
over the live tree and exits nonzero on NEW findings (a checked-in
baseline grandfathers accepted pre-existing violations; ``# analysis-ok:
<rule>: <reason>`` suppresses a site explicitly):

1. lockstep-determinism — rank-local nondeterminism reachable from the
   lockstep batch-execution entry points;
2. lock-discipline — raw ``threading.Lock()``/``RLock()``/``Condition()``
   instantiations that bypass the instrumented :mod:`.lockcheck`
   factories (the runtime half of this rule is the
   ``PILOSA_TPU_LOCK_CHECK=1`` checker);
3. stats-registry — every stats name must appear in the generated
   counters registry (COUNTERS.md), which must match the tree;
4. exception-hygiene — ``except Exception`` must record a stat, use the
   exception, re-raise, or carry a tag;
5. deadline-propagation — functions holding a deadline that perform a
   budget-carrying hop (executor→client, or the replica forward paths)
   must forward the remaining budget (``deadline=`` / ``timeout_s=``);
6. guarded-fields — fields declared in a class's ``_guarded_by_`` map
   mutated in methods with no named-lock acquisition on any call path
   (the static half of lockcheck's Eraser-style lockset race detector);
7. native-abi — the ctypes bridge vs the ``extern "C"`` definitions vs
   the built .so's exports: missing symbols, arity and integer-width
   mismatches (:mod:`.abi`);
8. stale-suppression — ``analysis-ok`` tags whose rule no longer fires
   at their site (the suppression set must not rot as code moves).

Beside the lint rules, the DYNAMIC analysis lane (generation 3):
``--explore`` drives the deterministic interleaving explorer
(:mod:`.sched` + the scenario registry in :mod:`.scenarios`) —
cooperative schedule control over real project code, exhaustive under
a preemption bound, every failure replayable from a printed schedule
string — and the replica write-protocol model / trace-conformance /
linearizability checkers (:mod:`.spec`).

This module stays import-light: serving modules import
``pilosa_tpu_torch.analysis.lockcheck`` (and the zero-cost
``pilosa_tpu_torch.analysis.spec`` event seam) at startup, so nothing here
may pull in the linter machinery (or anything heavy) at import time.
"""

from __future__ import annotations

__all__ = ["run_analysis", "Finding", "RULES"]


def __getattr__(name):
    if name in __all__:
        from pilosa_tpu_torch.analysis import engine

        return getattr(engine, name)
    raise AttributeError(name)
