"""Deterministic interleaving explorer: cooperative schedule control.

The lock-order checker and the lockset race detector
only observe the interleavings a test run happens to produce — a
reordering bug in the sequencer/WAL/catch-up protocol can hide for
months behind a scheduler that never preempts at the wrong instruction.
This module removes the luck: scenario threads run REAL project code,
but every interesting step — a named-lock acquisition, a condition
wait, a guarded-field write, a patched blocking call — is a YIELD
POINT where control returns to a single scheduler thread, which then
decides (deterministically) who runs next.  Exactly one scenario
thread executes at any moment, so the code between two yield points is
atomic by construction, and an execution is fully described by the
sequence of thread choices — a SCHEDULE.

Exploration is exhaustive under an ITERATIVE PREEMPTION BOUND (the
CHESS discipline: most concurrency bugs need only 1-2 preemptions) with
a CONFLICT-BASED partial-order reduction: at a scheduling point, an
alternative thread is only worth branching to when its pending
operation CONFLICTS with the one actually executed — same lock name,
same condition, same declared guarded field, same blocking kind.
Independent steps commute, so reordering them reaches an equivalent
state.  (This prunes by the CURRENTLY pending operations, not by
future ones — a deliberate under-approximation, documented in
DEVELOPMENT.md; the seeded-schedule fuzzer covers orderings beyond the
reduced set.)

Every execution's schedule serializes to a compact string
(``"0x3,1x2,0"`` — run-length thread choices, the same replay-a-string
spirit as the ``PILOSA_TPU_FAULT_SPEC`` grammar) and
:func:`replay` re-runs that exact interleaving in one shot, so a
failing schedule found by CI reproduces on the first try at a desk.

Yield points hook the existing lockcheck seams
(:func:`pilosa_tpu_torch.analysis.lockcheck.set_sched`):

- ``named_lock`` / ``named_rlock`` / ``named_condition`` factories
  return :class:`SchedLock` / :class:`SchedRLock` /
  :class:`SchedCondition` while a run is active — a blocking acquire
  yields and is granted only when the lock is free (so real primitives
  never block and a cyclic wait shows up as an explicit DEADLOCK
  outcome with the schedule that produced it);
- guarded-class ``__setattr__`` yields BEFORE the store (the
  interleaving that loses an unlocked read-modify-write needs a switch
  between the read and the write);
- the blocking-call patches (``os.fsync`` et al.) yield at the
  crossing.

Outcomes per execution: clean, a thread exception, a scenario
invariant failure (``check()`` raised), a deadlock (no enabled
thread), a protocol-trace conformance failure (analysis/spec.py), or a
step-limit truncation (counted, never silently dropped).  Determinism
is a hard contract: same scenario + same bound => identical schedule
count and identical outcome set, asserted in tests.

NOTE the raw ``threading`` primitives below are the scheduler's OWN
machinery (baton semaphores, the fall-through inner locks) and must be
invisible to the lock checker by construction — this file is exempted
from the lock-discipline rule exactly like lockcheck.py itself.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from pilosa_tpu_torch.analysis import lockcheck
from pilosa_tpu_torch.stats import NOP_STATS

# Hard caps: an execution that exceeds MAX_STEPS is recorded as
# truncated (deterministically — same cap, same truncation), and an
# exploration that would exceed max_schedules stops with the count so
# far.  Both surface in the result rather than hanging tier-1.
DEFAULT_MAX_STEPS = 4000
DEFAULT_MAX_SCHEDULES = 4000


class _SchedAbort(BaseException):
    """Raised inside a scenario thread to unwind it during run
    abandonment (deadlock/truncation teardown).  BaseException so
    ordinary ``except Exception`` recovery code cannot swallow it."""


class Op:
    """One pending operation at a yield point.  ``key`` is the stable
    resource label (lock/cv name, ``Class.field``, blocking kind) the
    conflict-based reduction compares."""

    __slots__ = ("kind", "key", "lock", "cv", "waiter", "timeout")

    def __init__(self, kind: str, key: str, lock=None, cv=None, waiter=None,
                 timeout=None):
        self.kind = kind  # start|acquire|tryacquire|wait|field|block
        self.key = key
        self.lock = lock
        self.cv = cv
        self.waiter = waiter
        self.timeout = timeout

    def label(self) -> str:
        return f"{self.kind}:{self.key}"


def _conflicts(a: Op, b: Op) -> bool:
    """Two pending ops conflict when they touch the same resource —
    the only case where executing them in the other order can reach a
    different state (lock/cv names share one namespace with the
    conditions built over them; field keys are ``Class.field``).  A
    thread's START op is a wildcard: its first segment is opaque code
    whose reads the instrumentation cannot see, so its placement is
    never provably independent of anything."""
    if a.kind == "start" or b.kind == "start":
        return True
    return a.key == b.key


class _Waiter:
    __slots__ = ("thread", "notified")

    def __init__(self, thread):
        self.thread = thread
        self.notified = False


class _SThread:
    """One scenario thread under schedule control."""

    __slots__ = ("index", "fn", "thread", "sem", "pending", "done", "exc",
                 "abort")

    def __init__(self, index: int, fn: Callable[[], None]):
        self.index = index
        self.fn = fn
        self.sem = threading.Semaphore(0)
        self.pending: Op = Op("start", f"t{index}")
        self.done = False
        self.exc: Optional[BaseException] = None
        self.abort = False
        self.thread: Optional[threading.Thread] = None


# The active run (at most one per process — explorations are
# sequential) — consulted by the primitives and the lockcheck seam.
_ACTIVE: Optional["_Run"] = None


class _Hook:
    """The object installed via lockcheck.set_sched: factory + yield
    seams.  Primitives built under an active run keep working after it
    ends (they fall through to their real inner primitive when the
    calling thread is not a scheduled scenario thread)."""

    def make_lock(self, name: str):
        return SchedLock(name)

    def make_rlock(self, name: str):
        return SchedRLock(name)

    def make_condition(self, name: str, lock=None):
        if lock is not None and not isinstance(lock, SchedLock):
            return threading.Condition(lock)
        return SchedCondition(name, lock)

    def field_write(self, obj, cls_name: str, field: str) -> None:
        run, t = _current()
        if t is not None:
            run._yield(t, Op("field", f"{cls_name}.{field}"))

    def blocking_point(self, kind: str) -> None:
        run, t = _current()
        if t is not None:
            run._yield(t, Op("block", kind))


_HOOK = _Hook()


def _current():
    """(run, scenario-thread record) for the calling thread, or
    (None, None) when it is not under schedule control."""
    run = _ACTIVE
    if run is None:
        return None, None
    return run, run.by_ident.get(threading.get_ident())


class SchedLock:
    """Lock under exploration control.  A scheduled thread's blocking
    acquire yields and is granted only when the lock is free, so the
    inner primitive never blocks; threads outside the run fall through
    to the real lock."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        # A plain Lock suffices even for SchedRLock: recursion is
        # tracked by (owner, depth) above it — the inner primitive is
        # only taken on first acquisition and released at depth zero.
        self._inner = threading.Lock()
        self.owner: Optional[_SThread] = None
        self.depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        run, t = _current()
        if t is None:
            return self._inner.acquire(blocking, timeout)
        if self.owner is t and self._reentrant:
            self.depth += 1
            return True
        if not blocking or timeout == 0:
            # Try-acquire is still a scheduling point (always enabled:
            # it can fail without blocking), then an atomic test.
            run._yield(t, Op("tryacquire", self.name, lock=self))
            if self.owner is not None:
                return False
            self._take(t)
            return True
        run._yield(t, Op("acquire", self.name, lock=self))
        # The scheduler grants an acquire only when the lock is free.
        self._take(t)
        return True

    def _take(self, t: _SThread) -> None:
        self.owner = t
        self.depth = 1
        self._inner.acquire()

    def release(self) -> None:
        run, t = _current()
        if t is None:
            self._inner.release()
            return
        if self.owner is not t:
            raise RuntimeError(f"release of {self.name} by non-owner")
        self.depth -= 1
        if self.depth == 0:
            self.owner = None
            self._inner.release()

    def locked(self) -> bool:
        return self.owner is not None or self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<SchedLock {self.name} owner={getattr(self.owner, 'index', None)}>"


class SchedRLock(SchedLock):
    _reentrant = True


class SchedCondition:
    """Condition variable under exploration control.  wait() fully
    releases the lock, parks the thread (enabled again on notify, or —
    for a TIMED wait — schedulable as a timeout fire), then re-acquires
    through the normal acquire gate.  notify()/notify_all() are
    non-yielding (they happen inside the notifier's step)."""

    def __init__(self, name: str, lock: Optional[SchedLock] = None):
        self.name = name
        self._lock = lock if lock is not None else SchedLock(name)
        self._waiters: list[_Waiter] = []  # FIFO

    # Context-manager / lock protocol delegates.
    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self):
        return self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        run, t = _current()
        if t is None:
            raise RuntimeError(
                f"SchedCondition {self.name}: wait() outside an exploration "
                "run (scenario objects must not outlive their run)"
            )
        if self._lock.owner is not t:
            raise RuntimeError(f"wait on {self.name} without owning its lock")
        depth = self._lock.depth
        # Fully release (mirrors CheckedRLock._release_save).
        self._lock.owner = None
        self._lock.depth = 0
        self._lock._inner.release()
        w = _Waiter(t)
        self._waiters.append(w)
        try:
            run._yield(t, Op("wait", self.name, cv=self, waiter=w,
                             timeout=timeout))
        finally:
            if w in self._waiters:
                self._waiters.remove(w)
        notified = w.notified
        run._yield(t, Op("acquire", self.name, lock=self._lock))
        self._lock._take(t)
        self._lock.depth = depth
        return notified

    def notify(self, n: int = 1) -> None:
        for w in self._waiters[:n]:
            w.notified = True

    def notify_all(self) -> None:
        self.notify(len(self._waiters))


# -- one execution ----------------------------------------------------------


class _StepMeta:
    """Per-step record the branch generator consumes."""

    __slots__ = ("enabled", "ops", "cur", "chosen")

    def __init__(self, enabled, ops, cur, chosen):
        self.enabled = enabled  # tuple of enabled thread indices (sorted)
        self.ops = ops  # {index: Op} pending ops of the enabled threads
        self.cur = cur  # index of the previously-run thread (or None)
        self.chosen = chosen


class RunResult:
    __slots__ = ("seq", "meta", "deadlock", "truncated", "exceptions",
                 "diverged", "blocked")

    def __init__(self):
        self.seq: list[int] = []
        self.meta: list[_StepMeta] = []
        self.deadlock = False
        self.truncated = False
        self.diverged = False
        self.exceptions: list[tuple[int, BaseException]] = []
        self.blocked: list[str] = []  # "tN on op" captured at deadlock


class _Run:
    """One execution of a scenario's threads under a decision prefix."""

    def __init__(self, fns, max_steps: int = DEFAULT_MAX_STEPS):
        self.threads = [_SThread(i, fn) for i, fn in enumerate(fns)]
        self.by_ident: dict[int, _SThread] = {}
        self.baton = threading.Semaphore(0)
        self.max_steps = max_steps

    # -- scenario-thread side ---------------------------------------------

    def _thread_main(self, t: _SThread) -> None:
        t.sem.acquire()  # the start grant
        try:
            if not t.abort:
                t.fn()
        except _SchedAbort:
            pass
        except BaseException as e:  # noqa: BLE001 — recorded as the outcome
            t.exc = e
        finally:
            t.done = True
            self.baton.release()

    def _yield(self, t: _SThread, op: Op) -> None:
        t.pending = op
        self.baton.release()
        t.sem.acquire()
        if t.abort:
            raise _SchedAbort()

    # -- scheduler side ----------------------------------------------------

    def _enabled(self, t: _SThread) -> bool:
        op = t.pending
        if op.kind == "acquire":
            lk = op.lock
            return lk.owner is None or (lk.owner is t and lk._reentrant)
        if op.kind == "wait":
            return op.waiter.notified or op.timeout is not None
        return True  # start / tryacquire / field / block

    def _default_choice(self, cur: Optional[int], enabled: list[_SThread]):
        """Non-preemptive completion policy: keep running the current
        thread — unless its only move is firing a wait timeout while
        another thread can make real progress (the group-commit
        follower's 50 ms poll would otherwise spin the execution into
        the step cap)."""

        def is_idle_timeout(t: _SThread) -> bool:
            return t.pending.kind == "wait" and not t.pending.waiter.notified

        by_index = {t.index: t for t in enabled}
        if cur is not None and cur in by_index:
            t = by_index[cur]
            if not (is_idle_timeout(t) and len(enabled) > 1):
                return t
        progress = [t for t in enabled if not is_idle_timeout(t)]
        return (progress or enabled)[0]

    def run(self, decisions: list[int]) -> RunResult:
        global _ACTIVE
        res = RunResult()
        for t in self.threads:
            t.thread = threading.Thread(
                target=self._thread_main, args=(t,),
                name=f"sched-t{t.index}", daemon=True,
            )
        _ACTIVE = self
        try:
            for t in self.threads:
                t.thread.start()
                self.by_ident[t.thread.ident] = t
            cur: Optional[int] = None
            step = 0
            while True:
                alive = [t for t in self.threads if not t.done]
                if not alive:
                    break
                enabled = sorted(
                    (t for t in alive if self._enabled(t)),
                    key=lambda t: t.index,
                )
                if not enabled:
                    res.deadlock = True
                    res.blocked = [
                        f"t{t.index} on {t.pending.label()}" for t in alive
                    ]
                    break
                if step >= self.max_steps:
                    res.truncated = True
                    break
                if step < len(decisions):
                    want = decisions[step]
                    chosen = next((t for t in enabled if t.index == want), None)
                    if chosen is None:
                        res.diverged = True
                        break
                else:
                    chosen = self._default_choice(cur, enabled)
                res.meta.append(
                    _StepMeta(
                        tuple(t.index for t in enabled),
                        {t.index: t.pending for t in enabled},
                        cur,
                        chosen.index,
                    )
                )
                res.seq.append(chosen.index)
                chosen.sem.release()
                self.baton.acquire()
                cur = chosen.index
                step += 1
        finally:
            self._teardown()
            _ACTIVE = None
        for t in self.threads:
            if t.exc is not None:
                res.exceptions.append((t.index, t.exc))
        return res

    def _teardown(self) -> None:
        """Unwind any still-parked threads (deadlock/truncation/diverge
        paths).  Each aborted thread raises _SchedAbort from its pending
        yield; a thread that refuses to die within the bound is leaked
        as a daemon (its scenario objects are execution-local, so it
        cannot perturb later runs)."""
        for _ in range(64):
            live = [t for t in self.threads if not t.done]
            if not live:
                break
            for t in live:
                t.abort = True
                t.sem.release()
            self.baton.acquire(timeout=0.2)
        for t in self.threads:
            if t.thread is not None:
                t.thread.join(timeout=1.0)


# -- schedule strings --------------------------------------------------------


def format_schedule(seq: list[int]) -> str:
    """Run-length encode a thread-choice sequence: [0,0,0,1,1,0] ->
    "0x3,1x2,0"."""
    out = []
    i = 0
    while i < len(seq):
        j = i
        while j < len(seq) and seq[j] == seq[i]:
            j += 1
        n = j - i
        out.append(f"{seq[i]}x{n}" if n > 1 else f"{seq[i]}")
        i = j
    return ",".join(out)


def parse_schedule(s: str) -> list[int]:
    out: list[int] = []
    for tok in s.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "x" in tok:
            tid, _, n = tok.partition("x")
            out.extend([int(tid)] * int(n))
        else:
            out.append(int(tok))
    return out


# -- scenarios ---------------------------------------------------------------


class Scenario:
    """One explorable concurrency scenario.

    ``build()`` returns a fresh context object exposing:

    - ``threads``: the list of zero-arg callables to run under schedule
      control (real project code; everything they lock must be built
      inside ``build`` so the factories hand out Sched primitives);
    - ``check()``: post-execution invariants — raises AssertionError on
      a violation (called only for executions that ran to completion);
    - optionally ``close()``: resource teardown (tmp dirs), always
      called.

    ``trace_check=True`` additionally runs the replica-protocol
    trace-conformance checker (analysis/spec.py) over the events each
    execution emitted.  ``known_bug=True`` marks a seeded bug fixture:
    the live-tree gate skips it, and a dedicated test asserts the
    explorer FINDS it and that the printed schedule replays it.
    """

    def __init__(self, name: str, build: Callable, description: str = "",
                 known_bug: bool = False, trace_check: bool = False,
                 bound: int = 2, max_steps: int = DEFAULT_MAX_STEPS,
                 max_schedules: int = DEFAULT_MAX_SCHEDULES):
        self.name = name
        self.build = build
        self.description = description or (build.__doc__ or "").strip()
        self.known_bug = known_bug
        self.trace_check = trace_check
        self.bound = bound
        self.max_steps = max_steps
        self.max_schedules = max_schedules


class Outcome:
    """One failing execution: what went wrong and the schedule string
    that replays it."""

    __slots__ = ("kind", "schedule", "detail")

    def __init__(self, kind: str, schedule: str, detail: str):
        self.kind = kind  # exception|check|deadlock|trace
        self.schedule = schedule
        self.detail = detail

    def describe(self) -> str:
        return (
            f"[{self.kind}] schedule {self.schedule or '<empty>'}\n"
            f"  {self.detail}"
        )


class ExploreResult:
    __slots__ = ("scenario", "bound", "schedules", "truncated", "outcomes")

    def __init__(self, scenario: str, bound: int):
        self.scenario = scenario
        self.bound = bound
        self.schedules = 0
        self.truncated = 0
        self.outcomes: list[Outcome] = []

    @property
    def ok(self) -> bool:
        return not self.outcomes

    def describe(self) -> str:
        head = (
            f"{self.scenario}: {self.schedules} schedule(s) at preemption "
            f"bound {self.bound}, {self.truncated} truncated, "
            f"{len(self.outcomes)} violation(s)"
        )
        if not self.outcomes:
            return head
        return head + "\n" + "\n".join(o.describe() for o in self.outcomes)


def _execute(scenario: Scenario, decisions: list[int],
             max_steps: int) -> tuple[RunResult, list[Outcome]]:
    """Run the scenario once under a decision prefix; returns the run
    record and any failure outcomes."""
    from pilosa_tpu_torch.analysis import spec

    lockcheck.set_sched(_HOOK)
    lockcheck.sched_instrument()
    events = spec.install_collector() if scenario.trace_check else None
    ctx = None
    try:
        ctx = scenario.build()
        run = _Run(list(ctx.threads), max_steps=max_steps)
        res = run.run(decisions)
        outcomes: list[Outcome] = []
        sched_str = format_schedule(res.seq)
        for idx, exc in res.exceptions:
            outcomes.append(
                Outcome("exception", sched_str,
                        f"thread {idx}: {type(exc).__name__}: {exc}")
            )
        if res.deadlock:
            outcomes.append(
                Outcome("deadlock", sched_str,
                        "no enabled thread: " + ", ".join(res.blocked))
            )
        if not res.deadlock and not res.truncated and not res.diverged \
                and not res.exceptions:
            try:
                ctx.check()
            except AssertionError as e:
                outcomes.append(Outcome("check", sched_str, str(e)))
        if events is not None:
            for v in spec.check_trace(events):
                outcomes.append(Outcome("trace", sched_str, v))
        return res, outcomes
    finally:
        if ctx is not None and hasattr(ctx, "close"):
            ctx.close()
        if events is not None:
            spec.uninstall_collector()
        lockcheck.set_sched(None)
        lockcheck.sched_uninstrument()


def _preemptions(seq: list[int], meta: list[_StepMeta]) -> list[int]:
    """Cumulative preemption count before each step: step i preempted
    when the previously-running thread was still enabled but a
    different one was chosen."""
    used = 0
    out = []
    for i, m in enumerate(meta):
        out.append(used)
        if m.cur is not None and m.cur in m.enabled and seq[i] != m.cur:
            used += 1
    return out


def explore(scenario: Scenario, bound: Optional[int] = None,
            max_schedules: Optional[int] = None,
            max_steps: Optional[int] = None,
            stats=None) -> ExploreResult:
    """Exhaustively explore the scenario's interleavings with at most
    ``bound`` preemptions, pruned by the conflict-based partial-order
    reduction.  Deterministic: same scenario + bound => same schedule
    count and outcomes."""
    bound = scenario.bound if bound is None else bound
    max_schedules = scenario.max_schedules if max_schedules is None else max_schedules
    max_steps = scenario.max_steps if max_steps is None else max_steps
    stats = stats if stats is not None else NOP_STATS
    result = ExploreResult(scenario.name, bound)
    seen_prefixes: set[tuple[int, ...]] = set()
    seen_seqs: set[tuple[int, ...]] = set()
    stack: list[list[int]] = [[]]
    seen_prefixes.add(())
    while stack:
        if result.schedules >= max_schedules:
            result.truncated += 1
            break
        prefix = stack.pop()
        res, outcomes = _execute(scenario, prefix, max_steps)
        if res.diverged:
            continue  # a sibling branch changed enabledness; prefix dead
        seq = tuple(res.seq)
        if seq in seen_seqs:
            continue
        seen_seqs.add(seq)
        result.schedules += 1
        if res.truncated:
            result.truncated += 1
        result.outcomes.extend(outcomes)
        # Branch generation: at every step, consider the enabled
        # alternatives whose pending op CONFLICTS with the op of the
        # thread actually run; a switch away from a still-enabled
        # current thread costs one unit of the preemption budget.
        pre = _preemptions(res.seq, res.meta)
        for i, m in enumerate(res.meta):
            chosen_op = m.ops[m.chosen]
            for alt in m.enabled:
                if alt == m.chosen:
                    continue
                preemptive = m.cur is not None and m.cur in m.enabled \
                    and alt != m.cur
                if pre[i] + (1 if preemptive else 0) > bound:
                    continue
                if not _conflicts(m.ops[alt], chosen_op):
                    continue
                cand = list(res.seq[:i]) + [alt]
                key = tuple(cand)
                if key not in seen_prefixes:
                    seen_prefixes.add(key)
                    stack.append(cand)
        # LIFO order is deterministic because alternatives were pushed
        # in sorted (step, thread) order within each execution.
    stats.count("analysis.sched.schedules", result.schedules)
    if result.truncated:
        stats.count("analysis.sched.truncated", result.truncated)
    if result.outcomes:
        stats.count("analysis.sched.violations", len(result.outcomes))
    return result


def replay(scenario: Scenario, schedule: str,
           max_steps: Optional[int] = None, stats=None) -> list[Outcome]:
    """Re-run ONE schedule (a string printed by a failing exploration)
    and return its outcomes — the deterministic repro lane."""
    stats = stats if stats is not None else NOP_STATS
    decisions = parse_schedule(schedule)
    res, outcomes = _execute(
        scenario, decisions,
        scenario.max_steps if max_steps is None else max_steps,
    )
    stats.count("analysis.sched.replays")
    if res.diverged:
        outcomes.append(
            Outcome(
                "exception", schedule,
                "schedule diverged: a prescribed thread was not enabled at "
                "its step (stale schedule string, or the scenario changed)",
            )
        )
    return outcomes


def fuzz(scenario: Scenario, seed: int, runs: int = 16,
         max_steps: Optional[int] = None, stats=None) -> ExploreResult:
    """Seeded random-schedule fuzzing BEYOND the exhaustive preemption
    bound: each run draws uniformly among the enabled threads at every
    step.  Deterministic per (scenario, seed, runs) — failures print
    the same replayable schedule strings as explore()."""
    import random

    stats = stats if stats is not None else NOP_STATS
    rng = random.Random(seed)
    result = ExploreResult(scenario.name, -1)
    max_steps = scenario.max_steps if max_steps is None else max_steps
    for _ in range(runs):
        # Pre-draw a long random decision tape; _execute maps each
        # entry onto the enabled set at that step via modulo, so the
        # tape is schedule-complete for any enabledness pattern.
        tape = [rng.randrange(1 << 30) for _ in range(max_steps)]
        res, outcomes = _execute_random(scenario, tape, max_steps)
        result.schedules += 1
        if res.truncated:
            result.truncated += 1
        result.outcomes.extend(outcomes)
    stats.count("analysis.sched.fuzz_runs", result.schedules)
    if result.outcomes:
        stats.count("analysis.sched.violations", len(result.outcomes))
    return result


def _execute_random(scenario: Scenario, tape: list[int], max_steps: int):
    """One fuzz execution: the pre-drawn tape indexes into the enabled
    set at each step.  The EXECUTED sequence is recorded, so a failure
    replays through the standard schedule-string lane."""
    from pilosa_tpu_torch.analysis import spec

    lockcheck.set_sched(_HOOK)
    lockcheck.sched_instrument()
    events = spec.install_collector() if scenario.trace_check else None
    ctx = None
    try:
        ctx = scenario.build()
        run = _Run(list(ctx.threads), max_steps=max_steps)
        # Random choice = a decision list resolved step by step: drive
        # the run manually with a choice function.
        res = _drive_random(run, tape, max_steps)
        outcomes: list[Outcome] = []
        sched_str = format_schedule(res.seq)
        for idx, exc in res.exceptions:
            outcomes.append(
                Outcome("exception", sched_str,
                        f"thread {idx}: {type(exc).__name__}: {exc}")
            )
        if res.deadlock:
            outcomes.append(
                Outcome("deadlock", sched_str,
                        "no enabled thread: " + ", ".join(res.blocked))
            )
        if not (res.deadlock or res.truncated or res.exceptions):
            try:
                ctx.check()
            except AssertionError as e:
                outcomes.append(Outcome("check", sched_str, str(e)))
        if events is not None:
            for v in spec.check_trace(events):
                outcomes.append(Outcome("trace", sched_str, v))
        return res, outcomes
    finally:
        if ctx is not None and hasattr(ctx, "close"):
            ctx.close()
        if events is not None:
            spec.uninstall_collector()
        lockcheck.set_sched(None)
        lockcheck.sched_uninstrument()


def _drive_random(run: _Run, tape: list[int], max_steps: int) -> RunResult:
    global _ACTIVE
    res = RunResult()
    for t in run.threads:
        t.thread = threading.Thread(
            target=run._thread_main, args=(t,),
            name=f"sched-t{t.index}", daemon=True,
        )
    _ACTIVE = run
    try:
        for t in run.threads:
            t.thread.start()
            run.by_ident[t.thread.ident] = t
        step = 0
        while True:
            alive = [t for t in run.threads if not t.done]
            if not alive:
                break
            enabled = sorted(
                (t for t in alive if run._enabled(t)), key=lambda t: t.index
            )
            if not enabled:
                res.deadlock = True
                res.blocked = [
                    f"t{t.index} on {t.pending.label()}" for t in alive
                ]
                break
            if step >= max_steps:
                res.truncated = True
                break
            chosen = enabled[tape[step] % len(enabled)]
            res.seq.append(chosen.index)
            chosen.sem.release()
            run.baton.acquire()
            step += 1
    finally:
        run._teardown()
        _ACTIVE = None
    for t in run.threads:
        if t.exc is not None:
            res.exceptions.append((t.index, t.exc))
    return res
