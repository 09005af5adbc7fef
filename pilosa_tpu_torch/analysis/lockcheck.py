"""Debug-mode runtime concurrency checker for the project's named locks.

The replica/WAL tier is lock-heavy threaded code where the last two
review rounds each found hand-caught races (the PR 6 inflight-gauge
race, the PR 7 fsync-under-compaction swap).  This module turns the
conventions those fixes rely on into a checkable model, the way Go's
race detector did for the reference Pilosa:

- every interesting lock is created through :func:`named_lock` /
  :func:`named_rlock` / :func:`named_condition` and carries a stable
  NAME ("replica.router._seq_mu", "replica.wal._mu", ...);
- with ``PILOSA_TPU_LOCK_CHECK=1`` (or an explicit :func:`enable`)
  the factories return instrumented wrappers that feed a global
  checker; otherwise they return plain ``threading`` primitives with
  zero overhead;
- the checker builds the cross-thread lock acquisition-order graph
  (edges by lock NAME, so every fragment's ``_mu`` is one node) and
  records a violation when a new acquisition closes a cycle — the
  classic potential-deadlock witness, caught even when the interleaving
  that would actually deadlock never happens in the run;
- blocking calls (``os.fsync``, socket I/O, ``subprocess``) executed
  while ANY checked lock is held are violations unless the (lock,
  kind) pair is allowlisted — either in :data:`DEFAULT_ALLOW_PAIRS`
  (documented by-design holds, e.g. the write sequencer fanning out
  over HTTP) or via a code-local ``with allowed("fsync"):`` scope;
- GENERATION 2 — an Eraser-style LOCKSET RACE DETECTOR over declared
  guarded state: classes carry ``_guarded_by_ = {"field": "lock.name"}``
  and register with :func:`guarded_class` (or individual objects via
  :func:`guarded`); while the checker is enabled their ``__setattr__``
  is instrumented, and every write to a declared field refines a
  per-(object, field) CANDIDATE LOCKSET — the intersection of the
  named locks held at each write.  Writes by the first (and only)
  accessing thread are exempt (the init-phase single-thread state:
  construction and ``open()`` predate sharing); the lockset
  initializes at the first write from a SECOND thread and shrinks by
  intersection from there.  An empty lockset with >= 2 observed
  threads is a ``lockset-race`` violation carrying the first shared
  write's stack and the emptying write's stack — the data-race analog
  of the order graph's first-witness cycles, and the safety net the
  free-threaded multi-core refactor needs (lock-order checking alone
  only catches deadlocks, ROADMAP item 2).  Only attribute REBINDS are
  seen (``self.f = ...``, ``self.f += ...``); in-place container
  mutation is covered by the static ``guarded-fields`` companion rule
  (analysis/rules.py) instead.

Violations are RECORDED, not raised at the faulting site (raising
inside a background probe thread would be swallowed by its own
error handling); tests drain them with :func:`take_violations` or
assert emptiness with :func:`check`.  tests/conftest.py enables the
checker for the tier-1 concurrency/replica/qos suites and fails any
test that recorded a violation.

Re-entrant acquisition of the same named lock is tracked by depth and
never creates a self-edge: instances sharing a name (every fragment's
``_mu``) cannot be ordered against each other by name alone, so
same-name nesting is out of the model's scope.
"""

from __future__ import annotations

import os
import socket
import subprocess
import threading
import traceback
import weakref

ENV_VAR = "PILOSA_TPU_LOCK_CHECK"

# (lock name, blocking kind) pairs that are BY DESIGN: holding the
# named lock across this class of blocking call is the documented
# serialization contract, not an accident.  Keep this list short and
# justified — every entry is a place a slow syscall stalls every other
# user of the lock.
DEFAULT_ALLOW_PAIRS: frozenset[tuple[str, str]] = frozenset(
    {
        # The write sequencer IS the total order: the router holds
        # _seq_mu across the whole HTTP fan-out so every group applies
        # every write in the same sequence (replica/router.py), and
        # catch-up's phase-2 locked drain replays the final records
        # under the same lock so rejoin == fully-caught-up.  The WAL
        # append + group-commit fsync sit inside the same hold: a
        # write's durability point is part of its slot in the order.
        ("replica.router._seq_mu", "socket"),
        ("replica.router._seq_mu", "fsync"),
        # _compact_mu exists ONLY to serialize whole compactions; the
        # bulk copy + fsync run under it by construction, off the
        # append path (appenders take _mu, which the bulk phase does
        # NOT hold — that is the point of the split).
        ("replica.wal._compact_mu", "fsync"),
        # Lockstep rank 0 ships batch entries to the worker sockets
        # while holding the order lock — the ship IS the point where
        # the total order is fixed (parallel/service.py).
        ("lockstep._order_mu", "socket"),
        ("lockstep._q_cv", "socket"),
    }
)

BLOCKING_KINDS = ("fsync", "socket", "subprocess")


class LockCheckError(AssertionError):
    """A recorded lock-discipline violation, raised by check()."""


def _stack(skip: int = 2) -> str:
    return "".join(traceback.format_stack()[:-skip][-8:])


class Violation:
    __slots__ = ("kind", "detail", "thread", "stack")

    def __init__(self, kind: str, detail: str, stack: str):
        self.kind = kind
        self.detail = detail
        self.thread = threading.current_thread().name
        self.stack = stack

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Violation {self.kind}: {self.detail} [{self.thread}]>"

    def describe(self) -> str:
        return f"{self.kind}: {self.detail}\n  thread: {self.thread}\n{self.stack}"


class _FieldRecord:
    """Eraser state for one (object, field) location.

    ``lockset`` is None while the location is still in its exclusive
    (single-thread init) phase; it initializes to the held-lock set of
    the first write from a SECOND thread and only ever shrinks by
    intersection afterwards."""

    __slots__ = ("ref", "first_tid", "threads", "lockset", "first_stack",
                 "reported")

    def __init__(self, ref, tid: int, stack: str):
        self.ref = ref  # weakref to the owning object (stale-id guard)
        self.first_tid = tid
        self.threads = {tid}
        self.lockset = None
        self.first_stack = stack
        self.reported = False


class _Checker:
    """Global acquisition-order graph + held-lock bookkeeping."""

    def __init__(self):
        self._mu = threading.Lock()  # leaf lock: guards graph/violations only
        # edge a -> b: lock named a was held while b was acquired;
        # value = first-witness stack for the report.
        self._edges: dict[str, dict[str, str]] = {}
        self._violations: list[Violation] = []
        self._seen_cycles: set[tuple[str, str]] = set()
        self._seen_blocking: set[tuple[str, str]] = set()
        # (id(obj), field) -> _FieldRecord for the lockset race detector.
        self._fields: dict[tuple[int, str], _FieldRecord] = {}
        self._tls = threading.local()
        self.allow_pairs: set[tuple[str, str]] = set(DEFAULT_ALLOW_PAIRS)

    # -- per-thread held stack -------------------------------------------

    def _held(self) -> list[list]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []  # [name, depth] entries, acquisition order
        return h

    def _scoped_allows(self) -> list[str]:
        a = getattr(self._tls, "allows", None)
        if a is None:
            a = self._tls.allows = []
        return a

    def note_acquired(self, name: str) -> None:
        held = self._held()
        for e in held:
            if e[0] == name:
                e[1] += 1  # re-entrant: no new edge, no self-edge
                return
        if held:
            holders = [e[0] for e in held if e[0] != name]
            if holders:
                with self._mu:
                    for a in holders:
                        fresh = name not in self._edges.get(a, ())
                        self._edges.setdefault(a, {}).setdefault(name, _stack())
                        if fresh:
                            self._check_cycle(a, name)
        held.append([name, 1])

    def note_released(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                held[i][1] -= 1
                if held[i][1] == 0:
                    del held[i]
                return

    def held_names(self) -> list[str]:
        return [e[0] for e in self._held()]

    # -- cycle detection ---------------------------------------------------

    def _check_cycle(self, a: str, b: str) -> None:
        """Adding edge a->b: a path b ->* a means a cycle through (a, b).
        Called under self._mu."""
        path = self._find_path(b, a)
        if path is None:
            return
        key = (a, b) if a < b else (b, a)
        if key in self._seen_cycles:
            return
        self._seen_cycles.add(key)
        cycle = [a] + path
        self._violations.append(
            Violation(
                "lock-order-cycle",
                " -> ".join(cycle)
                + f" (new edge {a} -> {b} closes the cycle; first-witness "
                f"stacks in the acquisition-order graph)",
                _stack(),
            )
        )

    def _find_path(self, src: str, dst: str) -> list[str] | None:
        """DFS src ->* dst over recorded edges; returns the node path."""
        seen = {src}
        stack = [(src, [src])]
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- blocking calls ----------------------------------------------------

    def note_blocking(self, kind: str) -> None:
        held = self._held()
        if not held:
            return
        if kind in self._scoped_allows():
            return
        bad = [e[0] for e in held if (e[0], kind) not in self.allow_pairs]
        if not bad:
            return
        key = (tuple(bad)[0], kind)
        with self._mu:
            if key in self._seen_blocking:
                return
            self._seen_blocking.add(key)
            self._violations.append(
                Violation(
                    "blocking-under-lock",
                    f"{kind} call while holding {', '.join(bad)}",
                    _stack(),
                )
            )

    # -- lockset race detection (declared guarded fields) -----------------

    def note_field_write(self, obj, cls_name: str, field: str,
                         lockname: str) -> None:
        """One write to a declared-guarded field: refine the location's
        candidate lockset (Eraser's C(v) &= locks_held), with the
        init-phase single-thread exemption."""
        tid = threading.get_ident()
        key = (id(obj), field)
        held = None
        with self._mu:
            rec = self._fields.get(key)
            if rec is not None and rec.ref() is not obj:
                rec = None  # id was recycled by a dead object: fresh record
            if rec is None:
                try:
                    ref = weakref.ref(obj)
                except TypeError:  # pragma: no cover - no __weakref__ slot
                    ref = lambda _o=None: obj  # noqa: E731 — pins obj; rare
                self._fields[key] = _FieldRecord(ref, tid, _stack())
                return
            rec.threads.add(tid)
            if len(rec.threads) == 1:
                return  # exclusive phase: only the first thread has written
            held = set(self.held_names())
            if rec.lockset is None:
                # First write after the location became shared: the
                # candidate set starts as exactly what this write holds.
                rec.lockset = held
            else:
                rec.lockset &= held
            if not rec.lockset and not rec.reported:
                rec.reported = True
                self._violations.append(
                    Violation(
                        "lockset-race",
                        f"{cls_name}.{field} (declared guarded by "
                        f"{lockname}): write with EMPTY candidate lockset — "
                        f"{len(rec.threads)} threads observed, no common "
                        "named lock across their writes\n"
                        "  first-witness (earliest recorded write):\n"
                        + rec.first_stack,
                        _stack(),
                    )
                )

    # -- reporting ---------------------------------------------------------

    def take_violations(self) -> list[Violation]:
        with self._mu:
            out = self._violations
            self._violations = []
            return out

    def reset(self) -> None:
        """Clear the graph and pending violations (per-test isolation:
        two tests acquiring A->B and B->A respectively never interleave,
        so cross-test edges would be false cycles)."""
        with self._mu:
            self._edges = {}
            self._violations = []
            self._seen_cycles = set()
            self._seen_blocking = set()
            self._fields = {}


_checker = _Checker()
_enabled = False
_patched = False
_orig: dict[str, object] = {}

# Cooperative-scheduler seam (analysis/sched.py): while an exploration
# run is active, the named factories delegate primitive construction to
# the scheduler (so every lock/condition a scenario builds is a yield
# point), guarded-field writes yield BEFORE the write lands (the
# interleaving that loses an unlocked read-modify-write only exists if
# control can change hands between the read and the write), and the
# blocking-call patches yield at each crossing.  None = zero overhead.
_sched = None


def set_sched(hook) -> None:
    """Install (or clear, with None) the active exploration scheduler."""
    global _sched
    _sched = hook


def sched_hook():
    return _sched


def checker() -> _Checker:
    return _checker


def enabled() -> bool:
    return _enabled


# -- instrumented primitives ----------------------------------------------


class CheckedLock:
    """threading.Lock wrapper feeding the global checker."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._inner = self._make_inner()

    def _make_inner(self):
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _checker.note_acquired(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        _checker.note_released(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<CheckedLock {self.name} {self._inner!r}>"


class CheckedRLock(CheckedLock):
    """threading.RLock wrapper; recursion tracked by depth, and the
    Condition integration hooks (_release_save/_acquire_restore/
    _is_owned) keep the held bookkeeping correct across cv.wait()."""

    _reentrant = True

    def _make_inner(self):
        return threading.RLock()

    def _release_save(self):
        # Fully release the recursion for a cv.wait(): drop our
        # bookkeeping entirely, remember nothing (the inner state
        # carries the depth).
        state = self._inner._release_save()
        _checker.note_released(self.name)
        held = _checker._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self.name:
                del held[i]
                break
        return state

    def _acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)
        _checker.note_acquired(self.name)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


def named_lock(name: str):
    """A mutex participating in the order/blocking checks when the
    checker is enabled; a plain threading.Lock otherwise.  Under an
    active exploration run (analysis/sched.py) the scheduler supplies
    the primitive so every acquisition is a controlled yield point."""
    s = _sched
    if s is not None:
        return s.make_lock(name)
    if _enabled:
        return CheckedLock(name)
    return threading.Lock()


def named_rlock(name: str):
    s = _sched
    if s is not None:
        return s.make_rlock(name)
    if _enabled:
        return CheckedRLock(name)
    return threading.RLock()


def named_condition(name: str, lock=None):
    """A Condition whose underlying lock is checked when enabled.
    ``lock`` reuses an existing (possibly checked) lock, as in
    ``Condition(self._mu)``."""
    s = _sched
    if s is not None:
        return s.make_condition(name, lock)
    if lock is not None:
        return threading.Condition(lock)
    if _enabled:
        return threading.Condition(CheckedLock(name))
    return threading.Condition()


class allowed:
    """Scoped, code-local allowlist entry: the blocking call inside is
    a documented part of the holding lock's contract.

    with lockcheck.allowed("fsync"):   # bounded delta fsync before swap
        os.fsync(fd)
    """

    def __init__(self, *kinds: str):
        self.kinds = kinds

    def __enter__(self):
        _checker._scoped_allows().extend(self.kinds)
        return self

    def __exit__(self, *exc) -> None:
        a = _checker._scoped_allows()
        for k in self.kinds:
            if k in a:
                a.remove(k)


# -- guarded-state declarations (lockset race detector) ---------------------
#
# Classes declare which named lock guards which field:
#
#     @lockcheck.guarded_class
#     class Fragment:
#         _guarded_by_ = {"storage": "core.fragment._mu", ...}
#
# With the checker enabled, the class's __setattr__ is wrapped so every
# write to a declared field feeds note_field_write(); disabled, the
# class is left untouched (zero overhead).  guarded(obj, attr, lock=..)
# registers a single object's field instead (ad-hoc shared state that
# has no class-level contract).

_GUARDED_CLASSES: list = []
# Classes with at least one per-instance guarded() registration; the
# wrapper only consults the instance table for these.
_INSTANCE_GUARDED_TYPES: set = set()
_instance_guards: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_SETATTR_SENTINEL = "__lockcheck_wrapped_setattr__"


def _patch_guarded_class(cls) -> None:
    if _SETATTR_SENTINEL in cls.__dict__:
        return
    own = cls.__dict__.get("__setattr__")  # restore target (None = inherited)
    base_setattr = cls.__setattr__
    decl = dict(getattr(cls, "_guarded_by_", ()) or ())
    cls_name = cls.__name__

    def checked_setattr(self, name, value):
        lock = decl.get(name)
        if lock is None and type(self) in _INSTANCE_GUARDED_TYPES:
            ig = _instance_guards.get(self)
            if ig is not None:
                lock = ig.get(name)
        if lock is not None:
            s = _sched
            if s is not None:
                # Exploration yield point BEFORE the write lands: the
                # schedule that loses an unlocked read-modify-write
                # needs a context switch between the read (already
                # evaluated into ``value``) and this store.
                s.field_write(self, cls_name, name)
        base_setattr(self, name, value)
        if lock is not None and _enabled:
            _checker.note_field_write(self, cls_name, name, lock)

    checked_setattr.__lockcheck_orig__ = own
    setattr(cls, "__setattr__", checked_setattr)
    setattr(cls, _SETATTR_SENTINEL, True)


def _unpatch_guarded_class(cls) -> None:
    wrapped = cls.__dict__.get("__setattr__")
    if _SETATTR_SENTINEL not in cls.__dict__ or wrapped is None:
        return
    orig = getattr(wrapped, "__lockcheck_orig__", None)
    if orig is None:
        delattr(cls, "__setattr__")  # was inherited (object.__setattr__)
    else:
        setattr(cls, "__setattr__", orig)
    delattr(cls, _SETATTR_SENTINEL)


def guarded_class(cls):
    """Class decorator registering ``cls._guarded_by_`` declarations
    with the lockset race detector.  A no-op marker while the checker
    is disabled; instrumented from :func:`enable` on (including classes
    defined after enable — subprocess workers self-enable at import,
    before the guarded modules load)."""
    if cls not in _GUARDED_CLASSES:
        _GUARDED_CLASSES.append(cls)
    if _enabled or _sched is not None:
        _patch_guarded_class(cls)
    return cls


def guarded(obj, attr: str, lock: str) -> None:
    """Register ONE object's field as guarded by the named lock — the
    ad-hoc twin of a class-level ``_guarded_by_`` entry.  The object's
    class joins the instrumentation set (its declared dict, if any,
    still applies)."""
    cls = type(obj)
    _INSTANCE_GUARDED_TYPES.add(cls)
    ig = _instance_guards.get(obj)
    if ig is None:
        ig = _instance_guards[obj] = {}
    ig[attr] = lock
    guarded_class(cls)


# -- named globals (registered module-level mutable state) -------------------
#
# GENERATION 3 — the sanctioned seam for module-level mutable state in
# serving-reachable code (the free-threading readiness contract,
# ROADMAP item 2).  A bare module-level memo dict relies on the GIL for
# every one of its compound operations; the static
# ``global-mutable-state`` rule (analysis/rules.py) flags those, and
# this factory is the fix it points at:
#
#     _PARSE_MEMO = lockcheck.named_global("pql.parse_memo",
#                                          max_entries=512)
#
# Each NamedGlobal is a bounded LRU mapping whose every mutation runs
# under its own NAMED lock (so the order/blocking checks see it), is
# registered in a process-wide registry (``named_globals()`` — the
# debug inventory, and the /metrics publication seam), and feeds the
# lockset race detector on every mutation: a future code path that
# mutated the store without the named lock empties the per-(object,
# field) candidate lockset exactly like an undisciplined guarded-field
# write.  Under an active exploration run the memo BYPASSES itself
# (every get is a miss, every put a no-op) so execution #1 and #N of a
# scenario have identical yield structure — this is what retires the
# PR 12 driver-thread warm-up workaround in analysis/scenarios.py.

_named_globals: dict[str, "NamedGlobal"] = {}
_named_globals_mu = threading.Lock()  # leaf: guards the registry dict only


class _GlobalLock:
    """The mutex inside a NamedGlobal.  Module-level globals are built
    at import time — usually BEFORE enable() runs in a test process —
    so unlike named_lock() this wrapper consults the enable state per
    acquisition instead of freezing it at construction: the same
    process-lifetime lock is invisible in production and fully checked
    the moment the checker turns on."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.Lock()

    def __enter__(self):
        self._inner.acquire()
        if _enabled:
            _checker.note_acquired(self.name)
        return self

    def __exit__(self, *exc) -> None:
        # Unconditional: note_released tolerates a name it never saw
        # acquired (enable() flipping mid-hold must not strand a held
        # entry on this thread).
        _checker.note_released(self.name)
        self._inner.release()


class NamedGlobal:
    """A registered, bounded, lock-named LRU — the only sanctioned
    shape for module-level mutable state on serving paths.  Values are
    computed OUTSIDE the lock by the caller (get -> miss -> compute ->
    put), so a slow fill never serializes readers; the worst case of
    two racing fills is a double compute with last-writer-wins, never
    a torn structure."""

    def __init__(self, name: str, max_entries: int = 256,
                 max_key_len: int = 0):
        self.name = name
        self.max_entries = int(max_entries)
        # 0 = unbounded; nonzero keys longer than this bypass the memo
        # entirely (don't pin megabyte bodies).
        self.max_key_len = int(max_key_len)
        self._mu = _GlobalLock(name)
        self._store: "dict" = {}
        self.stat_hits = 0
        self.stat_misses = 0
        self.stat_evictions = 0
        # Lockset-detector registration: a rebind of the store without
        # the named lock is a violation like any guarded field.
        guarded(self, "_store", lock=name)

    def _note_mutation(self) -> None:
        """Feed the lockset detector one store mutation (called with
        ``self._mu`` held, so the candidate lockset always contains the
        global's own name on disciplined paths)."""
        if _enabled:
            _checker.note_field_write(self, "NamedGlobal", "_store", self.name)

    def _bypass(self, key) -> bool:
        if _sched is not None:
            return True  # exploration: identical structure every execution
        return bool(self.max_key_len) and len(key) > self.max_key_len

    def get(self, key, default=None):
        if self._bypass(key):
            return default
        with self._mu:
            try:
                v = self._store.pop(key)
            except KeyError:
                self.stat_misses += 1
                return default
            self._store[key] = v  # re-insert = move to MRU end
            self.stat_hits += 1
            return v

    def put(self, key, value) -> None:
        if self._bypass(key):
            return
        with self._mu:
            self._store.pop(key, None)
            self._store[key] = value
            while len(self._store) > self.max_entries:
                self._store.pop(next(iter(self._store)))
                self.stat_evictions += 1
            self._note_mutation()

    def clear(self) -> None:
        with self._mu:
            self._store.clear()
            self._note_mutation()

    def __len__(self) -> int:
        with self._mu:
            return len(self._store)

    def __contains__(self, key) -> bool:
        with self._mu:
            return key in self._store

    def stats_snapshot(self) -> dict:
        with self._mu:
            return {
                "entries": len(self._store),
                "max_entries": self.max_entries,
                "hits": self.stat_hits,
                "misses": self.stat_misses,
                "evictions": self.stat_evictions,
            }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<NamedGlobal {self.name} entries={len(self)}>"


def named_global(name: str, max_entries: int = 256,
                 max_key_len: int = 0) -> NamedGlobal:
    """The registered-memo factory.  Idempotent per name (a module
    re-import gets the SAME store back — registry identity is the
    point); the first caller's bounds win."""
    with _named_globals_mu:
        g = _named_globals.get(name)
        if g is None:
            g = _named_globals[name] = NamedGlobal(
                name, max_entries=max_entries, max_key_len=max_key_len
            )
        return g


def named_globals() -> dict[str, NamedGlobal]:
    """Snapshot of the registry: the process's full inventory of
    sanctioned module-level mutable state (debug endpoints, tests)."""
    with _named_globals_mu:
        return dict(_named_globals)


def publish_global_stats(stats) -> None:
    """Fold every registered named-global's counters into a stats
    client as gauges tagged ``global:<name>`` — the /metrics handlers
    call this before rendering so memo behavior is scrapeable."""
    gs = named_globals()
    stats.gauge("analysis.globals.registered", len(gs))
    for name in sorted(gs):
        snap = gs[name].stats_snapshot()
        g_stats = stats.with_tags(f"global:{name}")
        g_stats.gauge("analysis.globals.entries", snap["entries"])
        g_stats.gauge("analysis.globals.hits", snap["hits"])
        g_stats.gauge("analysis.globals.misses", snap["misses"])
        g_stats.gauge("analysis.globals.evictions", snap["evictions"])


# -- blocking-call patches -------------------------------------------------


def _wrap_blocking(fn, kind):
    def wrapper(*a, **kw):
        s = _sched
        if s is not None:
            s.blocking_point(kind)
        _checker.note_blocking(kind)
        return fn(*a, **kw)

    wrapper.__lockcheck_orig__ = fn
    return wrapper


def _patch() -> None:
    global _patched
    if _patched:
        return
    _orig["os.fsync"] = os.fsync
    os.fsync = _wrap_blocking(os.fsync, "fsync")
    for meth in ("connect", "sendall", "send", "sendto", "recv", "recv_into", "accept"):
        attr = getattr(socket.socket, meth, None)
        if attr is None:  # pragma: no cover - platform variance
            continue
        _orig[f"socket.{meth}"] = attr
        setattr(socket.socket, meth, _wrap_blocking(attr, "socket"))
    _orig["subprocess.Popen.__init__"] = subprocess.Popen.__init__
    subprocess.Popen.__init__ = _wrap_blocking(
        subprocess.Popen.__init__, "subprocess"
    )
    _patched = True


def _unpatch() -> None:
    global _patched
    if not _patched:
        return
    os.fsync = _orig.pop("os.fsync")
    for meth in ("connect", "sendall", "send", "sendto", "recv", "recv_into", "accept"):
        orig = _orig.pop(f"socket.{meth}", None)
        if orig is not None:
            setattr(socket.socket, meth, orig)
    subprocess.Popen.__init__ = _orig.pop("subprocess.Popen.__init__")
    _patched = False


def sched_instrument() -> None:
    """Arm the seams an exploration run needs beyond the factories:
    guarded-class __setattr__ interception (field-write yield points)
    and the blocking-call patches.  Idempotent; shared with enable()."""
    _patch()
    for cls in _GUARDED_CLASSES:
        _patch_guarded_class(cls)


def sched_uninstrument() -> None:
    """Undo sched_instrument() UNLESS the full checker holds the same
    patches (enable() owns them then)."""
    if _enabled:
        return
    _unpatch()
    for cls in _GUARDED_CLASSES:
        _unpatch_guarded_class(cls)


# -- lifecycle -------------------------------------------------------------


def enable() -> None:
    """Turn the checker on for locks created FROM NOW ON (existing
    plain locks stay plain), patch the blocking-call probes, and
    instrument every registered guarded class's __setattr__."""
    global _enabled
    _enabled = True
    _patch()
    for cls in _GUARDED_CLASSES:
        _patch_guarded_class(cls)


def disable() -> None:
    global _enabled
    _enabled = False
    _unpatch()
    for cls in _GUARDED_CLASSES:
        _unpatch_guarded_class(cls)
    _checker.reset()


def reset() -> None:
    _checker.reset()


def take_violations() -> list[Violation]:
    return _checker.take_violations()


def check() -> None:
    """Raise LockCheckError if any violation was recorded since the
    last reset/take."""
    vs = _checker.take_violations()
    if vs:
        raise LockCheckError(
            f"{len(vs)} lock-discipline violation(s):\n\n"
            + "\n\n".join(v.describe() for v in vs)
        )


def _env_enabled() -> bool:
    return os.environ.get(ENV_VAR, "").lower() in ("1", "true", "yes")


if _env_enabled():  # subprocess workers inherit the env and self-enable
    enable()

    import atexit

    @atexit.register
    def _report_at_exit() -> None:  # pragma: no cover - subprocess path
        vs = _checker.take_violations()
        if vs:
            import sys

            print(
                f"[lockcheck] {len(vs)} violation(s) at exit:", file=sys.stderr
            )
            for v in vs:
                print(v.describe(), file=sys.stderr)
