"""The port's twin of tests/test_sched.py, plus parity with the reference.

Tests for the deterministic interleaving explorer (analysis/sched.py)
and the replica write-protocol model / conformance checkers
(analysis/spec.py): explorer mechanics, the live-tree scenario gate,
the seeded known-bug fixtures with schedule-string replay, small-scope
model checking, trace conformance, linearizability, and the seeded
random-schedule fuzzer."""

import pytest

from pilosa_tpu_torch.analysis import lockcheck, scenarios, sched, spec


@pytest.fixture(scope="module", autouse=True)
def _port_native_loaded():
    """The port's twin of conftest's session-wide ``native.load()`` for the
    reference: the first load takes the bridge's named lock, so a scenario
    whose first execution reaches it (qcache_store_vs_write) would count
    one more schedule on that execution than on every later one."""
    from pilosa_tpu_torch import native

    native.load()


# -- schedule strings --------------------------------------------------------


def test_schedule_string_roundtrip():
    seq = [0, 0, 0, 1, 1, 0, 2]
    s = sched.format_schedule(seq)
    assert s == "0x3,1x2,0,2"
    assert sched.parse_schedule(s) == seq
    assert sched.parse_schedule("") == []
    assert sched.parse_schedule("1") == [1]


# -- explorer mechanics (toy scenarios) --------------------------------------


class _LostUpdateCtx:
    """Unlocked read-modify-write on a guarded field: the canonical
    racy max()."""

    def __init__(self):
        self.g = _Guarded()

        def bump(n):
            def fn():
                cur = self.g.v
                self.g.v = max(cur, n)
            return fn

        self.threads = [bump(5), bump(9)]

    def check(self):
        assert self.g.v == 9, f"lost update: v={self.g.v}"


@lockcheck.guarded_class
class _Guarded:
    _guarded_by_ = {"v": "test.sched._mu"}

    def __init__(self):
        self.v = 0


class _DeadlockCtx:
    def __init__(self):
        self.a = lockcheck.named_lock("test.sched.A")
        self.b = lockcheck.named_lock("test.sched.B")

        def ab():
            with self.a:
                with self.b:
                    pass

        def ba():
            with self.b:
                with self.a:
                    pass

        self.threads = [ab, ba]

    def check(self):
        pass


def test_explorer_finds_lost_update_and_replays():
    sc = sched.Scenario("toy_lost_update", _LostUpdateCtx, known_bug=True)
    res = sched.explore(sc, bound=2)
    assert not res.ok
    bad = [o for o in res.outcomes if o.kind == "check"]
    assert bad
    # The printed schedule string replays the exact failure.
    outs = sched.replay(sc, bad[0].schedule)
    assert any(o.kind == "check" for o in outs)
    # A prefix that never interleaves (t0 runs out non-preempted, the
    # default policy completes the rest) stays clean.
    assert sched.replay(sc, "0") == []
    # A schedule prescribing a finished thread is reported, not hung.
    outs = sched.replay(sc, "0x50")
    assert any("diverged" in o.detail for o in outs)


def test_explorer_finds_deadlock_and_replays():
    sc = sched.Scenario("toy_deadlock", _DeadlockCtx, known_bug=True)
    res = sched.explore(sc, bound=2)
    dl = [o for o in res.outcomes if o.kind == "deadlock"]
    assert dl, res.describe()
    assert "test.sched" in dl[0].detail  # names the blocked locks
    outs = sched.replay(sc, dl[0].schedule)
    assert any(o.kind == "deadlock" for o in outs)


def test_explorer_bound_zero_is_single_nonpreemptive_family():
    # Bound 0 still explores forced switches (thread completion), so
    # the toy with 2 threads yields at least the two serial orders.
    sc = sched.Scenario("toy_lost_update", _LostUpdateCtx, known_bug=True)
    res0 = sched.explore(sc, bound=0)
    res2 = sched.explore(sc, bound=2)
    assert 1 <= res0.schedules <= res2.schedules


def test_explorer_determinism_same_bound_same_counts():
    for name in ("applied_seq_notes", "qcache_store_vs_write"):
        s = scenarios.get(name)
        a = sched.explore(s)
        b = sched.explore(s)
        assert a.schedules == b.schedules
        assert a.truncated == b.truncated
        assert sorted(o.schedule for o in a.outcomes) == sorted(
            o.schedule for o in b.outcomes
        )


# -- the tier-1 live-tree gate ----------------------------------------------


@pytest.mark.parametrize(
    "name", [s.name for s in scenarios.live_scenarios()]
)
def test_live_scenario_explores_clean(name):
    """Every registered non-fixture scenario must explore clean: a
    violation here is a REAL interleaving bug (fix it — do not baseline
    it)."""
    res = sched.explore(scenarios.get(name))
    assert res.ok, res.describe()
    assert res.schedules >= 2  # the exploration actually branched


# -- seeded known-bug fixtures ----------------------------------------------


@pytest.mark.parametrize(
    "name", [s.name for s in scenarios.known_bug_scenarios()]
)
def test_known_bug_found_and_schedule_replays(name):
    s = scenarios.get(name)
    res = sched.explore(s)
    assert res.outcomes, f"{name}: the seeded bug was NOT found"
    first = res.outcomes[0]
    outs = sched.replay(s, first.schedule)
    assert outs, f"{name}: schedule {first.schedule} did not reproduce"
    # Deterministic: the same schedule reproduces on every replay.
    outs2 = sched.replay(s, first.schedule)
    assert [o.kind for o in outs] == [o.kind for o in outs2]


def test_bug_compaction_flagged_by_trace_checker_too():
    res = sched.explore(scenarios.get("bug_compact_drops_unreplayed"))
    kinds = {o.kind for o in res.outcomes}
    assert "check" in kinds  # end-state invariant
    assert "trace" in kinds  # compact_plan floor conformance
    assert any("compaction floor" in o.detail for o in res.outcomes)


# -- small-scope exhaustive model checking -----------------------------------


def test_model_clean_at_small_scopes():
    for n_groups in (2, 3):
        res = spec.model_check(n_groups=n_groups, max_writes=2)
        assert res.ok, res.violations[:3]
        assert res.states > 100


def test_model_determinism():
    a = spec.model_check(n_groups=2, max_writes=2)
    b = spec.model_check(n_groups=2, max_writes=2)
    assert (a.states, a.transitions) == (b.states, b.transitions)


@pytest.mark.parametrize(
    "knob,needle",
    [
        ("break_quorum", "read-your-writes"),
        ("break_compaction", "lost"),
        ("break_abort", "tombstoned"),
    ],
)
def test_model_broken_variants_each_trip_their_invariant(knob, needle):
    res = spec.model_check(n_groups=3, max_writes=2, **{knob: True})
    assert not res.ok, f"{knob} explored clean — the checker is blind to it"
    assert any(needle in v for v in res.violations), res.violations[:3]


# -- sharded (2-shard x 2-replica) model -------------------------------------


def test_model_sharded_clean_at_two_by_two_scope():
    # The sharded acceptance scope: 2 shards x 2 replicas, each shard its
    # own sequence space, shared restart budget — explores clean.
    res = spec.model_check_sharded(n_shards=2, n_groups=2)
    assert res.ok, res.violations[:3]
    assert res.states > 1000


def test_model_sharded_determinism():
    a = spec.model_check_sharded()
    b = spec.model_check_sharded()
    assert (a.states, a.transitions) == (b.states, b.transitions)


@pytest.mark.parametrize(
    "knob,kwargs,needle",
    [
        ("break_quorum", {}, "merged read"),
        ("break_compaction", {"n_groups": 3, "max_writes_per_shard": 2},
         "lost"),
        ("break_abort", {}, "tombstoned"),
        ("break_routing", {}, "foreign"),
    ],
)
def test_model_sharded_broken_variants_each_trip(knob, kwargs, needle):
    res = spec.model_check_sharded(**{knob: True}, **kwargs)
    assert not res.ok, f"{knob} explored clean — the checker is blind to it"
    assert any(needle in v for v in res.violations), res.violations[:3]


def test_model_reshard_clean_and_fence_rules_trip():
    res = spec.model_check_reshard()
    assert res.ok, res.violations[:3]
    for knob in ("break_fence", "break_clear"):
        broken = spec.model_check_reshard(**{knob: True})
        assert not broken.ok, f"{knob} explored clean"
        assert any("missing acked" in v for v in broken.violations)


def test_trace_reshard_epoch_must_advance():
    bad = [
        ("reshard", {"src": 9, "shard": "s0", "epoch": 1}),
        ("reshard", {"src": 9, "shard": "s0", "epoch": 1}),
    ]
    out = spec.check_trace(bad)
    assert any("epoch did not advance" in v for v in out)
    ok = [
        ("reshard", {"src": 9, "shard": "s0", "epoch": 1}),
        ("reshard", {"src": 9, "shard": "s0b", "epoch": 2}),
    ]
    assert spec.check_trace(ok) == []


# -- trace conformance -------------------------------------------------------


def _ev(kind, **f):
    f.setdefault("src", 1)
    return (kind, f)


def test_trace_clean_protocol_round():
    events = [
        _ev("config", groups=["g0", "g1"], quorum=2),
        _ev("append", seq=1),
        _ev("apply", group="g0", seq=1, ok=True),
        _ev("apply", group="g1", seq=1, ok=True),
        _ev("mark", group="g0", epoch="g0@1", value=1),
        _ev("ack", seq=1, status=200, applied=2),
        _ev("read", group="g0", applied=1),
        _ev("compact_plan", floor=1, tracked={"g0": 1, "g1": 1}, floors=[]),
        _ev("wal_compact", floor=1),
    ]
    assert spec.check_trace(events) == []


def test_trace_violations_each_detected():
    cases = {
        "not strictly increasing": [
            _ev("append", seq=2), _ev("append", seq=2),
        ],
        "tombstoned": [
            _ev("append", seq=1),
            _ev("apply", group="g0", seq=1, ok=True),
            _ev("abort", seq=1),
        ],
        "AFTER its abort": [
            _ev("append", seq=1),
            _ev("abort", seq=1),
            _ev("apply", group="g0", seq=1, ok=True),
        ],
        "< quorum": [
            _ev("config", groups=["a", "b", "c"], quorum=2),
            _ev("append", seq=1),
            _ev("apply", group="a", seq=1, ok=True),
            _ev("ack", seq=1, status=200, applied=1),
        ],
        "regressed": [
            _ev("mark", group="g0", epoch="g0@1", value=5),
            _ev("mark", group="g0", epoch="g0@1", value=3),
        ],
        "exceeds the minimum tracked": [
            _ev("compact_plan", floor=5, tracked={"g0": 5, "g1": 2},
                floors=[]),
        ],
        "read-your-writes": [
            _ev("append", seq=1),
            _ev("apply", group="g0", seq=1, ok=True),
            _ev("ack", seq=1, status=200, applied=1),
            _ev("read", group="g1", applied=0),
        ],
    }
    for needle, events in cases.items():
        got = spec.check_trace(events)
        assert any(needle in v for v in got), (needle, got)


def test_trace_mark_regress_allowed_across_epochs():
    events = [
        _ev("mark", group="g0", epoch="g0@1", value=5),
        _ev("probe_mark", group="g0", epoch="g0@2", value=2),  # restarted
        _ev("mark", group="g0", epoch="g0@2", value=3),
    ]
    assert spec.check_trace(events) == []
    # But the same regress WITHIN an epoch is a violation.
    events = [
        _ev("probe_mark", group="g0", epoch="g0@1", value=5),
        _ev("probe_mark", group="g0", epoch="g0@1", value=2),
    ]
    assert any("regressed" in v for v in spec.check_trace(events))


def test_trace_tolerates_pre_collector_sequences():
    # A recovered WAL replays records this trace never saw appended.
    events = [
        _ev("apply", group="g0", seq=7, ok=True, replay=True),
        _ev("mark", group="g0", epoch="g0@1", value=7),
    ]
    assert spec.check_trace(events) == []


def test_emit_zero_cost_when_uninstalled():
    assert not spec.collector_installed()
    spec.emit("append", src=1, seq=1)  # must be a no-op, not an error
    events = spec.install_collector()
    try:
        spec.emit("append", src=1, seq=1)
        assert events == [("append", {"src": 1, "seq": 1})]
    finally:
        spec.uninstall_collector()


# -- linearizability ---------------------------------------------------------


def test_linearizable_bitmap_history():
    h = spec.LinHistory()
    a = h.invoke(0, "set", (0, 1))
    h.respond(a, True)
    b = h.invoke(1, "count")
    h.respond(b, 1)
    ok, _ = spec.check_linearizable(h, frozenset(), spec.bitmap_apply)
    assert ok


def test_non_linearizable_bitmap_history_rejected():
    h = spec.LinHistory()
    # count=1 completes BEFORE any set is invoked: impossible.
    b = h.invoke(1, "count")
    h.respond(b, 1)
    a = h.invoke(0, "set", (0, 1))
    h.respond(a, True)
    ok, detail = spec.check_linearizable(h, frozenset(), spec.bitmap_apply)
    assert not ok
    assert "no linearization" in detail


def test_qcache_spec_allows_conservative_decline_rejects_stale_hit():
    # Declining a store the generation would have allowed: linearizable.
    h = spec.LinHistory()
    a = h.invoke(0, "store", ("v0", 0))
    h.respond(a, False)
    ok, _ = spec.check_linearizable(h, (None, 0), spec.qcache_apply)
    assert ok
    # A get returning a value whose generation moved: NOT linearizable.
    h = spec.LinHistory()
    a = h.invoke(0, "store", ("v0", 0))
    h.respond(a, True)
    b = h.invoke(1, "bump")
    h.respond(b, None)
    c = h.invoke(2, "get")
    h.respond(c, "v0")  # stale hit after the bump completed
    ok, _ = spec.check_linearizable(h, (None, 0), spec.qcache_apply)
    assert not ok


# -- seeded random-schedule fuzzing ------------------------------------------


def test_fuzz_smoke_live_scenarios_clean():
    """Tier-1 smoke slice: a few seeded random schedules per light
    scenario; the full sweep is the slow-marked test below."""
    for name in ("applied_seq_notes", "ingest_resume_vs_apply",
                 "qcache_store_vs_write"):
        res = sched.fuzz(scenarios.get(name), seed=1234, runs=4)
        assert res.ok, res.describe()


def test_fuzz_finds_seeded_bug_and_is_deterministic():
    s = scenarios.get("bug_applied_seq_lost_update")
    a = sched.fuzz(s, seed=7, runs=16)
    b = sched.fuzz(s, seed=7, runs=16)
    assert sorted(o.schedule for o in a.outcomes) == sorted(
        o.schedule for o in b.outcomes
    )
    assert a.outcomes, "16 random schedules never lost the update"
    # The fuzz failure replays through the same schedule-string lane.
    outs = sched.replay(s, a.outcomes[0].schedule)
    assert any(o.kind == "check" for o in outs)


@pytest.mark.slow
def test_fuzz_sweep_fixed_seeds():
    """Dependency-free slow sweep: many deterministic seeds over every
    live scenario (the hypothesis variant below widens the draw where
    hypothesis is installed)."""
    for seed in range(8):
        for s in scenarios.live_scenarios():
            res = sched.fuzz(s, seed=seed, runs=4)
            assert res.ok, res.describe()


@pytest.mark.slow
def test_fuzz_sweep_hypothesis_seeds():
    """Beyond the preemption bound: hypothesis-drawn seeds over every
    live scenario (deterministic per seed — failures print replayable
    schedule strings)."""
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import HealthCheck, given, settings, strategies as st

    @given(seed=st.integers(min_value=0, max_value=2**32 - 1))
    @settings(max_examples=12, deadline=None,
              suppress_health_check=list(HealthCheck))
    def sweep(seed):
        for s in scenarios.live_scenarios():
            res = sched.fuzz(s, seed=seed, runs=3)
            assert res.ok, res.describe()

    sweep()


# -- the WAL bug the explorer found ------------------------------------------


def test_wal_append_after_close_refuses(tmp_path):
    """The append-vs-close scenario found a file-backed WAL silently
    buffering post-close appends to memory (a seq ACKed into nothing);
    it must refuse instead."""
    from pilosa_tpu_torch.replica.wal import WriteAheadLog

    wal = WriteAheadLog(str(tmp_path / "w.wal"), fsync=False)
    wal.append("POST", "/a", b"x")
    wal.close()
    with pytest.raises(OSError):
        wal.append("POST", "/b", b"y")
    with pytest.raises(OSError):
        wal.abort(1)
    # The in-memory log's close stays a no-op (no durability to lose).
    mem = WriteAheadLog(None)
    mem.append("POST", "/a", b"x")
    mem.close()
    assert mem.append("POST", "/b", b"y") == 2


# -- CLI ---------------------------------------------------------------------


def test_cli_explore_lists_scenarios(capsys):
    from pilosa_tpu_torch.analysis.__main__ import main

    assert main(["--explore"]) == 0
    out = capsys.readouterr().out
    assert "wal_append_vs_compact" in out
    assert "known-bug fixture" in out


def test_cli_explore_runs_one_scenario(capsys):
    from pilosa_tpu_torch.analysis.__main__ import main

    assert main(["--explore", "applied_seq_notes"]) == 0
    out = capsys.readouterr().out
    assert "applied_seq_notes" in out and "schedule(s)" in out


def test_cli_explore_bug_scenario_exits_nonzero_with_schedule(capsys):
    from pilosa_tpu_torch.analysis.__main__ import main

    assert main(["--explore", "bug_applied_seq_lost_update"]) == 1
    out = capsys.readouterr().out
    assert "schedule" in out
    # Pull a printed schedule and replay it through the CLI.
    line = next(l for l in out.splitlines() if "[check] schedule" in l)
    schedule = line.split("schedule", 1)[1].strip()
    assert main(["--explore", "bug_applied_seq_lost_update",
                 "--schedule", schedule]) == 1


def test_cli_replay_clean_schedule_exits_zero(capsys):
    from pilosa_tpu_torch.analysis.__main__ import main

    assert main(["--explore", "applied_seq_notes", "--schedule", "0"]) == 0
    assert "replayed clean" in capsys.readouterr().out


# -- parity with the reference package ---------------------------------------
#
# The scenarios drive the port's own WAL, router, qcache, ingest and
# fragment code; the reference's explorer drives the reference's.  Same
# bound, same schedule and truncation counts, same failures.

from pilosa_tpu.analysis import scenarios as ref_scenarios  # noqa: E402
from pilosa_tpu.analysis import sched as ref_sched  # noqa: E402
from pilosa_tpu.analysis import spec as ref_spec  # noqa: E402


def test_both_registries_hold_the_same_scenarios():
    def shape(mod):
        return sorted((n, s.known_bug, s.bound, s.trace_check, s.max_steps,
                       s.max_schedules)
                      for n, s in mod.SCENARIOS.items())

    assert shape(scenarios) == shape(ref_scenarios)


def _explore_both(name):
    ref = ref_sched.explore(ref_scenarios.get(name))
    port = sched.explore(scenarios.get(name))
    assert (port.bound, port.schedules, port.truncated) == (
        ref.bound, ref.schedules, ref.truncated)
    assert [(o.kind, o.schedule) for o in port.outcomes] == [
        (o.kind, o.schedule) for o in ref.outcomes]
    return ref, port


@pytest.mark.parametrize(
    "name", [s.name for s in scenarios.live_scenarios()]
)
def test_explorers_agree_on_live_scenario(name):
    ref, port = _explore_both(name)
    assert ref.ok and port.ok


@pytest.mark.parametrize(
    "name", [s.name for s in scenarios.known_bug_scenarios()]
)
def test_explorers_agree_on_known_bug_and_schedules_cross_replay(name):
    ref, port = _explore_both(name)
    assert port.outcomes, f"{name}: the seeded bug was NOT found"
    # The schedule the reference prints replays the failure in the port.
    first = ref.outcomes[0]
    outs = sched.replay(scenarios.get(name), first.schedule)
    assert first.kind in [o.kind for o in outs]


def test_protocol_models_agree():
    ref = ref_spec.model_check(n_groups=3, max_writes=2)
    port = spec.model_check(n_groups=3, max_writes=2)
    assert (port.states, port.transitions, port.violations) == (
        ref.states, ref.transitions, ref.violations)
    assert port.ok
