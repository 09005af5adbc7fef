"""The port's twin of tests/test_analysis.py, plus parity with the reference.

Tests for pilosa_tpu_torch/analysis/: the lint rules (golden firing +
passing fixtures each), suppression-comment and baseline round-trips,
the counters-registry generation/drift check, the runtime lock checker
(seeded order inversion, seeded blocking-under-lock, allowlists, the
generation-2 lockset race detector), the native-abi conformance gate,
the stale-suppression sweep, the CLI, and the LIVE-TREE GATE — the
tier-1 test that runs every pass over the real package and fails on new
findings (the in-suite half of the CI wiring; run_big_benches.sh runs
the same gate as a preflight).
"""

import os
import textwrap
import threading

import pytest

from pilosa_tpu_torch.analysis import engine, lockcheck, registry
from pilosa_tpu_torch.analysis.__main__ import main as analysis_main


# -- fixture harness --------------------------------------------------------


def _mkpkg(tmp_path, files: dict, registry_for=None):
    """Materialize a fake package tree and return its root path.
    ``registry_for`` writes a COUNTERS.md matching the given tree (or
    an explicit text when a str is passed)."""
    root = tmp_path / "pkg"
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    (root / "analysis").mkdir(exist_ok=True)
    if registry_for is not None:
        text = (
            registry_for
            if isinstance(registry_for, str)
            else registry.generate_counters_registry(str(root))
        )
        (root / "analysis" / registry.REGISTRY_NAME).write_text(text)
    return str(root)


def _run(root, rules):
    return engine.run_analysis(root=root, rules=rules)


def _new(findings):
    return engine.new_findings(findings)


# -- rule 1: lockstep-determinism ------------------------------------------

_DET_FIRING = {
    "parallel/service.py": """
    import os
    import time

    class Service:
        def _exec_batch_entries(self, entries):
            return det_helper(entries)

    def det_helper(entries):
        t = time.time()
        for x in {1, 2, 3}:
            t += x
        mode = os.environ.get("SOME_VAR")
        return t, mode
    """,
}


def test_determinism_fires_on_reachable_nondeterminism(tmp_path):
    root = _mkpkg(tmp_path, _DET_FIRING)
    msgs = [f.message for f in _new(_run(root, ("lockstep-determinism",)))]
    assert any("wall clock" in m for m in msgs)
    assert any("iteration over a set" in m for m in msgs)
    assert any("environment read" in m for m in msgs)


def test_determinism_passes_unreachable_and_sorted(tmp_path):
    files = {
        "parallel/service.py": """
        import time

        class Service:
            def _exec_batch_entries(self, entries):
                for x in sorted({1, 2, 3}):
                    pass
                return len(entries)

        def never_called_from_batch():
            return time.time()
        """,
    }
    root = _mkpkg(tmp_path, files)
    assert _new(_run(root, ("lockstep-determinism",))) == []


# -- rule 2: lock-discipline ------------------------------------------------


def test_lock_discipline_fires_on_raw_primitive(tmp_path):
    root = _mkpkg(
        tmp_path,
        {"mod.py": """
        import threading

        class T:
            def __init__(self):
                self.mu = threading.Lock()
                self.cv = threading.Condition()
        """},
    )
    fs = _new(_run(root, ("lock-discipline",)))
    assert len(fs) == 2
    assert "named_lock" in fs[0].message
    assert "named_condition" in fs[1].message


def test_lock_discipline_passes_factories(tmp_path):
    root = _mkpkg(
        tmp_path,
        {"mod.py": """
        from pilosa_tpu_torch.analysis import lockcheck

        class T:
            def __init__(self):
                self.mu = lockcheck.named_lock("t.mu")
                self.cv = lockcheck.named_condition("t.cv")
        """},
    )
    assert _new(_run(root, ("lock-discipline",))) == []


# -- rule 3: stats-registry -------------------------------------------------

_STATS_MOD = {
    "mod.py": """
    class T:
        def __init__(self, stats):
            self.stats = stats

        def work(self, cls):
            self.stats.count("t.known")
            self.stats.gauge(f"t.by_class.{cls}", 1)
    """,
}


def test_stats_registry_passes_when_registered(tmp_path):
    root = _mkpkg(tmp_path, _STATS_MOD, registry_for=True)
    text = (tmp_path / "pkg" / "analysis" / registry.REGISTRY_NAME).read_text()
    # f-strings normalize to <x> patterns in the generated registry
    assert "`t.by_class.<cls>`" in text
    assert _new(_run(root, ("stats-registry",))) == []


def test_stats_registry_fires_on_unknown_name_and_drift(tmp_path):
    root = _mkpkg(tmp_path, _STATS_MOD, registry_for=True)
    # a new emission lands without regenerating the registry
    mod = tmp_path / "pkg" / "mod.py"
    mod.write_text(mod.read_text().replace(
        'self.stats.count("t.known")',
        'self.stats.count("t.known")\n        self.stats.count("t.brand_new")',
    ))
    fs = _new(_run(root, ("stats-registry",)))
    assert any("`t.brand_new` not in the counters registry" in f.message for f in fs)
    assert any("registry is stale" in f.message and "--write-registry" in f.message
               for f in fs)


def test_stats_registry_fires_when_missing(tmp_path):
    root = _mkpkg(tmp_path, _STATS_MOD)
    fs = _new(_run(root, ("stats-registry",)))
    assert len(fs) == 1 and "registry missing" in fs[0].message


# -- rule 4: exception-hygiene ----------------------------------------------


def test_exception_hygiene_fires_on_silent_swallow(tmp_path):
    root = _mkpkg(
        tmp_path,
        {"mod.py": """
        def f():
            try:
                g()
            except Exception:
                pass
        """},
    )
    fs = _new(_run(root, ("exception-hygiene",)))
    assert len(fs) == 1 and "broad except swallows" in fs[0].message


def test_exception_hygiene_passes_stat_reraise_use(tmp_path):
    root = _mkpkg(
        tmp_path,
        {"mod.py": """
        def counted(stats):
            try:
                g()
            except Exception:
                stats.count("mod.errors")

        def reraised():
            try:
                g()
            except Exception:
                raise RuntimeError("wrapped")

        def used(errs):
            try:
                g()
            except Exception as e:
                errs.append(e)

        def narrow():
            try:
                g()
            except ValueError:
                pass
        """},
    )
    assert _new(_run(root, ("exception-hygiene",))) == []


# -- rule 5: deadline-propagation ------------------------------------------


def test_deadline_propagation_fires_on_dropped_budget(tmp_path):
    root = _mkpkg(
        tmp_path,
        {"mod.py": """
        def fan_out(client, index, q, deadline):
            return client.execute_remote(index, q)
        """},
    )
    fs = _new(_run(root, ("deadline-propagation",)))
    assert len(fs) == 1 and "without deadline=" in fs[0].message


def test_deadline_propagation_passes_forwarded(tmp_path):
    root = _mkpkg(
        tmp_path,
        {"mod.py": """
        def fan_out(client, index, q, deadline):
            return client.execute_remote(index, q, deadline=deadline)

        def via_opts(client, index, q, opt):
            return client.execute_remote(index, q, deadline=opt.deadline)

        def via_kwargs(client, index, q, deadline, kw):
            return client.execute_remote(index, q, **kw)

        def no_deadline_in_scope(client, index, q):
            return client.execute_remote(index, q)
        """},
    )
    assert _new(_run(root, ("deadline-propagation",))) == []


# -- rule 6: guarded-fields -------------------------------------------------


_GUARDED_FIRING = {
    "mod.py": """
    from pilosa_tpu_torch.analysis import lockcheck

    class Store:
        _guarded_by_ = {"table": "store._mu", "count": "store._mu"}

        def __init__(self):
            self._mu = lockcheck.named_lock("store._mu")
            self.table = {}
            self.count = 0

        def racy_rebind(self):
            self.count = self.count + 1

        def racy_item(self, k, v):
            self.table[k] = v

        def racy_call(self, k):
            self.table.pop(k, None)
    """,
}


def test_guarded_fields_fires_on_unlocked_mutations(tmp_path):
    root = _mkpkg(tmp_path, _GUARDED_FIRING)
    fs = _new(_run(root, ("guarded-fields",)))
    kinds = {(f.scope, f.message.split("this ")[1].split(" mutation")[0]) for f in fs}
    assert ("Store.racy_rebind", "rebind") in kinds
    assert ("Store.racy_item", "item") in kinds
    assert ("Store.racy_call", "call") in kinds
    assert len(fs) == 3  # __init__ writes are lifecycle-exempt


def test_guarded_fields_passes_locked_and_locked_call_paths(tmp_path):
    files = {
        "mod.py": """
        from pilosa_tpu_torch.analysis import lockcheck

        class Store:
            _guarded_by_ = {"table": "store._mu"}

            def __init__(self):
                self._mu = lockcheck.named_lock("store._mu")
                self.table = {}

            def put(self, k, v):
                with self._mu:
                    self.table[k] = v

            def _drop_locked(self, k):
                # no acquisition here, but every caller path holds one
                self.table.pop(k, None)

            def drop(self, k):
                with self._mu:
                    self._drop_locked(k)

            def open(self):
                self.table = {}  # lifecycle-exempt

            def _reset_from_open(self):
                self.table = {}  # only reachable from open(): init phase

        class NotDeclared:
            def free(self):
                self.table = {}
        """,
    }
    root = _mkpkg(tmp_path, files)
    # open() calls _reset_from_open through a non-stoplisted name
    p = tmp_path / "pkg" / "mod.py"
    p.write_text(p.read_text().replace(
        "self.table = {}  # lifecycle-exempt",
        "self.table = {}  # lifecycle-exempt\n        self._reset_from_open()",
    ))
    assert _new(_run(root, ("guarded-fields",))) == []


# -- rule 7: native-abi ------------------------------------------------------


_ABI_CPP_OK = """
#include <cstdint>
extern "C" {

int64_t pn_write_batch(const char* src, int64_t len,
                       const uint64_t* keys, int64_t* ns, int32_t wal_fd,
                       int64_t* applied) {
    (void)src; (void)keys; (void)ns; (void)applied; (void)wal_fd;
    return len;
}

uint64_t pn_fnv1a64(const uint8_t* data, size_t len) { (void)data; return len; }

}  // extern "C"

// outside extern "C": never considered
int64_t pn_internal_helper(int64_t x) { return x; }
"""

_ABI_PY_OK = """
import ctypes

def load():
    lib = ctypes.CDLL("x.so")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.pn_write_batch.restype = ctypes.c_int64
    lib.pn_write_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pn_fnv1a64.restype = ctypes.c_uint64
    lib.pn_fnv1a64.argtypes = [u8p, ctypes.c_size_t]
    return lib
"""


def _mk_abi_tree(tmp_path, py_src=_ABI_PY_OK, cpp_src=_ABI_CPP_OK):
    root = _mkpkg(tmp_path, {"native.py": py_src})
    native_dir = tmp_path / "native"
    native_dir.mkdir(exist_ok=True)
    (native_dir / "pilosa_native.cpp").write_text(textwrap.dedent(cpp_src))
    return root


def test_native_abi_passes_conformant_fixture(tmp_path):
    root = _mk_abi_tree(tmp_path)
    assert _new(_run(root, ("native-abi",))) == []


def test_native_abi_fails_mutated_write_batch_signature(tmp_path):
    # The C side grows an argument (parse flags) — the Python table was
    # not updated: the classic silent-drift-into-memory-corruption case.
    mutated = _ABI_CPP_OK.replace(
        "int64_t* ns, int32_t wal_fd,",
        "int64_t* ns, int32_t wal_fd, int32_t flags,",
    )
    root = _mk_abi_tree(tmp_path, cpp_src=mutated)
    fs = _new(_run(root, ("native-abi",)))
    assert len(fs) == 1 and "arity mismatch" in fs[0].message
    assert fs[0].scope == "pn_write_batch" and fs[0].path == "native.py"


def test_native_abi_fails_width_mismatch_and_missing_symbol(tmp_path):
    # wal_fd narrows to int32 on the C side while Python says 64-bit,
    # and a declared function vanishes from the source entirely.
    py = _ABI_PY_OK.replace("ctypes.c_int32,", "ctypes.c_int64,")
    py = py.replace(
        "    return lib",
        "    lib.pn_vanished.restype = None\n"
        "    lib.pn_vanished.argtypes = []\n"
        "    return lib",
    )
    root = _mk_abi_tree(tmp_path, py_src=py)
    msgs = [f.message for f in _new(_run(root, ("native-abi",)))]
    assert any("width mismatch" in m and "pn_write_batch" in m for m in msgs)
    assert any("missing symbol" in m and "pn_vanished" in m for m in msgs)


def test_native_abi_real_tree_is_conformant():
    """The real bridge (30 signatures incl. the 22-arg pn_write_batch)
    against the real C++ and the built .so: zero issues.  Part of the
    live gate too; asserted directly so a drift names the function."""
    from pilosa_tpu_torch.analysis import abi, rules

    root = engine.package_root()
    native_dir = os.path.join(os.path.dirname(root), "native")
    cpp = os.path.join(native_dir, rules.NATIVE_CPP_NAME)
    if not os.path.exists(cpp):
        pytest.skip("no native source next to the package")
    issues = abi.check_abi(
        cpp, os.path.join(root, "native.py"),
        so_path=os.path.join(native_dir, rules.NATIVE_SO_NAME),
    )
    assert issues == [], "\n".join(i.message for i in issues)
    # The parser really covered the bridge (a regression that parses
    # nothing would vacuously pass): every declared pn_* was matched.
    decls = abi.parse_ctypes_decls(os.path.join(root, "native.py"))
    assert len(decls) >= 20
    assert "pn_write_batch" in decls and len(decls["pn_write_batch"][1]) == 23


# -- rule 8: stale-suppression ----------------------------------------------


def test_stale_suppression_fires_on_dead_and_unknown_tags(tmp_path):
    root = _mkpkg(
        tmp_path,
        {"mod.py": """
        def f():
            try:
                g()
            # analysis-ok: exception-hygiene: live tag, still fires below
            except Exception:
                pass

        # analysis-ok: exception-hygiene: nothing fires at this site
        X = 1
        # analysis-ok: no-such-rule: bogus rule name
        Y = 2
        """},
    )
    fs = _new(_run(root, ("exception-hygiene", "stale-suppression")))
    assert len(fs) == 2
    assert all(f.rule == "stale-suppression" for f in fs)
    assert any("no longer matches any finding" in f.message for f in fs)
    assert any("unknown rule `no-such-rule`" in f.message for f in fs)


def test_stale_suppression_subset_run_spares_other_rules_tags(tmp_path):
    # A lock-discipline-only run must not call a live exception-hygiene
    # tag stale just because that rule didn't run.
    root = _mkpkg(
        tmp_path,
        {"mod.py": """
        def f():
            try:
                g()
            # analysis-ok: exception-hygiene: live tag
            except Exception:
                pass
        """},
    )
    assert _new(_run(root, ("lock-discipline", "stale-suppression"))) == []
    # ...but the full run keeps it counted as USED, not stale.
    assert _new(_run(root, ("exception-hygiene", "stale-suppression"))) == []


def test_stale_suppression_empty_reason_tag_is_not_double_reported(tmp_path):
    # An empty-reason tag does not suppress (the finding stays NEW) —
    # but it is attached to a live finding, so the sweep must not ALSO
    # call it stale.
    root = _mkpkg(
        tmp_path,
        {"mod.py": """
        def f():
            try:
                g()
            # analysis-ok: exception-hygiene:
            except Exception:
                pass
        """},
    )
    fs = _new(_run(root, ("exception-hygiene", "stale-suppression")))
    assert [f.rule for f in fs] == ["exception-hygiene"]


# -- deadline-propagation: replica forward paths ----------------------------


def test_deadline_propagation_covers_replica_forwards(tmp_path):
    root = _mkpkg(
        tmp_path,
        {"replica/router.py": """
        class Router:
            def route(self, g, body, deadline):
                return self._forward(g, "POST", "/q", body, {})
        """},
    )
    fs = _new(_run(root, ("deadline-propagation",)))
    assert len(fs) == 1 and "._forward(...)" in fs[0].message


def test_deadline_propagation_accepts_timeout_s_budget(tmp_path):
    root = _mkpkg(
        tmp_path,
        {"replica/catchup.py": """
        class Catchup:
            def _replay_one(self, g, rec, timeout_s=None):
                return self.router._forward(
                    g, rec.method, rec.path, rec.body, {}, timeout_s=timeout_s
                )

            def drain(self, g, deadline):
                return self._replay_one(g, None, timeout_s=deadline.remaining_s())
        """},
    )
    assert _new(_run(root, ("deadline-propagation",))) == []


# -- rules 9+10: global-mutable-state + check-then-act ---------------------

_GIL_FIRING = {
    "server/handler.py": """
    def handle_query(req):
        return lookup(req)
    """,
    "mod.py": """
    _CACHE = {}
    _FROZEN = ("a", "b")

    def lookup(key):
        if key in _CACHE:
            return _CACHE[key]
        v = probe(key)
        _CACHE[key] = v
        return v

    def probe(key):
        return key
    """,
}


def test_global_mutable_state_fires_on_serving_reachable_mutation(tmp_path):
    root = _mkpkg(tmp_path, _GIL_FIRING)
    fs = _new(_run(root, ("global-mutable-state",)))
    assert len(fs) == 1
    f = fs[0]
    assert f.scope == "<module>" and f.path == "mod.py"
    assert "module-level mutable `_CACHE`" in f.message
    assert "lockcheck.named_global" in f.message


def test_global_mutable_state_passes_seam_frozen_and_unreachable(tmp_path):
    files = {
        "server/handler.py": """
        def handle_query(req):
            return lookup(req)
        """,
        "mod.py": """
        from pilosa_tpu_torch.analysis import lockcheck

        _MEMO = lockcheck.named_global("mod.memo", max_entries=64)
        _TABLE = {"a": 1}      # read-only at runtime: frozen at import
        _OFFLINE = {}          # mutated only by an unreachable tool path

        def lookup(key):
            v = _MEMO.get(key)
            if v is None:
                v = _TABLE.get(key)
                _MEMO.put(key, v)
            return v

        def offline_rebuild():
            _OFFLINE["x"] = 1
        """,
    }
    root = _mkpkg(tmp_path, files)
    assert _new(_run(root, ("global-mutable-state",))) == []


def test_global_mutable_state_suppression_tags(tmp_path):
    files = dict(_GIL_FIRING)
    files["mod.py"] = """
    # analysis-ok: global-mutable-state: fixture reason — import-time only in production
    _CACHE = {}

    def lookup(key):
        if key in _CACHE:
            return _CACHE[key]
        _CACHE[key] = key
        return key
    """
    root = _mkpkg(tmp_path, files)
    fs = _run(root, ("global-mutable-state",))
    assert _new(fs) == [] and any(f.suppressed for f in fs)


def test_check_then_act_fires_all_four_shapes(tmp_path):
    files = {
        "server/handler.py": """
        def handle_query(req, h):
            return h.serve(req)
        """,
        "mod.py": """
        class Handler:
            def serve(self, req):
                self.total += 1
                self.stat_requests += 1
                if req in self.seen:
                    return self.seen[req]
                v = self.table.get(req)
                if v is None:
                    self.table[req] = object()
                self.pending.setdefault(req, [])
                return v
        """,
    }
    root = _mkpkg(tmp_path, files)
    msgs = [f.message for f in _new(_run(root, ("check-then-act",)))]
    assert any("read-modify-write of shared `self.total`" in m for m in msgs)
    assert any("membership test on `self.seen`" in m for m in msgs)
    assert any("`self.table.get(...)`" in m and "paired" in m for m in msgs)
    assert any("`self.pending.setdefault(...)`" in m for m in msgs)
    # The approximate-counter convention: stat_* increments are exempt.
    assert not any("stat_requests" in m for m in msgs)


def test_check_then_act_passes_locked_lifecycle_and_locals(tmp_path):
    files = {
        "server/handler.py": """
        def handle_query(req, h):
            return h.serve(req)
        """,
        "mod.py": """
        from pilosa_tpu_torch.analysis import lockcheck

        class Handler:
            def __init__(self):
                self.table = {}          # lifecycle-exempt
                self._mu = lockcheck.named_lock("h._mu")

            def serve(self, req):
                local = {}
                if req in local:         # thread-private: no receiver
                    return local[req]
                return self._serve_locked(req)

            def _serve_locked(self, req):
                with self._mu:
                    if req in self.table:
                        return self.table[req]
                    self.table[req] = object()
                    return self.table[req]

        def never_served(h):
            h.counter += 1               # unreachable from the entries
        """,
    }
    root = _mkpkg(tmp_path, files)
    assert _new(_run(root, ("check-then-act",))) == []


def test_check_then_act_suppression_tag(tmp_path):
    files = {
        "server/handler.py": """
        def handle_query(req, h):
            return h.serve(req)
        """,
        "mod.py": """
        class Handler:
            def serve(self, req):
                # analysis-ok: check-then-act: fixture reason — externally synchronized
                self.total += 1
                return self.total
        """,
    }
    root = _mkpkg(tmp_path, files)
    fs = _run(root, ("check-then-act",))
    assert _new(fs) == [] and any(f.suppressed for f in fs)


# -- suppression + baseline round-trips ------------------------------------


def test_suppression_comment_round_trip(tmp_path):
    root = _mkpkg(
        tmp_path,
        {"mod.py": """
        def f():
            try:
                g()
            # analysis-ok: exception-hygiene: fixture reason
            except Exception:
                pass

        def g():
            try:
                h()
            # analysis-ok: exception-hygiene:
            except Exception:
                pass
        """},
    )
    fs = _run(root, ("exception-hygiene",))
    assert len(fs) == 2
    by_scope = {f.scope: f for f in fs}
    assert by_scope["f"].suppressed  # reason given
    assert not by_scope["g"].suppressed  # empty reason does not suppress
    assert [f.scope for f in _new(fs)] == ["g"]


def test_baseline_round_trip(tmp_path):
    files = {"mod.py": """
    def f():
        try:
            g()
        except Exception:
            pass
    """}
    root = _mkpkg(tmp_path, files)
    fs = _run(root, ("exception-hygiene",))
    assert len(_new(fs)) == 1
    engine.write_baseline(engine.baseline_path(root), fs)
    fs2 = _run(root, ("exception-hygiene",))
    assert len(fs2) == 1 and fs2[0].baselined
    assert _new(fs2) == []
    # a SECOND identical violation in the same scope is NEW (occurrence
    # index keeps fingerprints distinct)
    mod = tmp_path / "pkg" / "mod.py"
    mod.write_text(mod.read_text() + textwrap.dedent("""
    def f2():
        try:
            g()
        except Exception:
            pass
    """))
    fs3 = _run(root, ("exception-hygiene",))
    assert len(_new(fs3)) == 1


# -- CLI --------------------------------------------------------------------


def test_cli_exit_codes_and_write_flows(tmp_path, capsys):
    root = _mkpkg(tmp_path, _STATS_MOD)
    # registry missing -> nonzero
    assert analysis_main(["--root", root, "--rules", "stats-registry"]) == 1
    assert analysis_main(["--root", root, "--write-registry"]) == 0
    assert analysis_main(["--root", root, "--rules", "stats-registry"]) == 0
    assert analysis_main(["--root", root, "--rules", "nope"]) == 2
    out = capsys.readouterr().out
    assert "0 NEW" in out


# -- runtime lock checker ---------------------------------------------------


@pytest.fixture
def checker():
    """Explicitly-enabled checker, restored afterwards (this module is
    not in conftest's auto-enabled set)."""
    lockcheck.enable()
    lockcheck.reset()
    try:
        yield lockcheck.checker()
    finally:
        lockcheck.take_violations()
        lockcheck.disable()


def test_lockcheck_seeded_order_inversion(checker):
    a = lockcheck.named_lock("t.a")
    b = lockcheck.named_lock("t.b")

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    t1 = threading.Thread(target=ab)
    t1.start()
    t1.join()
    t2 = threading.Thread(target=ba)
    t2.start()
    t2.join()
    vs = lockcheck.take_violations()
    assert len(vs) == 1 and vs[0].kind == "lock-order-cycle"
    assert "t.a" in vs[0].detail and "t.b" in vs[0].detail


def test_lockcheck_consistent_order_is_clean(checker):
    a = lockcheck.named_lock("t.a")
    b = lockcheck.named_lock("t.b")
    for _ in range(3):
        with a:
            with b:
                pass
    assert lockcheck.take_violations() == []


def test_lockcheck_rlock_reentry_no_self_edge(checker):
    r = lockcheck.named_rlock("t.r")
    with r:
        with r:
            pass
    assert lockcheck.take_violations() == []


def test_lockcheck_seeded_blocking_under_lock(checker, tmp_path):
    mu = lockcheck.named_lock("t.mu")
    f = open(tmp_path / "x", "wb")
    try:
        with mu:
            os.fsync(f.fileno())
        vs = lockcheck.take_violations()
        assert len(vs) == 1 and vs[0].kind == "blocking-under-lock"
        assert "fsync" in vs[0].detail and "t.mu" in vs[0].detail
    finally:
        f.close()


def test_lockcheck_blocking_without_lock_is_clean(checker, tmp_path):
    f = open(tmp_path / "x", "wb")
    try:
        os.fsync(f.fileno())
    finally:
        f.close()
    assert lockcheck.take_violations() == []


def test_lockcheck_scoped_allow(checker, tmp_path):
    mu = lockcheck.named_lock("t.mu")
    f = open(tmp_path / "x", "wb")
    try:
        with mu:
            with lockcheck.allowed("fsync"):
                os.fsync(f.fileno())
    finally:
        f.close()
    assert lockcheck.take_violations() == []


def test_lockcheck_allowlist_pair(checker, tmp_path):
    mu = lockcheck.named_lock("t.allowed_mu")
    checker.allow_pairs.add(("t.allowed_mu", "fsync"))
    f = open(tmp_path / "x", "wb")
    try:
        with mu:
            os.fsync(f.fileno())
    finally:
        f.close()
        checker.allow_pairs.discard(("t.allowed_mu", "fsync"))
    assert lockcheck.take_violations() == []


def test_lockcheck_condition_wait_releases_held_state(checker):
    cv = lockcheck.named_condition("t.cv")
    other = lockcheck.named_lock("t.other")
    woke = threading.Event()

    def waiter():
        with cv:
            cv.wait(timeout=5.0)
        # after the wait returned we re-held and released t.cv; taking
        # another lock now must not see t.cv as held
        with other:
            pass
        woke.set()

    t = threading.Thread(target=waiter)
    t.start()
    # let the waiter block, then wake it
    import time

    time.sleep(0.1)
    with cv:
        cv.notify_all()
    t.join(timeout=5.0)
    assert woke.is_set()
    assert lockcheck.take_violations() == []


def test_lockcheck_disabled_factories_are_plain():
    assert not lockcheck.enabled()
    assert type(lockcheck.named_lock("x")) is type(threading.Lock())
    assert isinstance(lockcheck.named_rlock("x"), type(threading.RLock()))


# -- runtime lockset race detector (generation 2) ---------------------------


def _spawn(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive()


def test_lockset_detects_two_thread_unguarded_mutation(checker):
    """The seeded race fixture: one thread writes under the declared
    lock, a second writes with no lock — empty intersection, violation
    with BOTH witness stacks."""

    @lockcheck.guarded_class
    class Shared:
        _guarded_by_ = {"val": "t.mu"}

        def __init__(self):
            self.val = 0

    mu = lockcheck.named_lock("t.mu")
    s = Shared()

    def locked_writer():
        with mu:
            s.val = 1

    _spawn(locked_writer)
    s.val = 2  # main thread, no lock held: the race
    vs = lockcheck.take_violations()
    assert len(vs) == 1 and vs[0].kind == "lockset-race"
    assert "Shared.val" in vs[0].detail and "t.mu" in vs[0].detail
    assert "first-witness" in vs[0].detail  # earliest recorded write stack
    assert vs[0].stack  # the emptying write's stack


def test_lockset_clean_when_every_write_holds_the_lock(checker):
    @lockcheck.guarded_class
    class Shared:
        _guarded_by_ = {"val": "t.mu"}

        def __init__(self):
            self.val = 0

    mu = lockcheck.named_lock("t.mu")
    s = Shared()

    def w():
        with mu:
            s.val += 1

    for _ in range(3):
        _spawn(w)
    with mu:
        s.val = 99
    assert lockcheck.take_violations() == []


def test_lockset_any_common_lock_suffices(checker):
    """Eraser semantics: the candidate set is the INTERSECTION of held
    locks — a consistent lock other than the declared one still means
    no race (the declaration names the intent, the model checks mutual
    exclusion)."""

    @lockcheck.guarded_class
    class Shared:
        _guarded_by_ = {"val": "t.mu"}

        def __init__(self):
            self.val = 0

    other = lockcheck.named_lock("t.other")
    s = Shared()

    def w():
        with other:
            s.val += 1

    _spawn(w)
    _spawn(w)
    assert lockcheck.take_violations() == []


def test_lockset_init_phase_single_thread_exempt(checker):
    """Unlocked writes BEFORE the object is shared are the normal
    construction pattern, never a violation; the lockset only starts
    refining at the first second-thread write."""

    @lockcheck.guarded_class
    class Shared:
        _guarded_by_ = {"val": "t.mu"}

        def __init__(self):
            self.val = 0

    mu = lockcheck.named_lock("t.mu")
    s = Shared()
    s.val = 1  # still exclusive: fine without the lock
    s.val = 2

    def w():
        with mu:
            s.val = 3

    _spawn(w)
    with mu:
        s.val = 4  # post-sharing writes hold the lock
    assert lockcheck.take_violations() == []


def test_lockset_post_sharing_unlocked_write_by_creator_is_caught(checker):
    """The inverse of the init exemption: once a second thread writes,
    the CREATOR loses its free pass too."""

    @lockcheck.guarded_class
    class Shared:
        _guarded_by_ = {"val": "t.mu"}

        def __init__(self):
            self.val = 0

    mu = lockcheck.named_lock("t.mu")
    s = Shared()

    def w():
        with mu:
            s.val = 1

    _spawn(w)
    _spawn(w)
    s.val = 2  # creator, no lock, object is shared now
    vs = lockcheck.take_violations()
    assert len(vs) == 1 and vs[0].kind == "lockset-race"
    # thread idents can be recycled between the two spawns, so only the
    # floor is stable: the creator plus at least one worker
    assert "threads observed" in vs[0].detail


def test_lockset_instance_level_guarded_registration(checker):
    class Plain:
        pass

    p = Plain()
    lockcheck.guarded(p, "x", lock="t.mu")
    p.x = 0

    def w():
        p.x = 1  # second thread, no lock

    _spawn(w)
    vs = lockcheck.take_violations()
    assert len(vs) == 1 and "Plain.x" in vs[0].detail
    # undeclared attributes on the same object stay untracked
    lockcheck.reset()
    p.y = 0
    _spawn(lambda: setattr(p, "y", 1))
    assert lockcheck.take_violations() == []


def test_lockset_undeclared_fields_untracked_and_disable_restores(checker):
    @lockcheck.guarded_class
    class Shared:
        _guarded_by_ = {"val": "t.mu"}

        def __init__(self):
            self.val = 0
            self.free = 0

    s = Shared()
    _spawn(lambda: setattr(s, "free", 1))
    s.free = 2
    assert lockcheck.take_violations() == []
    assert "__lockcheck_wrapped_setattr__" in Shared.__dict__
    lockcheck.disable()
    try:
        assert "__lockcheck_wrapped_setattr__" not in Shared.__dict__
        s.val = 5  # plain setattr again, nothing recorded
        assert lockcheck.take_violations() == []
    finally:
        lockcheck.enable()  # the fixture's finally expects enabled state


def test_lockset_real_tree_fragment_declares_guarded_state():
    """The declarations the port ships: the hot shared structures carry
    _guarded_by_ maps naming their real locks (spot-check the contract
    the conftest-gated suites run under)."""
    from pilosa_tpu_torch.core.fragment import Fragment
    from pilosa_tpu_torch.replica.router import GroupState, ReplicaRouter, ShardRuntime
    from pilosa_tpu_torch.replica.wal import WriteAheadLog
    from pilosa_tpu_torch.qcache import QueryCache
    from pilosa_tpu_torch.ingest import StreamIngestor, WriteQueue
    from pilosa_tpu_torch.executor import Executor

    assert Fragment._guarded_by_["storage"] == "core.fragment._mu"
    assert Fragment._guarded_by_["generation"] == "core.fragment._mu"
    assert GroupState._guarded_by_["applied_seq"] == "replica.router._mu"
    assert ShardRuntime._guarded_by_["write_seq"] == "replica.router._seq_mu"
    assert ReplicaRouter._guarded_by_["_fleet_cache"] == "replica.router._fleet_mu"
    assert WriteAheadLog._guarded_by_["_synced_off"] == "replica.wal._sync_cv"
    assert QueryCache._guarded_by_["_store"] == "qcache._mu"
    assert StreamIngestor._guarded_by_["_transfers"] == "ingest.stream._mu"
    assert WriteQueue._guarded_by_["_committing"] == "ingest._mu"
    assert Executor._guarded_by_["_serve_states"] == "executor._matrix_mu"


# -- the live-tree gate (CI smoke tier) ------------------------------------


def test_live_tree_analysis_gate():
    """`python -m pilosa_tpu_torch.analysis` over the REAL package: every rule
    runs and no new findings exist.  This is the tier-1 CI gate — a new
    un-suppressed, un-baselined finding fails the suite with the same
    report the CLI prints."""
    findings = engine.run_analysis()
    fresh = engine.new_findings(findings)
    assert fresh == [], "new analysis findings:\n" + "\n".join(
        f.render() for f in fresh
    )


def test_live_tree_registry_is_current():
    """Committed COUNTERS.md must match regeneration exactly (the
    stats-registry drift half of the gate, asserted directly so the
    failure message carries the regenerate hint)."""
    root = engine.package_root()
    with open(registry.registry_path(root), encoding="utf-8") as f:
        committed = f.read()
    assert committed == registry.generate_counters_registry(root), (
        "counters registry is stale — run "
        "`python -m pilosa_tpu_torch.analysis --write-registry` and commit"
    )


# -- parity with the reference package ---------------------------------------
#
# Both packages' engines over the same trees must give the same findings:
# rule, path, line, scope, flags, and the message once the port's module
# name is read as the reference's.  One code difference is expected and
# asserted where it shows: the counters registry's generated header names
# the CLI that wrote it (registry._HEADER), so an engine reading a
# registry written by the other package's CLI reports "formatting drift"
# there, and nothing else.

import ast  # noqa: E402

from pilosa_tpu.analysis import engine as ref_engine  # noqa: E402
from pilosa_tpu.analysis import registry as ref_registry  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DRIFT = "counters registry is stale (formatting drift)"


def _read_as_ref(msg: str) -> str:
    return msg.replace("pilosa_tpu_torch.analysis", "pilosa_tpu.analysis")


def _key(f):
    return (f.rule, f.path, f.line, f.scope, _read_as_ref(f.message),
            f.suppressed, f.baselined)


def _header_drift(findings):
    """Split off the header-only registry finding."""
    rest = [f for f in findings if _DRIFT not in f.message]
    return rest, len(findings) - len(rest)


def _assert_parity(root, rules=engine.RULES, registry_of=None):
    """Run both engines over ``root``.  ``registry_of`` names the package
    whose CLI wrote the tree's COUNTERS.md (None: no registry), so the
    other package's engine must report the header drift, and only it."""
    ref = ref_engine.run_analysis(root=root, rules=rules)
    port = engine.run_analysis(root=root, rules=rules)
    ref_rest, ref_drift = _header_drift(ref)
    port_rest, port_drift = _header_drift(port)
    stats_on = "stats-registry" in rules
    assert ref_drift == int(stats_on and registry_of == "pilosa_tpu_torch")
    assert port_drift == int(stats_on and registry_of == "pilosa_tpu")
    assert [_key(f) for f in ref_rest] == [_key(f) for f in port_rest]
    for a, b in zip(ref_rest, port_rest):
        if "pilosa_tpu" not in a.message:
            assert a.fingerprint == b.fingerprint, a.render()
    return ref_rest


def test_registry_headers_differ_only_in_the_module_name():
    """The one code difference behind the header drift above."""
    sites = registry.collect_stat_sites(
        engine.load_tree(engine.package_root()))[0]
    port_text = registry.render_registry(sites)
    ref_text = ref_registry.render_registry(sites)
    assert port_text != ref_text
    assert _read_as_ref(port_text) == ref_text


@pytest.mark.parametrize("pkg", ["pilosa_tpu", "pilosa_tpu_torch"])
def test_engines_agree_on_the_live_trees(pkg):
    """Both engines over the reference tree and over the port's tree:
    every rule runs (native-abi against the shared native/ source)."""
    found = _assert_parity(os.path.join(_REPO, pkg), registry_of=pkg)
    assert len(found) > 50  # the suppressed sites were really seen
    assert {f.rule for f in found} >= {
        "exception-hygiene", "check-then-act", "lockstep-determinism",
    }
    assert all(f.suppressed for f in found)


def _fixture_packages():
    """Every golden fixture package of this module: the dict literals
    whose keys are all .py paths, read from the source by AST."""
    with open(__file__, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Dict) and node.keys):
            continue
        if not all(isinstance(k, ast.Constant) and isinstance(k.value, str)
                   and k.value.endswith(".py") for k in node.keys):
            continue
        try:
            out[f"L{node.lineno}"] = ast.literal_eval(node)
        except ValueError:
            continue  # built from names (the ABI harness): covered below
    return dict(sorted(out.items(), key=lambda kv: int(kv[0][1:])))


_FIXTURES = _fixture_packages()


def test_fixture_packages_were_found():
    assert len(_FIXTURES) >= 20


@pytest.mark.parametrize("with_registry", [False, True],
                         ids=["no-registry", "registry"])
@pytest.mark.parametrize("name", list(_FIXTURES))
def test_engines_agree_on_fixture_package(tmp_path, name, with_registry):
    root = _mkpkg(tmp_path, _FIXTURES[name], registry_for=with_registry or None)
    _assert_parity(root,
                   registry_of="pilosa_tpu_torch" if with_registry else None)


@pytest.mark.parametrize("variant", ["ok", "arity", "width-missing"])
def test_engines_agree_on_abi_fixtures(tmp_path, variant):
    py, cpp = _ABI_PY_OK, _ABI_CPP_OK
    if variant == "arity":
        cpp = cpp.replace("int32_t wal_fd,", "int32_t wal_fd, int32_t flags,")
    elif variant == "width-missing":
        py = py.replace("ctypes.c_int32,", "ctypes.c_int64,").replace(
            "    return lib",
            "    lib.pn_vanished.restype = None\n"
            "    lib.pn_vanished.argtypes = []\n"
            "    return lib",
        )
    root = _mk_abi_tree(tmp_path, py_src=py, cpp_src=cpp)
    found = _assert_parity(root, rules=("native-abi",))
    assert (found == []) == (variant == "ok")


# -- the port's own gate ------------------------------------------------------


def test_port_baseline_is_empty():
    import json

    with open(engine.baseline_path(engine.package_root()), encoding="utf-8") as f:
        assert json.load(f)["entries"] == {}


def test_port_cli_gate_passes_without_any_baseline(tmp_path, capsys):
    assert analysis_main(["--baseline", str(tmp_path / "absent.json")]) == 0
    assert "0 baselined, 0 NEW" in capsys.readouterr().out


def _port_abi_copy(tmp_path, mutate=None):
    """A package holding a copy of the port's native.py, next to the
    repository's native/ source and library."""
    root = tmp_path / "pkg"
    root.mkdir()
    (root / "analysis").mkdir()
    src = open(os.path.join(engine.package_root(), "native.py"),
               encoding="utf-8").read()
    if mutate:
        src = mutate(src)
    (root / "native.py").write_text(src)
    os.symlink(os.path.join(_REPO, "native"), tmp_path / "native")
    return str(root)


def test_port_native_abi_copy_is_conformant(tmp_path):
    from pilosa_tpu_torch.analysis import abi

    root = _port_abi_copy(tmp_path)
    assert _assert_parity(root, rules=("native-abi",)) == []
    # The bridge was really parsed: a rule that read nothing passes too.
    assert len(abi.parse_ctypes_decls(os.path.join(root, "native.py"))) >= 20


def test_port_native_abi_reports_a_planted_arity_change(tmp_path):
    decl = "lib.pn_popcount_and_u32.argtypes = [u32p, u32p, ctypes.c_size_t]"

    def drop_arg(src):
        assert src.count(decl) == 1
        return src.replace(decl, decl.replace("u32p, u32p,", "u32p,"))

    root = _port_abi_copy(tmp_path, mutate=drop_arg)
    found = _assert_parity(root, rules=("native-abi",))
    assert [(f.rule, f.path, f.scope) for f in found] == [
        ("native-abi", "native.py", "pn_popcount_and_u32")]
    assert "arity mismatch" in found[0].message
    assert not found[0].suppressed

