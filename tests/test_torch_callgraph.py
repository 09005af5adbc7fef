"""The port's twin of tests/test_callgraph.py.

Pinning tests for analysis/callgraph.py's documented over-approximation.

The name-based call graph is the soundness foundation of the
lockstep-determinism and guarded-fields rules; its behavior on the
awkward shapes — decorated functions, aliased imports, method calls
through ``self.``-attributes, stoplisted bare names, same-file-first
resolution — was documented but never pinned.  These tests freeze the
contract so a refactor that silently changes reachability (and with it
which findings fire) breaks HERE, with a readable diff, instead of as a
mystery lint regression.
"""

import textwrap

from pilosa_tpu_torch.analysis import engine
from pilosa_tpu_torch.analysis.callgraph import STOPLIST, CallGraph


def _graph(tmp_path, files: dict) -> CallGraph:
    root = tmp_path / "pkg"
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return CallGraph(engine.load_tree(str(root)))


def _reachable_scopes(graph, seed_rel, seed_scope):
    keys = graph.reachable_from([(seed_rel, seed_scope)])
    return {scope for _rel, scope in keys}


def test_decorated_functions_are_nodes_and_reachable(tmp_path):
    """Decorators neither hide the decorated def nor break edges INTO
    it: the node is keyed by the def name, and a call to that bare name
    reaches it.  The decorator expression itself contributes a call
    edge from the enclosing scope only when it is written as a call."""
    g = _graph(tmp_path, {"mod.py": """
    import functools

    def wraps_nothing(fn):
        return fn

    @wraps_nothing
    def helper():
        return 1

    @functools.lru_cache(maxsize=8)
    def cached_helper():
        return 2

    def entry():
        helper()
        cached_helper()
    """})
    scopes = _reachable_scopes(g, "mod.py", "entry")
    assert "helper" in scopes
    assert "cached_helper" in scopes


def test_aliased_imports_resolve_by_bare_attribute_name(tmp_path):
    """``import x as y; y.foo(...)`` produces a bare-name edge on
    ``foo`` — module aliasing is invisible to the name-based graph, so
    the call reaches EVERY in-package def named ``foo`` (same-file
    first when one exists).  This is the documented over-approximation:
    more edges, never fewer findings."""
    g = _graph(tmp_path, {
        "a.py": """
        from pkg import other as o

        def entry():
            o.foo()
        """,
        "other.py": """
        def foo():
            return 1
        """,
        "third.py": """
        def foo():
            return 2
        """,
    })
    scopes = _reachable_scopes(g, "a.py", "entry")
    # no same-file foo exists, so BOTH candidates are reachable
    keys = g.reachable_from([("a.py", "entry")])
    foo_files = {rel for rel, scope in keys if scope == "foo"}
    assert foo_files == {"other.py", "third.py"}
    assert "foo" in scopes


def test_self_attribute_method_calls_resolve_same_file_first(tmp_path):
    """``self.helper()`` is an Attribute call: the bare name ``helper``
    resolves to the SAME-FILE definition when one exists, shadowing the
    package-wide candidates — a same-file def almost always IS the
    callee."""
    g = _graph(tmp_path, {
        "svc.py": """
        class Service:
            def entry(self):
                self.helper()

            def helper(self):
                return far_away()
        """,
        "lib.py": """
        def helper():
            return 1

        def far_away():
            return 2
        """,
    })
    keys = g.reachable_from([("svc.py", "Service.entry")])
    assert ("svc.py", "Service.helper") in keys
    # same-file resolution shadowed the other-file namesake entirely
    assert ("lib.py", "helper") not in keys
    # ...but the method's own calls keep resolving package-wide
    assert ("lib.py", "far_away") in keys


def test_stoplisted_bare_names_produce_no_edges(tmp_path):
    """``thread.start()`` must not drag every ``def start`` into the
    reachable set — the stoplist eats the edge (the documented
    fewer-findings hole)."""
    assert "start" in STOPLIST and "get" in STOPLIST
    g = _graph(tmp_path, {"mod.py": """
    class Server:
        def start(self):
            return secret_sauce()

    def secret_sauce():
        return 1

    def entry(thread):
        thread.start()
    """})
    keys = g.reachable_from([("mod.py", "entry")])
    assert ("mod.py", "Server.start") not in keys
    assert ("mod.py", "secret_sauce") not in keys


def test_nested_defs_are_independent_nodes(tmp_path):
    """A nested def is its own node (scanned separately by the rules);
    calling its bare name from elsewhere reaches it."""
    g = _graph(tmp_path, {"mod.py": """
    def outer():
        def inner():
            return leaf()
        return inner

    def leaf():
        return 1

    def entry():
        outer()
    """})
    keys = g.reachable_from([("mod.py", "entry")])
    assert ("mod.py", "outer") in keys
    # outer() CALLS nothing by inner's bare name (it only defines it):
    # no call edge, so inner and leaf stay unreachable from entry.
    assert ("mod.py", "outer.inner") in g.funcs
    assert ("mod.py", "outer.inner") not in keys
    assert ("mod.py", "leaf") not in keys


def test_lambda_bodies_belong_to_enclosing_function(tmp_path):
    """Calls inside a lambda attribute to the enclosing def (lambdas
    are not nodes), so reachability flows through them."""
    g = _graph(tmp_path, {"mod.py": """
    def entry():
        f = lambda: leaf()
        return f()

    def leaf():
        return 1
    """})
    keys = g.reachable_from([("mod.py", "entry")])
    assert ("mod.py", "leaf") in keys
