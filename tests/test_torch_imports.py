"""The port stands alone: no module of ``pilosa_tpu_torch``, and not
``chip_smoke.py``, imports ``jax`` or anything of ``pilosa_tpu``.

Checked twice: statically (every import statement in the sources, by AST
scan) and dynamically (a fresh interpreter imports every module of the
port and ``chip_smoke``; none of the modules that import adds to
``sys.modules`` may be ``jax`` or ``pilosa_tpu``; ``pilosa_tpu_torch.parallel``
is also imported alone).  Also: the default and the mesh engines raise
without CUDA, and ``chip_smoke.py`` exits non-zero without
a card, printing no result line.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "pilosa_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _sources():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return mods


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pilosa_tpu")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_or_reference_module():
    code = textwrap.dedent(
        f"""
        import importlib, json, sys
        before = set(sys.modules)
        for m in {_modules()!r}:
            importlib.import_module(m)
        new = sorted(set(sys.modules) - before)
        print(json.dumps(new))
        """
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    new = json.loads(out.stdout.strip().splitlines()[-1])
    assert "pilosa_tpu_torch.executor" in new and "chip_smoke" in new
    for m in ("server", "server.server", "server.handler", "cli", "cli.main", "planner",
              "costs", "trace", "ingest", "config", "qos", "tenancy", "wire", "replica.catchup",
              "ops.diffcheck", "parallel", "parallel.sharded", "parallel.multihost",
              "parallel.service", "replica.mesh", "replica.digest"):
        assert f"pilosa_tpu_torch.{m}" in new, m
    assert not [m for m in new if _forbidden(m)]


def test_importing_parallel_loads_no_jax():
    """``import pilosa_tpu_torch.parallel`` alone (the meshes, the
    compositions, init_multihost) loads no JAX and no reference module,
    and leaves the lockstep service (the whole server stack) unloaded
    until ``LockstepService`` is asked for."""
    code = textwrap.dedent(
        """
        import json, sys
        import pilosa_tpu_torch.parallel as par
        first = sorted(sys.modules)
        par.LockstepService
        print(json.dumps([first, sorted(sys.modules)]))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    first, after = json.loads(out.stdout.strip().splitlines()[-1])
    assert "pilosa_tpu_torch.parallel.sharded" in first
    assert "pilosa_tpu_torch.parallel.service" not in first
    assert "pilosa_tpu_torch.parallel.service" in after
    assert not [m for m in after if _forbidden(m)]


def test_auto_engine_raises_without_cuda():
    import torch

    from pilosa_tpu_torch.engine import new_engine

    if torch.cuda.is_available():
        assert new_engine("auto").device.type == "cuda"
    else:
        for name in ("auto", "torch", "mesh"):
            with pytest.raises(RuntimeError, match="is_available"):
                new_engine(name)


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
