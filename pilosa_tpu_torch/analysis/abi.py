"""Native-boundary ABI conformance: C++ ``extern "C"`` declarations vs
the ctypes ``argtypes``/``restype`` table in ``pilosa_tpu_torch/native.py`` vs
the built ``.so``'s exported symbols.

The native bridge is ~30 hand-declared signatures — including the
22-argument ``pn_write_batch`` — where a silent drift between the C
definition and the Python declaration is not an exception but memory
corruption (ctypes marshals whatever widths it was told).  This module
reduces every signature to a WIDTH-CLASS tuple and compares:

- ``ptr``  — any pointer (``const char*``, ``uint64_t*``, ``c_void_p``,
  ``c_char_p``, ``ctypes.POINTER(...)``, a ``byref`` slot);
- ``i64``  — 64-bit integers (``int64_t``/``uint64_t``/``size_t`` and
  ``c_int64``/``c_uint64``/``c_size_t``/``c_longlong``...);
- ``i32`` / ``i16`` / ``i8`` — the narrower integer widths;
- ``void`` — no return value (``restype = None``).

Signedness is deliberately NOT part of the class: the kernel ABI passes
both widths in the same registers and every current mismatch of
consequence is a width or arity drift.  The comparison runs in three
directions: every Python-declared function must exist in the C source
(missing symbol), with the same arity and per-slot width classes, and
— when the built ``.so`` is present — must resolve among its exported
dynamic symbols (``nm -D``, falling back to a ``ctypes`` load).

Parsing the C++ is a line-oriented scan, not a compiler: only
``extern "C"`` blocks are considered, comments are stripped, and a
definition is ``<ret> pn_<name>(<params>) {``.  That is exactly the
shape the in-tree kernels use; anything fancier (macros, typedef'd
params) would need this module taught about it — which is the point:
the gate fails closed on a signature it cannot classify.
"""

from __future__ import annotations

import os
import re
import ast
import subprocess

# ctypes expression (last attribute segment) -> width class.
_CTYPES_WIDTH = {
    "c_char_p": "ptr",
    "c_wchar_p": "ptr",
    "c_void_p": "ptr",
    "c_int64": "i64",
    "c_uint64": "i64",
    "c_longlong": "i64",
    "c_ulonglong": "i64",
    "c_size_t": "i64",
    "c_ssize_t": "i64",
    "c_int32": "i32",
    "c_uint32": "i32",
    "c_int": "i32",
    "c_uint": "i32",
    "c_int16": "i16",
    "c_uint16": "i16",
    "c_short": "i16",
    "c_ushort": "i16",
    "c_int8": "i8",
    "c_uint8": "i8",
    "c_byte": "i8",
    "c_ubyte": "i8",
    "c_char": "i8",
    "c_bool": "i8",
    "c_double": "f64",
    "c_float": "f32",
}

# C base-type token sequences -> width class (pointer handled first).
_C_WIDTH = {
    "int64_t": "i64",
    "uint64_t": "i64",
    "size_t": "i64",
    "ssize_t": "i64",
    "int32_t": "i32",
    "uint32_t": "i32",
    "int": "i32",
    "unsigned": "i32",
    "int16_t": "i16",
    "uint16_t": "i16",
    "short": "i16",
    "int8_t": "i8",
    "uint8_t": "i8",
    "char": "i8",
    "bool": "i8",
    "double": "f64",
    "float": "f32",
    "void": "void",
}

_LONG_TOKENS = {"long"}  # LP64: long / long long are both 64-bit here

_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.DOTALL)
_EXTERN_RE = re.compile(r'extern\s+"C"\s*\{')
_DEF_RE = re.compile(
    r"(?P<ret>[A-Za-z_][\w]*(?:\s+[A-Za-z_][\w]*)*\s*\**)\s*"
    r"\b(?P<name>pn_\w+)\s*\((?P<params>[^)]*)\)\s*\{",
    re.DOTALL,
)


# A kernel entry point: ``extern "C" <ret> pk_<name>(<params>) {`` (one
# definition, not a block), in pilosa_tpu_torch/csrc/*.cu.
_PK_DEF_RE = re.compile(
    r'extern\s+"C"\s+(?P<ret>[A-Za-z_][\w]*(?:\s+[A-Za-z_][\w]*)*\s*\**)\s*'
    r"\b(?P<name>pk_\w+)\s*\((?P<params>[^)]*)\)\s*\{",
    re.DOTALL,
)


class AbiIssue:
    """One conformance failure, anchored at a native.py line."""

    __slots__ = ("name", "line", "message")

    def __init__(self, name: str, line: int, message: str):
        self.name = name
        self.line = line
        self.message = message


def _c_slot_width(decl: str) -> str | None:
    """Width class of one C parameter (or return) declaration."""
    decl = decl.strip()
    if not decl or decl == "void":
        return "void" if decl == "void" else None
    if "*" in decl or "[" in decl:
        return "ptr"
    tokens = [t for t in re.split(r"\s+", decl) if t]
    # Drop qualifiers and the (optional) parameter name: the name is the
    # last token iff more than one type-ish token precedes it.
    tokens = [t for t in tokens if t not in ("const", "volatile", "struct")]
    if not tokens:
        return None
    if len(tokens) > 1 and tokens[-1] not in _C_WIDTH and tokens[-1] not in _LONG_TOKENS:
        tokens = tokens[:-1]  # trailing parameter name
    if any(t in _LONG_TOKENS for t in tokens):
        return "i64"
    for t in tokens:
        if t in _C_WIDTH:
            return _C_WIDTH[t]
    return None


def _extern_c_spans(text: str) -> list[tuple[int, int]]:
    """Character spans of every ``extern "C" { ... }`` block (brace
    matched)."""
    spans = []
    for m in _EXTERN_RE.finditer(text):
        depth = 1
        i = m.end()
        while i < len(text) and depth:
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
            i += 1
        spans.append((m.end(), i))
    return spans


def parse_native_source(path: str) -> dict[str, tuple[str, list[str]]]:
    """``{name: (ret_width, [param_widths])}`` for every ``pn_*``
    function DEFINED inside an ``extern "C"`` block of the C++ source.
    Unclassifiable slots become ``"?"`` (compared unequal to anything,
    so the gate fails closed)."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    text = _COMMENT_RE.sub(" ", text)
    out: dict[str, tuple[str, list[str]]] = {}
    for start, end in _extern_c_spans(text):
        for m in _DEF_RE.finditer(text, start, end):
            name = m.group("name")
            ret = _c_slot_width(m.group("ret")) or "?"
            params_src = m.group("params").strip()
            params: list[str] = []
            if params_src and params_src != "void":
                for p in params_src.split(","):
                    params.append(_c_slot_width(p) or "?")
            out[name] = (ret, params)
    return out


def _ctypes_width(node: ast.expr, aliases: dict[str, str]) -> str:
    """Width class of one ctypes argtypes element / restype expression."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "void"
    if isinstance(node, ast.Call):
        # ctypes.POINTER(...) and friends
        fn = node.func
        last = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else ""
        )
        if last in ("POINTER", "CFUNCTYPE", "byref", "pointer"):
            return "ptr"
        return "?"
    if isinstance(node, ast.Attribute):
        return _CTYPES_WIDTH.get(node.attr, "?")
    if isinstance(node, ast.Name):
        if node.id in aliases:
            return aliases[node.id]
        return _CTYPES_WIDTH.get(node.id, "?")
    return "?"


def parse_ctypes_decls(path: str) -> dict[str, tuple[str, list[str], int]]:
    """``{name: (ret_width, [param_widths], line)}`` from the
    ``lib.pn_X.argtypes = [...]`` / ``.restype = ...`` assignments in
    native.py.  Local pointer aliases (``u8p = ctypes.POINTER(...)``)
    are resolved; the line anchors findings."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    aliases: dict[str, str] = {}
    args: dict[str, tuple[list[str], int]] = {}
    rets: dict[str, tuple[str, int]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        # alias: <name> = ctypes.POINTER(...)
        if isinstance(tgt, ast.Name):
            w = _ctypes_width(node.value, aliases)
            if w != "?":
                aliases[tgt.id] = w
            continue
        # lib.pn_X.argtypes / lib.pn_X.restype
        if not (
            isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Attribute)
            and tgt.value.attr.startswith("pn_")
        ):
            continue
        fn_name = tgt.value.attr
        if tgt.attr == "argtypes":
            if isinstance(node.value, (ast.List, ast.Tuple)):
                widths = [_ctypes_width(e, aliases) for e in node.value.elts]
            else:
                widths = ["?"]
            args[fn_name] = (widths, node.lineno)
        elif tgt.attr == "restype":
            rets[fn_name] = (_ctypes_width(node.value, aliases), node.lineno)
    out: dict[str, tuple[str, list[str], int]] = {}
    for name in sorted(set(args) | set(rets)):
        widths, aline = args.get(name, ([], 0))
        ret, rline = rets.get(name, ("void", 0))
        out[name] = (ret, widths, aline or rline or 1)
    return out


def so_symbols(path: str) -> set[str] | None:
    """Exported dynamic symbols of the built library, or None when the
    file is missing / unreadable (the export leg is then skipped —
    source-vs-declaration checking still runs)."""
    if not os.path.exists(path):
        return None
    try:
        res = subprocess.run(
            ["nm", "-D", "--defined-only", path],
            capture_output=True, text=True, timeout=30,
        )
        if res.returncode == 0 and res.stdout:
            syms = set()
            for ln in res.stdout.splitlines():
                parts = ln.split()
                if parts:
                    syms.add(parts[-1])
            return syms
    except (OSError, subprocess.SubprocessError):
        pass
    try:  # no nm: resolve each name through a live load instead
        import ctypes

        lib = ctypes.CDLL(path)
    except OSError:
        return None

    class _Probe(set):
        def __contains__(self, name) -> bool:  # pragma: no cover - fallback
            return hasattr(lib, name)

    return _Probe()


def check_abi(cpp_path: str, native_py_path: str,
              so_path: str | None = None) -> list[AbiIssue]:
    """Compare the three views of the native boundary; returns issues
    anchored at native.py lines (empty = conformant)."""
    issues: list[AbiIssue] = []
    c_defs = parse_native_source(cpp_path)
    decls = parse_ctypes_decls(native_py_path)
    exported = so_symbols(so_path) if so_path else None
    for name, (ret, widths, line) in sorted(decls.items()):
        c = c_defs.get(name)
        if c is None:
            issues.append(AbiIssue(
                name, line,
                f"`{name}` declared in native.py but not defined in any "
                f'extern "C" block of {os.path.basename(cpp_path)} — '
                "missing symbol (calling it jumps nowhere)",
            ))
            continue
        c_ret, c_params = c
        if len(widths) != len(c_params):
            issues.append(AbiIssue(
                name, line,
                f"`{name}` arity mismatch: native.py declares "
                f"{len(widths)} argtypes, the C definition takes "
                f"{len(c_params)} parameters — every later argument "
                "marshals into the wrong slot",
            ))
        else:
            for i, (pw, cw) in enumerate(zip(widths, c_params)):
                if pw != cw:
                    issues.append(AbiIssue(
                        name, line,
                        f"`{name}` argument {i} width mismatch: native.py "
                        f"declares {pw}, the C definition takes {cw}",
                    ))
        if ret != c_ret:
            issues.append(AbiIssue(
                name, line,
                f"`{name}` return width mismatch: native.py declares "
                f"{ret}, the C definition returns {c_ret}",
            ))
        if exported is not None and name not in exported:
            issues.append(AbiIssue(
                name, line,
                f"`{name}` is not among the .so's exported dynamic "
                "symbols — stale build or dropped export",
            ))
    return issues


# -- the kernels' boundary: ops/kernels.py's _ARGTYPES vs csrc/*.cu -----------
#
# Every CUDA kernel is a plain C entry point (``pk_*``) bound by ctypes
# from one table, ``_ARGTYPES`` in ops/kernels.py: {kernel: ("pk_<name>",
# [argtypes])}, each restype ``c_int`` (the entry returns its
# cudaError_t).  The same drift as the native bridge's is a launch with
# a pointer cut to 32 bits or an argument in the wrong slot.

KERNEL_RESTYPE = "i32"


def _list_widths(node: ast.expr, aliases: dict[str, str]) -> list[str] | None:
    """Widths of an argtypes list expression: a list literal, ``+`` of
    two, or one times an integer constant; None where it is anything
    else (the gate fails closed)."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return [_ctypes_width(e, aliases) for e in node.elts]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _list_widths(node.left, aliases), _list_widths(node.right, aliases)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for lst, n in ((node.left, node.right), (node.right, node.left)):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                w = _list_widths(lst, aliases)
                return None if w is None else w * n.value
    return None


def parse_kernel_argtypes(path: str) -> dict[str, tuple[str, list[str], int]]:
    """``{symbol: (kernel, [param_widths], line)}`` from the module-level
    ``_ARGTYPES`` dict of ops/kernels.py; module-level aliases (``_P =
    ctypes.c_void_p``) are resolved.  An entry whose list cannot be
    classified gets a single ``"?"`` width."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    aliases: dict[str, str] = {}
    out: dict[str, tuple[str, list[str], int]] = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        if tgt.id != "_ARGTYPES":
            w = _ctypes_width(node.value, aliases)
            if w != "?":
                aliases[tgt.id] = w
            continue
        if not isinstance(node.value, ast.Dict):
            continue
        for key, val in zip(node.value.keys, node.value.values):
            if not (isinstance(key, ast.Constant) and isinstance(val, ast.Tuple)
                    and len(val.elts) == 2 and isinstance(val.elts[0], ast.Constant)):
                continue
            widths = _list_widths(val.elts[1], aliases)
            out[str(val.elts[0].value)] = (str(key.value), widths or ["?"], val.lineno)
    return out


def parse_kernel_sources(csrc_dir: str) -> dict[str, tuple[str, list[str]]]:
    """``{symbol: (ret_width, [param_widths])}`` for every ``extern "C"
    ... pk_*(...) {`` definition in the ``.cu`` files of ``csrc_dir``."""
    out: dict[str, tuple[str, list[str]]] = {}
    for fn in sorted(os.listdir(csrc_dir)):
        if not fn.endswith(".cu"):
            continue
        with open(os.path.join(csrc_dir, fn), encoding="utf-8") as f:
            text = _COMMENT_RE.sub(" ", f.read())
        for m in _PK_DEF_RE.finditer(text):
            params_src = m.group("params").strip()
            params = ([] if not params_src or params_src == "void"
                      else [_c_slot_width(p) or "?" for p in params_src.split(",")])
            out[m.group("name")] = (_c_slot_width(m.group("ret")) or "?", params)
    return out


def check_kernel_abi(csrc_dir: str, kernels_py_path: str) -> list[AbiIssue]:
    """The kernels' ctypes table against their CUDA entry points: every
    declared ``pk_*`` defined, with the same arity and widths, returning
    int.  Issues anchor at the entry's line of ops/kernels.py."""
    issues: list[AbiIssue] = []
    decls = parse_kernel_argtypes(kernels_py_path)
    defs = parse_kernel_sources(csrc_dir)
    for sym, (kernel, widths, line) in sorted(decls.items()):
        d = defs.get(sym)
        if d is None:
            issues.append(AbiIssue(
                sym, line,
                f"`{sym}` (kernel {kernel}) declared in _ARGTYPES but defined in no "
                'extern "C" entry of csrc/*.cu — missing symbol'))
            continue
        ret, params = d
        if len(widths) != len(params):
            issues.append(AbiIssue(
                sym, line,
                f"`{sym}` arity mismatch: _ARGTYPES declares {len(widths)} argtypes, "
                f"the CUDA entry takes {len(params)} parameters"))
        else:
            for i, (pw, cw) in enumerate(zip(widths, params)):
                if pw != cw:
                    issues.append(AbiIssue(
                        sym, line,
                        f"`{sym}` argument {i} width mismatch: _ARGTYPES declares {pw}, "
                        f"the CUDA entry takes {cw}"))
        if ret != KERNEL_RESTYPE:
            issues.append(AbiIssue(
                sym, line,
                f"`{sym}` returns {ret}; the wrappers read a cudaError_t as c_int"))
    return issues
