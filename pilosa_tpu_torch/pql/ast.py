"""PQL AST: Query and Call nodes plus typed arg helpers.

Reference analog: pql/ast.go — Query{Calls}, Call{Name, Args, Children}
(ast.go:26-57), UintArg/UintSliceArg accessors (ast.go:59-99),
WriteCallN mutation counting (ast.go:31-41), SupportsInverse/IsInverse
(ast.go:185-207), and deterministic String() rendering (ast.go:150-183).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# Timestamp layout for SetBit/Range args (pql/parser.go:25).
TIME_FORMAT = "%Y-%m-%dT%H:%M"

WRITE_CALL_NAMES = frozenset({"SetBit", "ClearBit", "SetRowAttrs", "SetColumnAttrs"})


@dataclass
class Call:
    name: str
    args: dict[str, Any] = field(default_factory=dict)
    children: list["Call"] = field(default_factory=list)

    # -- typed arg access (ast.go:59-99) --------------------------------

    def uint_arg(self, key: str) -> tuple[int, bool]:
        """(value, found); raises TypeError on a non-integer value."""
        if key not in self.args:
            return 0, False
        v = self.args[key]
        if isinstance(v, bool) or not isinstance(v, int):
            raise TypeError(f"could not convert {v!r} to uint64 in Call.uint_arg")
        return v, True

    def uint_slice_arg(self, key: str) -> tuple[list[int], bool]:
        if key not in self.args:
            return [], False
        v = self.args[key]
        if not isinstance(v, list) or any(isinstance(x, bool) or not isinstance(x, int) for x in v):
            raise TypeError(f"unexpected value in Call.uint_slice_arg: {v!r}")
        return list(v), True

    def string_arg(self, key: str, default: str = "") -> str:
        v = self.args.get(key, default)
        return v if isinstance(v, str) else default

    # -- inverse-view support (ast.go:185-207) --------------------------

    def supports_inverse(self) -> bool:
        return self.name == "Bitmap"

    def is_inverse(self, row_label: str, column_label: str) -> bool:
        """True when only the column arg is present on an invertible call."""
        if not self.supports_inverse():
            return False
        try:
            _, row_ok = self.uint_arg(row_label)
            _, col_ok = self.uint_arg(column_label)
        except TypeError:
            return False
        return (not row_ok) and col_ok

    # -- misc ------------------------------------------------------------

    def clone(self) -> "Call":
        return Call(
            name=self.name,
            args=dict(self.args),
            children=[c.clone() for c in self.children],
        )

    def __str__(self) -> str:
        parts = [str(c) for c in self.children]
        for key in sorted(self.args):
            v = self.args[key]
            if isinstance(v, str):
                parts.append(f'{key}="{v}"')
            elif isinstance(v, bool):
                parts.append(f"{key}={'true' if v else 'false'}")
            elif v is None:
                parts.append(f"{key}=null")
            elif isinstance(v, list):
                inner = ",".join(f'"{x}"' if isinstance(x, str) else str(x).lower() if isinstance(x, bool) else str(x) for x in v)
                parts.append(f"{key}=[{inner}]")
            else:
                parts.append(f"{key}={v}")
        return f"{self.name}({', '.join(parts)})"


@dataclass
class Query:
    calls: list[Call] = field(default_factory=list)

    def write_call_n(self) -> int:
        """Number of mutating calls (ast.go:31-41)."""
        return sum(1 for c in self.calls if c.name in WRITE_CALL_NAMES)

    def __str__(self) -> str:
        return "\n".join(str(c) for c in self.calls)
