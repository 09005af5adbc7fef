"""What a configuration and its traffic are made of: frames, call trees,
and the files that bring a data kind or a query shape by name.

- Frames: ``cfg["frames"]``, a list of ``{"name", "row_label", "rows"}``;
  a configuration without it has one frame, its ``frame``, ``row_label``
  and ``rows``.
- A call is a tree under an implicit ``Count``: a node is ``(op, child,
  ...)`` with ``op`` one of ``OPS`` and one child or more, a leaf is
  ``("Bitmap", frame, row)``.  Its answer is the Count.
- ``plugin(root, sub, name)`` loads ``<root>/benchport/<sub>/<name>.py``.

Standard library only: the client processes import this.
"""

from __future__ import annotations

import importlib.util
import os

OPS = ("Union", "Intersect", "Difference", "Xor")
DEFAULT_ROW_LABEL = "rowID"


def frames(cfg: dict) -> list[dict]:
    """The configuration's frames, in order: name, row label ("" for
    Pilosa's default) and row count."""
    if "frames" not in cfg:
        return [{"name": cfg["frame"], "row_label": cfg.get("row_label", ""),
                 "rows": int(cfg["rows"])}]
    return [{"name": f["name"], "row_label": f.get("row_label", ""), "rows": int(f["rows"])}
            for f in cfg["frames"]]


def leaves(call) -> list[tuple[str, int]]:
    """The (frame, row) of every Bitmap leaf of a call, left to right."""
    if call[0] == "Bitmap":
        return [(call[1], int(call[2]))]
    if call[0] not in OPS or len(call) < 2:
        raise ValueError(f"not a call tree: {call!r}")
    return [leaf for child in call[1:] for leaf in leaves(child)]


def pql(call, labels: dict) -> str:
    """A call tree in PQL, without its ``Count``; ``labels``: each
    frame's row label."""
    if call[0] == "Bitmap":
        return f"Bitmap({labels[call[1]]}={call[2]}, frame={call[1]})"
    return f"{call[0]}(" + ", ".join(pql(c, labels) for c in call[1:]) + ")"


def plugin(root: str, sub: str, name: str):
    """``<root>/benchport/<sub>/<name>.py`` as a module (not put in
    ``sys.modules``); ``FileNotFoundError`` where there is none."""
    path = os.path.join(root, "benchport", sub, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {sub} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchport_{sub}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
