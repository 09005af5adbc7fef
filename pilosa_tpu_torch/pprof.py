"""pprof-format profile encoder (google/pprof profile.proto, proto3).

The reference mounts net/http/pprof (handler.go:99), whose default
output is a gzipped protobuf Profile consumable by ``go tool pprof`` /
``pprof -http``.  This module hand-rolls that encoding with the same
varint/length-delimited writer the HTTP data plane uses (pilosa_tpu_torch.wire
— no protobuf library dependency), so this build's ``/debug/pprof/``
endpoints serve REAL pprof payloads, not just text dumps.

profile.proto field numbers (public pprof schema):
  Profile:   1 sample_type  2 sample  4 location  5 function
             6 string_table  9 time_nanos  10 duration_nanos
             12 period_type  13 period
  ValueType: 1 type(str idx)  2 unit(str idx)
  Sample:    1 location_id (packed)  2 value (packed)
  Location:  1 id  4 line
  Line:      1 function_id  2 line
  Function:  1 id  2 name  3 system_name  4 filename  5 start_line
"""

from __future__ import annotations

import gzip
import sys
import threading
import time
import traceback
from collections import Counter

from pilosa_tpu_torch.wire import Writer


class _Strings:
    """String table: index 0 is always ""."""

    def __init__(self):
        self.table: list[str] = [""]
        self.index: dict[str, int] = {"": 0}

    def __call__(self, s: str) -> int:
        i = self.index.get(s)
        if i is None:
            i = self.index[s] = len(self.table)
            self.table.append(s)
        return i


def _value_type(st: _Strings, typ: str, unit: str) -> bytes:
    return Writer().varint(1, st(typ)).varint(2, st(unit)).finish()


def build_profile(
    samples: list[tuple[list[tuple[str, str, int]], list[int]]],
    sample_types: list[tuple[str, str]],
    period_type: tuple[str, str] | None = None,
    period: int = 0,
    duration_nanos: int = 0,
) -> bytes:
    """Gzipped pprof Profile.

    ``samples``: (stack, values) pairs; stack = [(function_name,
    filename, line), ...] ordered leaf-first (pprof convention);
    ``values`` aligned with ``sample_types`` [(type, unit), ...].
    """
    st = _Strings()
    w = Writer()
    for typ, unit in sample_types:
        w.message(1, _value_type(st, typ, unit))

    # Dedupe locations/functions across samples.
    fn_ids: dict[tuple[str, str], int] = {}
    loc_ids: dict[tuple[str, str, int], int] = {}
    fn_msgs: list[bytes] = []
    loc_msgs: list[bytes] = []

    def loc_id(frame: tuple[str, str, int]) -> int:
        lid = loc_ids.get(frame)
        if lid is not None:
            return lid
        name, filename, line = frame
        fkey = (name, filename)
        fid = fn_ids.get(fkey)
        if fid is None:
            fid = fn_ids[fkey] = len(fn_msgs) + 1
            fn_msgs.append(
                Writer()
                .varint(1, fid)
                .varint(2, st(name))
                .varint(3, st(name))
                .varint(4, st(filename))
                .finish()
            )
        lid = loc_ids[frame] = len(loc_msgs) + 1
        line_msg = Writer().varint(1, fid).varint(2, line).finish()
        loc_msgs.append(Writer().varint(1, lid).message(4, line_msg).finish())
        return lid

    sample_msgs = []
    for stack, values in samples:
        ids = [loc_id(f) for f in stack]
        sample_msgs.append(Writer().packed(1, ids).packed(2, values).finish())

    for m in sample_msgs:
        w.message(2, m)
    for m in loc_msgs:
        w.message(4, m)
    for m in fn_msgs:
        w.message(5, m)
    for s in st.table:
        w.bytes_field(6, s.encode("utf-8"), force=True)
    w.varint(9, time.time_ns())
    if duration_nanos:
        w.varint(10, duration_nanos)
    if period_type is not None:
        w.message(12, _value_type(st, *period_type))
    if period:
        w.varint(13, period)
    return gzip.compress(w.finish())


def _frame_stack(frame) -> list[tuple[str, str, int]]:
    """Leaf-first (function, file, line) stack for a Python frame."""
    out = []
    f = frame
    while f is not None:
        # co_qualname is 3.11+; co_name keeps 3.10 serving (just less
        # qualified frame names in the profile).
        name = getattr(f.f_code, "co_qualname", f.f_code.co_name)
        out.append((name, f.f_code.co_filename, f.f_lineno))
        f = f.f_back
    return out


def thread_profile() -> bytes:
    """One sample per live thread — the ``goroutine`` profile analog."""
    names = {t.ident: t.name for t in threading.enumerate()}
    samples = []
    for tid, frame in sys._current_frames().items():
        stack = _frame_stack(frame)
        # Thread identity as the root pseudo-frame, like goroutine ids.
        stack.append((f"thread {names.get(tid, tid)}", "", 0))
        samples.append((stack, [1]))
    return build_profile(samples, [("threads", "count")])


def cpu_profile(seconds: float, hz: int = 100) -> bytes:
    """Sampling CPU profile: every thread's Python stack at ``hz`` for
    ``seconds`` (the /debug/pprof/profile analog; sampling, like pprof's,
    not tracing — negligible overhead on the serving path)."""
    interval = 1.0 / hz
    period_ns = int(1e9 / hz)
    counts: Counter[tuple] = Counter()
    deadline = time.monotonic() + seconds
    me = threading.get_ident()
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue  # the sampler itself is not workload
            counts[tuple(_frame_stack(frame))] += 1
        time.sleep(interval)
    samples = [
        (list(stack), [n, n * period_ns]) for stack, n in counts.items()
    ]
    return build_profile(
        samples,
        [("samples", "count"), ("cpu", "nanoseconds")],
        period_type=("cpu", "nanoseconds"),
        period=period_ns,
        duration_nanos=int(seconds * 1e9),
    )


def text_threads() -> str:
    """Human-readable thread dump (the ?debug=1 form)."""
    import io

    out = io.StringIO()
    for tid, frame in sys._current_frames().items():
        out.write(f"--- thread {tid} ---\n")
        out.write("".join(traceback.format_stack(frame)))
    return out.getvalue()
