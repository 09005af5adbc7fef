"""Time-quantum view decomposition.

Reference analog: time.go.  A timestamped bit is written into one view per
quantum unit (Y/M/D/H, time.go:82-92); a range query covers [start, end)
with the minimal set of unit views — walk up from small to large units
until aligned, then back down (time.go:95-167).

This is the reference's "long-axis" scaling trick for the time dimension
(SURVEY.md §5): on the device side each time view is just another stack of
slice-sharded bitmaps, and a Range query becomes a segmented OR-reduction
over the covering views.
"""

from __future__ import annotations

from datetime import datetime, timedelta

from pilosa_tpu_torch.pilosa import ErrInvalidTimeQuantum

_VALID = {"Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H", ""}

_FMT = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}


def parse_time_quantum(v: str) -> str:
    q = v.upper()
    if q not in _VALID:
        raise ErrInvalidTimeQuantum(f"invalid time quantum: {v!r}")
    return q


def view_by_time_unit(name: str, t: datetime, unit: str) -> str:
    fmt = _FMT.get(unit)
    if fmt is None:
        return ""
    return f"{name}_{t.strftime(fmt)}"


def views_by_time(name: str, t: datetime, quantum: str) -> list[str]:
    """One view name per unit in the quantum (write fan-out; time.go:82-92)."""
    return [v for unit in quantum if (v := view_by_time_unit(name, t, unit))]


def _add_date(t: datetime, years: int, months: int, days: int) -> datetime:
    """Calendar add with Go time.AddDate overflow normalization
    (Jan 31 + 1 month = Mar 2/3, matching Go's semantics)."""
    y = t.year + years
    m = t.month + months
    y += (m - 1) // 12
    m = (m - 1) % 12 + 1
    base = t.replace(year=y, month=m, day=1)
    return base + timedelta(days=t.day - 1 + days)


def _next_year_gte(t: datetime, end: datetime) -> bool:
    next_t = _add_date(t, 1, 0, 0)
    return next_t.year == end.year or end > next_t


def _next_month_gte(t: datetime, end: datetime) -> bool:
    next_t = _add_date(t, 0, 1, 0)
    return (next_t.year, next_t.month) == (end.year, end.month) or end > next_t


def _next_day_gte(t: datetime, end: datetime) -> bool:
    next_t = _add_date(t, 0, 0, 1)
    return next_t.date() == end.date() or end > next_t


def views_by_time_range(name: str, start: datetime, end: datetime, quantum: str) -> list[str]:
    """Minimal view cover of [start, end) (time.go:95-167)."""
    has_y, has_m, has_d, has_h = ("Y" in quantum, "M" in quantum, "D" in quantum, "H" in quantum)
    t = start
    results: list[str] = []

    # Walk up small→large: emit sub-unit views until t is aligned to the
    # next-larger unit (or the range can't reach that unit's boundary).
    if has_h or has_d or has_m:
        while t < end:
            if has_h:
                if not _next_day_gte(t, end):
                    break
                if t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t = t + timedelta(hours=1)
                    continue
            if has_d:
                if not _next_month_gte(t, end):
                    break
                if t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t = _add_date(t, 0, 0, 1)
                    continue
            if has_m:
                if not _next_year_gte(t, end):
                    break
                if t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_date(t, 0, 1, 0)
                    continue
            break

    # Walk down large→small consuming whole units that fit.
    while t < end:
        if has_y and _next_year_gte(t, end):
            results.append(view_by_time_unit(name, t, "Y"))
            t = _add_date(t, 1, 0, 0)
        elif has_m and _next_month_gte(t, end):
            results.append(view_by_time_unit(name, t, "M"))
            t = _add_date(t, 0, 1, 0)
        elif has_d and _next_day_gte(t, end):
            results.append(view_by_time_unit(name, t, "D"))
            t = _add_date(t, 0, 0, 1)
        elif has_h:
            results.append(view_by_time_unit(name, t, "H"))
            t = t + timedelta(hours=1)
        else:
            break

    return results
