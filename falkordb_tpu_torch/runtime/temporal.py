"""Calendar-aware temporal arithmetic (reference parity).

The reference encodes a Duration as an i64: the seconds-from-epoch of
(epoch + duration), constructed via a civil-calendar anchor so the
years/months component survives round-trips
(/root/reference/graph/src/runtime/functions/temporal.rs:429-489,
construct_duration_secs / decompose_duration).  We keep Python's
`datetime.timedelta` as the Duration value type but define its value as
that same anchored encoding — so equality, ordering, hashing and the
wire format (`int(total_seconds())`) all coincide with the reference's
i64 semantics, while we additionally carry microsecond precision.

Date/Datetime/Time +- Duration applies the years/months component with
civil-calendar rules (day-overflow rolls forward on add, clamps on
subtract), mirroring add_duration_to_timestamp /
sub_duration_from_timestamp (/root/reference/graph/src/runtime/value.rs:696-750).
"""

from __future__ import annotations

import datetime as _dt
import re

_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _is_leap(year: int) -> bool:
    return (year % 4 == 0 and year % 100 != 0) or year % 400 == 0


def days_in_month(year: int, month: int) -> int:
    if month == 2 and _is_leap(year):
        return 29
    return _DAYS_IN_MONTH[month - 1]


def days_from_civil(y: int, m: int, d: int) -> int:
    """Howard Hinnant's civil->days since 1970-01-01 (proleptic Gregorian);
    mirrors /root/reference/graph/src/runtime/functions/temporal.rs:413."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    mp = m - 3 if m > 2 else m + 9
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146_097 + doe - 719_468


def civil_from_days(z: int) -> tuple[int, int, int]:
    """Inverse of days_from_civil (value.rs civil_from_days)."""
    z += 719_468
    era = (z if z >= 0 else z - 146_096) // 146_097
    doe = z - era * 146_097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146_096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 if mp < 10 else mp - 9
    return y + (m <= 2), m, d


def construct_duration(years=0, months=0, weeks=0, days=0, hours=0,
                       minutes=0, seconds=0.0) -> _dt.timedelta:
    """Duration components -> anchored-encoding timedelta
    (temporal.rs construct_duration_secs; we keep fractional seconds)."""
    total_months = int(years) * 12 + int(months)
    base_year = 1970 + total_months // 12
    base_month = total_months % 12 + 1
    anchor = days_from_civil(base_year, base_month, 1) * 86400
    extra = ((int(weeks) * 7 + int(days)) * 86400 + int(hours) * 3600
             + int(minutes) * 60)
    return _dt.timedelta(seconds=anchor + extra) + _dt.timedelta(
        seconds=float(seconds))


def decompose_duration(td: _dt.timedelta) -> tuple[int, int, float]:
    """timedelta (anchored encoding) -> (years, months, remaining_seconds);
    temporal.rs decompose_duration."""
    total = td.days * 86400 + td.seconds + td.microseconds / 1e6
    days, time_of_day = divmod(int(total), 86400)
    frac = total - int(total)
    y, m, d = civil_from_days(days)
    remaining = (d - 1) * 86400 + time_of_day + frac
    return y - 1970, m - 1, remaining


def duration_components(td: _dt.timedelta) -> dict:
    """The reference's Duration_getComponent decomposition
    (value.rs get_duration_component): all values are floats; weeks is
    always 0 in the C decomposition."""
    years, months, remaining = decompose_duration(td)
    rsec = int(remaining)
    frac = remaining - rsec  # sub-second precision extension (the
    # reference's i64 encoding cannot carry it; ours does)
    return {
        "years": float(years),
        "months": float(months),
        "weeks": 0.0,
        "days": float(rsec // 86400),
        "hours": float(rsec % 86400 // 3600),
        "minutes": float(rsec % 3600 // 60),
        "seconds": float(rsec % 60) + frac,
    }


def duration_add(a: _dt.timedelta, b: _dt.timedelta,
                 sign: int = 1) -> _dt.timedelta:
    """Duration +- Duration: components add linearly, NOT encodings
    (value.rs add_slow Duration arm: decompose both, add, reconstruct)."""
    ya, ma, sa = decompose_duration(a)
    yb, mb, sb = decompose_duration(b)
    total_months = (ya + sign * yb) * 12 + (ma + sign * mb)
    return construct_duration(years=total_months // 12,
                              months=total_months % 12,
                              seconds=sa + sign * sb)


def _shift_months_days(ts_days: int, years: int, months: int,
                       subtract: bool) -> int:
    """Apply a calendar year/month shift to a day count.  On add, day
    overflow rolls into the next month; on subtract it clamps
    (value.rs:696-750 — note the deliberate asymmetry)."""
    y, m, d = civil_from_days(ts_days)
    if subtract:
        years, months = -years, -months
    month_raw = m + months
    adj_year = y + years + (month_raw - 1) // 12
    adj_month = (month_raw - 1) % 12 + 1
    max_day = days_in_month(adj_year, adj_month)
    if not subtract and d > max_day:
        overflow = d - max_day
        adj_month += 1
        if adj_month > 12:
            adj_year, adj_month = adj_year + 1, 1
        d = overflow
    elif d > max_day:
        d = max_day
    return days_from_civil(adj_year, adj_month, d)


def date_add_duration(d, td: _dt.timedelta, subtract: bool = False):
    """date/datetime +- duration.  Preserves the concrete type (and
    tzinfo for datetimes)."""
    years, months, remaining = decompose_duration(td)
    if isinstance(d, _dt.datetime):
        base_days = days_from_civil(d.year, d.month, d.day)
        new_days = _shift_months_days(base_days, years, months, subtract)
        ny, nm, nd = civil_from_days(new_days)
        shifted = d.replace(year=ny, month=nm, day=nd)
        delta = _dt.timedelta(seconds=remaining)
        return shifted - delta if subtract else shifted + delta
    # plain date: sub-day remainder is applied then truncated back to a
    # date (the reference's Date is a midnight timestamp; adding PT12H
    # keeps the civil day)
    base_days = days_from_civil(d.year, d.month, d.day)
    new_days = _shift_months_days(base_days, years, months, subtract)
    total = new_days * 86400 + (-remaining if subtract else remaining)
    ny, nm, nd = civil_from_days(int(total // 86400))
    return _dt.date(ny, nm, nd)


def time_add_duration(t: _dt.time, td: _dt.timedelta,
                      subtract: bool = False) -> _dt.time:
    """time +- duration: only the sub-day component matters; wraps mod
    24h (the reference keeps raw seconds on its epoch-based Time; a
    Python time must stay in [0, 24h))."""
    _, _, remaining = decompose_duration(td)
    cur = t.hour * 3600 + t.minute * 60 + t.second + t.microsecond / 1e6
    total = (cur - remaining if subtract else cur + remaining) % 86400
    usec = round(total * 1e6)
    sec, usec = divmod(usec, 1_000_000)
    mi, s = divmod(sec, 60)
    h, mi = divmod(mi, 60)
    return _dt.time(int(h) % 24, int(mi), int(s), int(usec),
                    tzinfo=t.tzinfo)


def format_duration(td: _dt.timedelta) -> str:
    """ISO-8601 rendering of an anchored-encoding duration
    (value.rs:296 format_duration: omit zero components, 'PT0S' for the
    zero duration)."""
    years, months, remaining = decompose_duration(td)
    rsec = int(remaining)
    frac = remaining - rsec
    days, rsec = divmod(rsec, 86400)
    hours, rsec = divmod(rsec, 3600)
    minutes, seconds = divmod(rsec, 60)
    s = "P"
    for val, unit in ((years, "Y"), (months, "M"), (days, "D")):
        if val:
            s += f"{val}{unit}"
    if frac:  # fixed-point, not %g: 'PT1e-06S' is not ISO-8601
        secs = f"{seconds + frac:.6f}".rstrip("0").rstrip(".")
    else:
        secs = str(seconds) if seconds else ""
    if hours or minutes or secs:
        s += "T"
        if hours:
            s += f"{hours}H"
        if minutes:
            s += f"{minutes}M"
        if secs:
            s += f"{secs}S"
    return s if len(s) > 1 else "PT0S"


_DUR_RE = re.compile(
    r"P(?:(-?\d+)Y)?(?:(-?\d+)M)?(?:(-?\d+)W)?(?:(-?\d+)D)?"
    r"(?:T(?:(-?\d+)H)?(?:(-?\d+)M)?(?:(-?[\d.]+)S)?)?")


def parse_duration(s: str) -> _dt.timedelta:
    """ISO-8601 duration string -> anchored timedelta
    (temporal.rs parse_duration_string; we also keep fractional seconds)."""
    m = _DUR_RE.fullmatch(s)
    if not m or s == "P":
        raise ValueError(f"bad duration {s!r}")
    y, mo, w, d, h, mi, sec = m.groups()
    return construct_duration(
        years=int(y or 0), months=int(mo or 0), weeks=int(w or 0),
        days=int(d or 0), hours=int(h or 0), minutes=int(mi or 0),
        seconds=float(sec or 0.0))
