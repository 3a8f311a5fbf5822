"""Cypher temporal types: Date, LocalTime, LocalDateTime, ZonedDateTime, Duration.

Capability parity with the reference's temporal values
(memgraph/src/utils/temporal.hpp) — microsecond precision, ISO-8601
construction, component accessors, and +/- arithmetic with Duration — built on
Python's datetime rather than hand-rolled calendars.

Copy of memgraph_tpu/utils/temporal.py for the port (its imports the port's own).
"""

from __future__ import annotations

import datetime as _dt
import re
from dataclasses import dataclass
from functools import total_ordering

from ..exceptions import TypeException

MICROS_PER_SECOND = 1_000_000
MICROS_PER_MINUTE = 60 * MICROS_PER_SECOND
MICROS_PER_HOUR = 60 * MICROS_PER_MINUTE
MICROS_PER_DAY = 24 * MICROS_PER_HOUR


@total_ordering
@dataclass(frozen=True)
class Duration:
    """Signed duration with microsecond resolution, stored as total micros."""

    micros: int = 0

    @classmethod
    def from_parts(cls, *, days=0, hours=0, minutes=0, seconds=0,
                   milliseconds=0, microseconds=0) -> "Duration":
        total = (int(days) * MICROS_PER_DAY + int(hours) * MICROS_PER_HOUR
                 + int(minutes) * MICROS_PER_MINUTE)
        # fractional seconds are allowed in Cypher duration maps
        total += round(seconds * MICROS_PER_SECOND)
        total += round(milliseconds * 1000)
        total += round(microseconds)
        return cls(total)

    _ISO_RE = re.compile(
        r"^(?P<sign>-)?P(?!$)(?:(?P<days>\d+(?:\.\d+)?)D)?"
        r"(?:T(?!$)(?:(?P<hours>\d+(?:\.\d+)?)H)?(?:(?P<minutes>\d+(?:\.\d+)?)M)?"
        r"(?:(?P<seconds>\d+(?:\.\d+)?)S)?)?$")

    @classmethod
    def parse(cls, text: str) -> "Duration":
        m = cls._ISO_RE.match(text.strip())
        if not m:
            raise TypeException(f"Invalid duration string: {text!r}")
        g = {k: float(v) if v else 0.0 for k, v in m.groupdict(default="").items()
             if k != "sign"}
        d = cls.from_parts(days=0, hours=g["hours"], minutes=g["minutes"],
                           seconds=g["seconds"])
        d = Duration(d.micros + round(g["days"] * MICROS_PER_DAY))
        return Duration(-d.micros) if m.group("sign") else d

    # accessors (Cypher exposes day/hour/minute/second/... of normalized form)
    @property
    def days(self) -> int:
        return self.micros // MICROS_PER_DAY

    @property
    def hours(self) -> int:
        return (self.micros % MICROS_PER_DAY) // MICROS_PER_HOUR

    @property
    def minutes(self) -> int:
        return (self.micros % MICROS_PER_HOUR) // MICROS_PER_MINUTE

    @property
    def seconds(self) -> int:
        return (self.micros % MICROS_PER_MINUTE) // MICROS_PER_SECOND

    @property
    def microseconds(self) -> int:
        return self.micros % MICROS_PER_SECOND

    def to_timedelta(self) -> _dt.timedelta:
        return _dt.timedelta(microseconds=self.micros)

    def __add__(self, other):
        if isinstance(other, Duration):
            return Duration(self.micros + other.micros)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, Duration):
            return Duration(self.micros - other.micros)
        return NotImplemented

    def __neg__(self):
        return Duration(-self.micros)

    def __lt__(self, other):
        if isinstance(other, Duration):
            return self.micros < other.micros
        return NotImplemented

    def __str__(self) -> str:
        m = abs(self.micros)
        sign = "-" if self.micros < 0 else ""
        days, m = divmod(m, MICROS_PER_DAY)
        hours, m = divmod(m, MICROS_PER_HOUR)
        minutes, m = divmod(m, MICROS_PER_MINUTE)
        seconds, micros = divmod(m, MICROS_PER_SECOND)
        frac = f".{micros:06d}".rstrip("0") if micros else ""
        return f"{sign}P{days}DT{hours}H{minutes}M{seconds}{frac}S"


@total_ordering
@dataclass(frozen=True)
class Date:
    d: _dt.date

    @classmethod
    def parse(cls, text: str) -> "Date":
        try:
            return cls(_dt.date.fromisoformat(text.strip()))
        except ValueError as e:
            raise TypeException(f"Invalid date string: {text!r}") from e

    @classmethod
    def from_parts(cls, year: int, month: int = 1, day: int = 1) -> "Date":
        try:
            return cls(_dt.date(year, month, day))
        except ValueError as e:
            raise TypeException(str(e)) from e

    @classmethod
    def today(cls) -> "Date":
        return cls(_dt.date.today())

    year = property(lambda self: self.d.year)
    month = property(lambda self: self.d.month)
    day = property(lambda self: self.d.day)

    def __add__(self, other):
        if isinstance(other, Duration):
            return Date((_dt.datetime.combine(self.d, _dt.time())
                         + other.to_timedelta()).date())
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Duration):
            return Date((_dt.datetime.combine(self.d, _dt.time())
                         - other.to_timedelta()).date())
        if isinstance(other, Date):
            delta = _dt.datetime.combine(self.d, _dt.time()) - \
                _dt.datetime.combine(other.d, _dt.time())
            return Duration(round(delta.total_seconds() * MICROS_PER_SECOND))
        return NotImplemented

    def __lt__(self, other):
        if isinstance(other, Date):
            return self.d < other.d
        return NotImplemented

    def __str__(self) -> str:
        return self.d.isoformat()


@total_ordering
@dataclass(frozen=True)
class LocalTime:
    t: _dt.time

    @classmethod
    def parse(cls, text: str) -> "LocalTime":
        try:
            return cls(_dt.time.fromisoformat(text.strip()))
        except ValueError as e:
            raise TypeException(f"Invalid local time string: {text!r}") from e

    @classmethod
    def from_parts(cls, hour=0, minute=0, second=0, millisecond=0,
                   microsecond=0) -> "LocalTime":
        try:
            return cls(_dt.time(hour, minute, second,
                                millisecond * 1000 + microsecond))
        except ValueError as e:
            raise TypeException(str(e)) from e

    hour = property(lambda self: self.t.hour)
    minute = property(lambda self: self.t.minute)
    second = property(lambda self: self.t.second)
    millisecond = property(lambda self: self.t.microsecond // 1000)
    microsecond = property(lambda self: self.t.microsecond % 1000)

    def _micros(self) -> int:
        return (self.t.hour * MICROS_PER_HOUR + self.t.minute * MICROS_PER_MINUTE
                + self.t.second * MICROS_PER_SECOND + self.t.microsecond)

    def __add__(self, other):
        if isinstance(other, Duration):
            m = (self._micros() + other.micros) % MICROS_PER_DAY
            return LocalTime(_micros_to_time(m))
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Duration):
            m = (self._micros() - other.micros) % MICROS_PER_DAY
            return LocalTime(_micros_to_time(m))
        if isinstance(other, LocalTime):
            return Duration(self._micros() - other._micros())
        return NotImplemented

    def __lt__(self, other):
        if isinstance(other, LocalTime):
            return self.t < other.t
        return NotImplemented

    def __str__(self) -> str:
        return self.t.isoformat()


def _micros_to_time(m: int) -> _dt.time:
    hours, m = divmod(m, MICROS_PER_HOUR)
    minutes, m = divmod(m, MICROS_PER_MINUTE)
    seconds, micros = divmod(m, MICROS_PER_SECOND)
    return _dt.time(hours, minutes, seconds, micros)


@total_ordering
@dataclass(frozen=True)
class LocalDateTime:
    dt: _dt.datetime  # naive

    @classmethod
    def parse(cls, text: str) -> "LocalDateTime":
        try:
            dt = _dt.datetime.fromisoformat(text.strip())
        except ValueError as e:
            raise TypeException(f"Invalid local datetime string: {text!r}") from e
        if dt.tzinfo is not None:
            raise TypeException("LocalDateTime must not carry a timezone")
        return cls(dt)

    @classmethod
    def from_parts(cls, year, month=1, day=1, hour=0, minute=0, second=0,
                   millisecond=0, microsecond=0) -> "LocalDateTime":
        try:
            return cls(_dt.datetime(year, month, day, hour, minute, second,
                                    millisecond * 1000 + microsecond))
        except ValueError as e:
            raise TypeException(str(e)) from e

    @classmethod
    def now(cls) -> "LocalDateTime":
        return cls(_dt.datetime.now())

    year = property(lambda self: self.dt.year)
    month = property(lambda self: self.dt.month)
    day = property(lambda self: self.dt.day)
    hour = property(lambda self: self.dt.hour)
    minute = property(lambda self: self.dt.minute)
    second = property(lambda self: self.dt.second)
    millisecond = property(lambda self: self.dt.microsecond // 1000)
    microsecond = property(lambda self: self.dt.microsecond % 1000)

    def date(self) -> Date:
        return Date(self.dt.date())

    def local_time(self) -> LocalTime:
        return LocalTime(self.dt.time())

    def timestamp_micros(self) -> int:
        epoch = _dt.datetime(1970, 1, 1)
        return round((self.dt - epoch).total_seconds() * MICROS_PER_SECOND)

    def __add__(self, other):
        if isinstance(other, Duration):
            return LocalDateTime(self.dt + other.to_timedelta())
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Duration):
            return LocalDateTime(self.dt - other.to_timedelta())
        if isinstance(other, LocalDateTime):
            delta = self.dt - other.dt
            return Duration(round(delta.total_seconds() * MICROS_PER_SECOND))
        return NotImplemented

    def __lt__(self, other):
        if isinstance(other, LocalDateTime):
            return self.dt < other.dt
        return NotImplemented

    def __str__(self) -> str:
        return self.dt.isoformat()


@total_ordering
@dataclass(frozen=True)
class ZonedDateTime:
    dt: _dt.datetime  # aware

    @classmethod
    def parse(cls, text: str) -> "ZonedDateTime":
        text = text.strip()
        # support trailing [Area/City] timezone names
        m = re.match(r"^(.*?)\[(.+)\]$", text)
        try:
            if m:
                from zoneinfo import ZoneInfo
                base = _dt.datetime.fromisoformat(m.group(1))
                tz = ZoneInfo(m.group(2))
                if base.tzinfo is None:
                    return cls(base.replace(tzinfo=tz))
                return cls(base.astimezone(tz))
            dt = _dt.datetime.fromisoformat(text)
        except Exception as e:
            raise TypeException(f"Invalid zoned datetime string: {text!r}") from e
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=_dt.timezone.utc)
        return cls(dt)

    @classmethod
    def now(cls) -> "ZonedDateTime":
        return cls(_dt.datetime.now(_dt.timezone.utc))

    year = property(lambda self: self.dt.year)
    month = property(lambda self: self.dt.month)
    day = property(lambda self: self.dt.day)
    hour = property(lambda self: self.dt.hour)
    minute = property(lambda self: self.dt.minute)
    second = property(lambda self: self.dt.second)

    def timestamp_micros(self) -> int:
        return round(self.dt.timestamp() * MICROS_PER_SECOND)

    def timezone_name(self) -> str:
        return str(self.dt.tzinfo)

    def __add__(self, other):
        if isinstance(other, Duration):
            return ZonedDateTime(self.dt + other.to_timedelta())
        return NotImplemented

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Duration):
            return ZonedDateTime(self.dt - other.to_timedelta())
        if isinstance(other, ZonedDateTime):
            delta = self.dt - other.dt
            return Duration(round(delta.total_seconds() * MICROS_PER_SECOND))
        return NotImplemented

    def __lt__(self, other):
        if isinstance(other, ZonedDateTime):
            return self.dt < other.dt
        return NotImplemented

    def __str__(self) -> str:
        return self.dt.isoformat()
