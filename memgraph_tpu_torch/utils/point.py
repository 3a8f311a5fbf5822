"""Spatial point values (Cartesian and WGS-84, 2d/3d) with distance.

Capability parity with the reference's point type
(memgraph/src/storage/v2/point.hpp) and `point.distance` semantics:
Euclidean distance for Cartesian CRS, haversine (meters) for WGS-84.

Copy of memgraph_tpu/utils/point.py for the port (its imports the port's own).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum

from ..exceptions import TypeException

WGS84_RADIUS_M = 6_371_009.0  # mean Earth radius


class CrsType(Enum):
    CARTESIAN_2D = 7203
    CARTESIAN_3D = 9157
    WGS84_2D = 4326
    WGS84_3D = 4979

    @property
    def is_wgs(self) -> bool:
        return self in (CrsType.WGS84_2D, CrsType.WGS84_3D)

    @property
    def dims(self) -> int:
        return 3 if self in (CrsType.CARTESIAN_3D, CrsType.WGS84_3D) else 2


@dataclass(frozen=True)
class Point:
    x: float
    y: float
    z: float | None
    crs: CrsType

    @classmethod
    def from_map(cls, m: dict) -> "Point":
        keys = {k.lower(): v for k, v in m.items()}
        crs_name = keys.get("crs")
        has_z = "z" in keys or "height" in keys
        is_wgs = ("longitude" in keys or "latitude" in keys
                  or (crs_name or "").lower().startswith("wgs"))
        if crs_name:
            table = {"cartesian": CrsType.CARTESIAN_2D,
                     "cartesian-3d": CrsType.CARTESIAN_3D,
                     "wgs-84": CrsType.WGS84_2D,
                     "wgs-84-3d": CrsType.WGS84_3D}
            crs = table.get(crs_name.lower())
            if crs is None:
                raise TypeException(f"Unknown CRS: {crs_name!r}")
        elif is_wgs:
            crs = CrsType.WGS84_3D if has_z else CrsType.WGS84_2D
        else:
            crs = CrsType.CARTESIAN_3D if has_z else CrsType.CARTESIAN_2D

        if crs.is_wgs:
            x = keys.get("longitude", keys.get("x"))
            y = keys.get("latitude", keys.get("y"))
            z = keys.get("height", keys.get("z")) if crs.dims == 3 else None
        else:
            x, y = keys.get("x"), keys.get("y")
            z = keys.get("z") if crs.dims == 3 else None
        if x is None or y is None or (crs.dims == 3 and z is None):
            raise TypeException("Missing point coordinate")
        x, y = float(x), float(y)
        z = float(z) if z is not None else None
        if crs.is_wgs and not (-180.0 <= x <= 180.0 and -90.0 <= y <= 90.0):
            raise TypeException("WGS-84 coordinates out of range")
        return cls(x, y, z, crs)

    @property
    def longitude(self) -> float:
        if not self.crs.is_wgs:
            raise TypeException("longitude on non-WGS point")
        return self.x

    @property
    def latitude(self) -> float:
        if not self.crs.is_wgs:
            raise TypeException("latitude on non-WGS point")
        return self.y

    @property
    def height(self) -> float:
        if not self.crs.is_wgs or self.z is None:
            raise TypeException("height on non-WGS-3d point")
        return self.z

    def to_map(self) -> dict:
        if self.crs.is_wgs:
            out = {"longitude": self.x, "latitude": self.y}
            if self.z is not None:
                out["height"] = self.z
            out["crs"] = "wgs-84-3d" if self.crs.dims == 3 else "wgs-84"
        else:
            out = {"x": self.x, "y": self.y}
            if self.z is not None:
                out["z"] = self.z
            out["crs"] = "cartesian-3d" if self.crs.dims == 3 else "cartesian"
        return out

    def distance(self, other: "Point") -> float:
        if self.crs != other.crs:
            raise TypeException("point.distance between different CRS")
        if self.crs.is_wgs:
            d = _haversine_m(self.y, self.x, other.y, other.x)
            if self.crs.dims == 3:
                dz = (self.z or 0.0) - (other.z or 0.0)
                return math.hypot(d, dz)
            return d
        dx, dy = self.x - other.x, self.y - other.y
        if self.crs.dims == 3:
            return math.sqrt(dx * dx + dy * dy
                             + ((self.z or 0.0) - (other.z or 0.0)) ** 2)
        return math.hypot(dx, dy)

    def __str__(self) -> str:
        return "point(" + ", ".join(f"{k}: {v}" for k, v in self.to_map().items()) + ")"


def _haversine_m(lat1, lon1, lat2, lon2) -> float:
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = p2 - p1
    dl = math.radians(lon2 - lon1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * WGS84_RADIUS_M * math.asin(math.sqrt(a))
