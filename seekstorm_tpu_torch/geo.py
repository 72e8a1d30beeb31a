"""Geo search primitives: Morton (Z-order) codes over (lat, lon) + distances.

Mirrors the reference's geo layer (reference seekstorm/src/geo_search.rs:12-144):
Point facets are stored as u64 Morton codes; proximity ordering uses Morton
range prefilters + Euclidean-ish distance on decoded coordinates.
Vectorized numpy host-side; device variants live in ops when needed.
"""

from __future__ import annotations

import numpy as np

_EARTH_RADIUS_KM = 6371.0088


def _spread_u32(x: np.ndarray) -> np.ndarray:
    """Interleave zeros between bits of a u32 -> u64 (morton spread)."""
    x = x.astype(np.uint64)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def _squash_u64(x: np.ndarray) -> np.ndarray:
    x = x & np.uint64(0x5555555555555555)
    x = (x | (x >> np.uint64(1))) & np.uint64(0x3333333333333333)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return x


def encode_morton_2_d(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """(lat, lon) degrees -> u64 Morton code (32 bits per axis)."""
    lat_q = np.clip(((np.asarray(lat) + 90.0) / 180.0) * (2**32 - 1), 0, 2**32 - 1)
    lon_q = np.clip(((np.asarray(lon) + 180.0) / 360.0) * (2**32 - 1), 0, 2**32 - 1)
    return (_spread_u32(lat_q.astype(np.uint64)) << np.uint64(1)) | _spread_u32(
        lon_q.astype(np.uint64)
    )


def decode_morton_2_d(code: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    code = np.asarray(code, dtype=np.uint64)
    lat_q = _squash_u64(code >> np.uint64(1)).astype(np.float64)
    lon_q = _squash_u64(code).astype(np.float64)
    lat = lat_q / (2**32 - 1) * 180.0 - 90.0
    lon = lon_q / (2**32 - 1) * 360.0 - 180.0
    return lat, lon


def euclidian_distance(
    lat1: np.ndarray, lon1: np.ndarray, lat2: np.ndarray, lon2: np.ndarray
) -> np.ndarray:
    """Equirectangular-approximation distance in km (reference
    geo_search.rs:115 uses the same flat-earth approximation)."""
    la1, lo1 = np.radians(lat1), np.radians(lon1)
    la2, lo2 = np.radians(lat2), np.radians(lon2)
    x = (lo2 - lo1) * np.cos(0.5 * (la1 + la2))
    y = la2 - la1
    return _EARTH_RADIUS_KM * np.sqrt(x * x + y * y)


def point_distance(code: np.ndarray, lat: float, lon: float) -> np.ndarray:
    plat, plon = decode_morton_2_d(code)
    return euclidian_distance(plat, plon, lat, lon)
