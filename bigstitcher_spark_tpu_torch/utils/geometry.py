"""Interval and 3-D affine geometry, xyz axis order throughout.

Conventions (matching the reference's imglib2/N5 world so on-disk artifacts
stay BigStitcher-compatible):
  * Intervals are integer, min/max INCLUSIVE, axis order (x, y, z).
  * Affines are 3x4 float64 row-major matrices ``[R | t]`` acting on column
    vectors: ``world = R @ p + t`` — same layout as the 12-number
    ``<affine>`` rows in SpimData XML.
  * Composition ``concatenate(A, B)`` applies B first, then A (imglib2
    ``AffineTransform3D.concatenate`` semantics).

Reference behavior covered here: interval overlap tests and transformed
bounding boxes (ViewUtil.java:102-105,154-159), grid-block geometry helpers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np


@dataclass(frozen=True)
class Interval:
    """Integer interval with inclusive min/max, axis order xyz."""

    min: tuple[int, ...]
    max: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "min", tuple(int(v) for v in self.min))
        object.__setattr__(self, "max", tuple(int(v) for v in self.max))
        if len(self.min) != len(self.max):
            raise ValueError(f"rank mismatch: {self.min} vs {self.max}")

    @staticmethod
    def from_shape(shape: Sequence[int], offset: Sequence[int] | None = None) -> "Interval":
        off = tuple(offset) if offset is not None else (0,) * len(shape)
        return Interval(off, tuple(o + s - 1 for o, s in zip(off, shape)))

    @property
    def ndim(self) -> int:
        return len(self.min)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(mx - mn + 1 for mn, mx in zip(self.min, self.max))

    @property
    def num_elements(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def is_empty(self) -> bool:
        return any(mx < mn for mn, mx in zip(self.min, self.max))

    def overlaps(self, other: "Interval") -> bool:
        return all(
            amn <= bmx and bmn <= amx
            for amn, amx, bmn, bmx in zip(self.min, self.max, other.min, other.max)
        )

    def intersect(self, other: "Interval") -> "Interval":
        return Interval(
            tuple(max(a, b) for a, b in zip(self.min, other.min)),
            tuple(min(a, b) for a, b in zip(self.max, other.max)),
        )

    def union(self, other: "Interval") -> "Interval":
        return Interval(
            tuple(min(a, b) for a, b in zip(self.min, other.min)),
            tuple(max(a, b) for a, b in zip(self.max, other.max)),
        )

    def expand(self, border: int | Sequence[int]) -> "Interval":
        if isinstance(border, int):
            border = (border,) * self.ndim
        return Interval(
            tuple(mn - b for mn, b in zip(self.min, border)),
            tuple(mx + b for mx, b in zip(self.max, border)),
        )

    def translate(self, offset: Sequence[int]) -> "Interval":
        return Interval(
            tuple(mn + o for mn, o in zip(self.min, offset)),
            tuple(mx + o for mx, o in zip(self.max, offset)),
        )


# ---------------------------------------------------------------------------
# Affine 3x4 helpers
# ---------------------------------------------------------------------------

def identity_affine() -> np.ndarray:
    return np.hstack([np.eye(3), np.zeros((3, 1))])


def affine_from_flat(values: Iterable[float]) -> np.ndarray:
    """12 row-major numbers (the SpimData ``<affine>`` element) -> 3x4."""
    a = np.asarray(list(values), dtype=np.float64)
    if a.size != 12:
        raise ValueError(f"expected 12 affine values, got {a.size}")
    return a.reshape(3, 4)


def affine_to_flat(a: np.ndarray) -> list[float]:
    return [float(v) for v in np.asarray(a, dtype=np.float64).reshape(-1)]


def translation_affine(t: Sequence[float]) -> np.ndarray:
    m = identity_affine()
    m[:, 3] = np.asarray(t, dtype=np.float64)
    return m


def scale_affine(s: Sequence[float]) -> np.ndarray:
    m = identity_affine()
    m[0, 0], m[1, 1], m[2, 2] = float(s[0]), float(s[1]), float(s[2])
    return m


def concatenate(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Apply ``b`` first, then ``a`` (imglib2 concatenate / preConcatenate dual)."""
    r = np.empty((3, 4), dtype=np.float64)
    r[:, :3] = a[:, :3] @ b[:, :3]
    r[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return r


def concatenate_all(transforms: Sequence[np.ndarray]) -> np.ndarray:
    """Full model of a SpimData transform chain: first list element is the
    OUTERMOST (last applied) transform, matching ViewRegistration.getModel()."""
    m = identity_affine()
    for t in transforms:
        m = concatenate(m, t)
    return m


def invert_affine(a: np.ndarray) -> np.ndarray:
    rinv = np.linalg.inv(a[:, :3])
    out = np.empty((3, 4), dtype=np.float64)
    out[:, :3] = rinv
    out[:, 3] = -rinv @ a[:, 3]
    return out


def apply_affine(a: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Apply 3x4 affine to points of shape (..., 3)."""
    p = np.asarray(points, dtype=np.float64)
    return p @ a[:, :3].T + a[:, 3]


def estimate_bounds(a: np.ndarray, interval: Interval) -> tuple[np.ndarray, np.ndarray]:
    """Float min/max of the transformed corners of ``interval``
    (TransformationTools bounding-box logic, ViewUtil.java:154-159)."""
    mn = np.asarray(interval.min, dtype=np.float64)
    mx = np.asarray(interval.max, dtype=np.float64)
    corners = np.array(
        [
            [(mn[0], mx[0])[(i >> 0) & 1], (mn[1], mx[1])[(i >> 1) & 1], (mn[2], mx[2])[(i >> 2) & 1]]
            for i in range(8)
        ],
        dtype=np.float64,
    )
    tc = apply_affine(a, corners)
    return tc.min(axis=0), tc.max(axis=0)


def transformed_interval(a: np.ndarray, interval: Interval) -> Interval:
    """Smallest integer interval containing the transformed interval
    (imglib2 ``Intervals.smallestContainingInterval`` of the estimated bounds)."""
    lo, hi = estimate_bounds(a, interval)
    return Interval(tuple(np.floor(lo).astype(np.int64)), tuple(np.ceil(hi).astype(np.int64)))
