"""Space-filling curves over 2-D chiplet grids (paper §3.2).

The paper places sequentially-communicating chiplets (input-embedding and
feed-forward pipelines on the ReRAM macro) along a space-filling curve so that
consecutive pipeline stages are physically adjacent on the interposer. This
module provides the classical curves it cites — Hilbert, Morton/Z, row-major
boustrophedon ("snake"), and the onion curve — as bijections

    order: {0..n-1} -> grid coordinates (x, y)

plus locality metrics used by the NoI optimizer and by ``core.hetero`` to
order TPU mesh devices.

All curves return an ``(n, 2)`` int array of (x, y) positions such that curve
step ``i`` maps to position ``pos[i]``; every grid cell appears exactly once
(bijectivity is property-tested in ``tests/test_sfc.py``).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "hilbert_curve",
    "morton_curve",
    "boustrophedon_curve",
    "onion_curve",
    "curve_positions",
    "locality_score",
    "mean_hop_stretch",
    "CURVES",
]


# ---------------------------------------------------------------------------
# Hilbert curve
# ---------------------------------------------------------------------------

def _hilbert_d2xy(order: int, d: int) -> tuple[int, int]:
    """Convert distance-along-curve ``d`` to (x, y) for a 2^order x 2^order grid."""
    t = d
    x = y = 0
    s = 1
    n = 1 << order
    while s < n:
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        # rotate quadrant
        if ry == 0:
            if rx == 1:
                x = s - 1 - x
                y = s - 1 - y
            x, y = y, x
        x += s * rx
        y += s * ry
        t //= 4
        s *= 2
    return x, y


def hilbert_curve(width: int, height: int) -> np.ndarray:
    """Hilbert ordering of a ``width x height`` grid.

    For non-power-of-two or non-square grids we walk the Hilbert curve of the
    enclosing 2^k square and drop positions outside the grid — this preserves
    the visiting order and (approximately) the locality of the true curve,
    which is the standard "pruned Hilbert" construction.
    """
    if width <= 0 or height <= 0:
        raise ValueError("grid dims must be positive")
    side = max(width, height)
    order = max(1, int(np.ceil(np.log2(side))))
    n = 1 << order
    out = []
    for d in range(n * n):
        x, y = _hilbert_d2xy(order, d)
        if x < width and y < height:
            out.append((x, y))
    return np.asarray(out, dtype=np.int64)


# ---------------------------------------------------------------------------
# Morton (Z-order) curve
# ---------------------------------------------------------------------------

def _deinterleave(z: int) -> tuple[int, int]:
    x = y = 0
    for bit in range(32):
        x |= ((z >> (2 * bit)) & 1) << bit
        y |= ((z >> (2 * bit + 1)) & 1) << bit
    return x, y


def morton_curve(width: int, height: int) -> np.ndarray:
    """Z-order ordering (pruned to the grid)."""
    if width <= 0 or height <= 0:
        raise ValueError("grid dims must be positive")
    side = max(width, height)
    order = max(1, int(np.ceil(np.log2(side))))
    n = 1 << order
    out = []
    for z in range(n * n):
        x, y = _deinterleave(z)
        if x < width and y < height:
            out.append((x, y))
    return np.asarray(out, dtype=np.int64)


# ---------------------------------------------------------------------------
# Boustrophedon ("snake") curve — row-major with alternating direction.
# Every consecutive pair is Manhattan-adjacent; this is the curve used for
# the ReRAM macro in the reference implementation because it is optimal for
# purely linear pipelines.
# ---------------------------------------------------------------------------

def rowmajor_curve(width: int, height: int) -> np.ndarray:
    """Row-major raster order — the non-locality-preserving baseline the
    paper's SFC argument is made against (long jumps at row ends)."""
    if width <= 0 or height <= 0:
        raise ValueError("grid dims must be positive")
    return np.asarray([(x, y) for y in range(height) for x in range(width)],
                      dtype=np.int64)


def boustrophedon_curve(width: int, height: int) -> np.ndarray:
    if width <= 0 or height <= 0:
        raise ValueError("grid dims must be positive")
    out = []
    for y in range(height):
        xs = range(width) if y % 2 == 0 else range(width - 1, -1, -1)
        for x in xs:
            out.append((x, y))
    return np.asarray(out, dtype=np.int64)


# ---------------------------------------------------------------------------
# Onion curve — concentric shells from the boundary inward (Xu et al., ICDE'18
# cited by the paper). Good clustering for range queries; we include it as a
# candidate ordering in the MOO search space.
# ---------------------------------------------------------------------------

def onion_curve(width: int, height: int) -> np.ndarray:
    if width <= 0 or height <= 0:
        raise ValueError("grid dims must be positive")
    visited = np.zeros((width, height), dtype=bool)
    out = []
    x0, y0, x1, y1 = 0, 0, width - 1, height - 1
    while x0 <= x1 and y0 <= y1:
        for x in range(x0, x1 + 1):
            out.append((x, y0))
        for y in range(y0 + 1, y1 + 1):
            out.append((x1, y))
        if y1 > y0:
            for x in range(x1 - 1, x0 - 1, -1):
                out.append((x, y1))
        if x1 > x0:
            for y in range(y1 - 1, y0, -1):
                out.append((x0, y))
        x0 += 1
        y0 += 1
        x1 -= 1
        y1 -= 1
    del visited
    return np.asarray(out, dtype=np.int64)


CURVES = {
    "hilbert": hilbert_curve,
    "rowmajor": rowmajor_curve,
    "morton": morton_curve,
    "boustrophedon": boustrophedon_curve,
    "onion": onion_curve,
}


def curve_positions(name: str, width: int, height: int) -> np.ndarray:
    try:
        fn = CURVES[name]
    except KeyError:  # pragma: no cover - defensive
        raise ValueError(f"unknown curve {name!r}; have {sorted(CURVES)}") from None
    return fn(width, height)


# ---------------------------------------------------------------------------
# Locality metrics
# ---------------------------------------------------------------------------

def locality_score(pos: np.ndarray) -> float:
    """Mean Manhattan distance between curve-consecutive grid cells.

    1.0 is optimal (every consecutive pair adjacent) — boustrophedon achieves
    it; Hilbert achieves it on power-of-two squares; Morton does not.
    """
    pos = np.asarray(pos)
    d = np.abs(np.diff(pos, axis=0)).sum(axis=1)
    return float(d.mean())


def mean_hop_stretch(pos: np.ndarray, window: int = 4) -> float:
    """Average Manhattan distance between cells ``<= window`` apart on the
    curve, normalised by their curve distance. Lower = better clustering.
    """
    pos = np.asarray(pos)
    n = len(pos)
    total, count = 0.0, 0
    for k in range(1, window + 1):
        d = np.abs(pos[k:] - pos[:-k]).sum(axis=1)
        total += float((d / k).sum())
        count += n - k
    return total / max(count, 1)
