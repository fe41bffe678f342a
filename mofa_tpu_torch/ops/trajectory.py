"""Trajectory interpolation (host-side preprocessing, numpy).

Counterpart of mofa_tpu/ops/trajectory.py, copied (the port imports nothing
of the JAX package): PCHIP (Fritsch-Carlson monotone cubic Hermite) as
scipy.interpolate.PchipInterpolator computes it, used by
`interpolate_trajectory` to resample a drag track's click points to one
point per frame.
"""

from __future__ import annotations

import numpy as np


def _pchip_derivatives(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    h = np.diff(x)
    delta = np.diff(y) / h
    n = len(x)
    d = np.zeros(n)
    if n == 2:
        d[:] = delta[0]
        return d
    # interior: weighted harmonic mean where slopes share sign
    for k in range(1, n - 1):
        if delta[k - 1] * delta[k] <= 0:
            d[k] = 0.0
        else:
            w1 = 2 * h[k] + h[k - 1]
            w2 = h[k] + 2 * h[k - 1]
            d[k] = (w1 + w2) / (w1 / delta[k - 1] + w2 / delta[k])
    # endpoints: one-sided three-point estimate with monotonicity clamp
    d[0] = _edge_derivative(h[0], h[1], delta[0], delta[1])
    d[-1] = _edge_derivative(h[-1], h[-2], delta[-1], delta[-2])
    return d


def _edge_derivative(h0, h1, del0, del1):
    d = ((2 * h0 + h1) * del0 - h0 * del1) / (h0 + h1)
    if np.sign(d) != np.sign(del0):
        return 0.0
    if np.sign(del0) != np.sign(del1) and abs(d) > 3 * abs(del0):
        return 3 * del0
    return d


def pchip_interpolate(x: np.ndarray, y: np.ndarray, xq: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xq = np.asarray(xq, dtype=np.float64)
    if len(x) == 1:
        return np.full_like(xq, y[0])
    d = _pchip_derivatives(x, y)
    idx = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, len(x) - 2)
    h = x[idx + 1] - x[idx]
    t = (xq - x[idx]) / h
    h00 = (1 + 2 * t) * (1 - t) ** 2
    h10 = t * (1 - t) ** 2
    h01 = t**2 * (3 - 2 * t)
    h11 = t**2 * (t - 1)
    return h00 * y[idx] + h10 * h * d[idx] + h01 * y[idx + 1] + h11 * h * d[idx + 1]


def interpolate_trajectory(points, n_points: int):
    """PCHIP-resample a list of (x, y) click points to n_points samples."""
    pts = np.asarray(points, dtype=np.float64)
    t = np.linspace(0, 1, len(pts))
    tq = np.linspace(0, 1, n_points)
    new_x = pchip_interpolate(t, pts[:, 0], tq)
    new_y = pchip_interpolate(t, pts[:, 1], tq)
    return list(zip(new_x, new_y))
