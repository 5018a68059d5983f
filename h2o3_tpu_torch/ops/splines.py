"""Cubic regression-spline basis — numpy only.

The port's own copy of `h2o3_tpu/ops/splines.py`, byte for byte in its
arithmetic, so the port's knots, basis, centres and penalty are the
reference's bit for bit. Shared by GAM training (`models/gam.py`) and the
offline MOJO scorer (`mojo.py`). Reference:
`hex/gam/MatrixFrameUtils/GamUtils.java` basis generation (`bs=0`
cr-splines).
"""

from __future__ import annotations

import numpy as np


def spline_basis(col: np.ndarray, knots: np.ndarray) -> np.ndarray:
    """Natural cubic regression spline basis on the given interior knots
    (the reference's `bs=0` cr-spline), K knots → K−1 basis columns (the
    constant column is dropped — absorbed by the model intercept)."""
    K = len(knots)
    kmin, kmax = knots[0], knots[-1]
    rng = max(kmax - kmin, 1e-12)

    def d(z, kj):  # truncated cubic, scaled for conditioning
        t = np.maximum(z - kj, 0.0) / rng
        return t**3

    # natural spline: linear beyond boundary knots (Royston/Parmar form)
    cols = [np.ones_like(col), (col - kmin) / rng]
    for j in range(1, K - 1):
        lam = (kmax - knots[j]) / rng
        cols.append(d(col, knots[j]) - lam * d(col, kmin) - (1 - lam) * d(col, kmax))
    return np.column_stack(cols[1:])  # drop the constant (absorbed by intercept)


def second_diff_penalty(m: int) -> np.ndarray:
    """S = D'D with D the second-difference operator — the standard P-spline
    roughness penalty standing in for the cr-spline integral penalty."""
    if m < 3:
        return np.eye(m) * 1e-3
    D = np.zeros((m - 2, m))
    for i in range(m - 2):
        D[i, i : i + 3] = (1.0, -2.0, 1.0)
    return D.T @ D
