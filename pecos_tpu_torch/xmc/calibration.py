"""Platt calibration: fit sigmoid(A*s + B) mapping scores to probabilities.

The port of ``pecos_tpu/xmc/calibration.py`` (numpy, host only): Newton
iteration with backtracking line search on the regularized cross-entropy
objective (Platt 1999 / Lin et al. 2007), returning (A, B) and a status code
(1 when the line search failed).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def fit_platt_transform(
    scores: np.ndarray,
    targets: np.ndarray,
    max_iter: int = 100,
    min_step: float = 1e-10,
    sigma: float = 1e-12,
    eps: float = 1e-5,
) -> Tuple[float, float, int]:
    """Fit P(y=1|s) = 1 / (1 + exp(A*s + B)).

    targets are {0,1} (or {-1,+1}).  Returns (A, B, status) with status 0 on
    success, 1 if the line search failed (reference return-code semantics,
    core/base.py:2413-2426).
    """
    s = np.asarray(scores, np.float64).ravel()
    y = np.asarray(targets, np.float64).ravel()
    y = (y > 0).astype(np.float64)
    n = len(s)
    prior1 = y.sum()
    prior0 = n - prior1
    hi = (prior1 + 1.0) / (prior1 + 2.0)
    lo = 1.0 / (prior0 + 2.0)
    t = np.where(y > 0, hi, lo)

    A, B = 0.0, np.log((prior0 + 1.0) / (prior1 + 1.0))

    def fval(A, B):
        fApB = A * s + B
        pos = fApB >= 0
        return np.sum(
            np.where(
                pos,
                t * fApB + np.log1p(np.exp(-fApB)),
                (t - 1.0) * fApB + np.log1p(np.exp(fApB)),
            )
        )

    f = fval(A, B)
    for _ in range(max_iter):
        fApB = A * s + B
        pos = fApB >= 0
        p = np.where(pos, np.exp(-fApB) / (1.0 + np.exp(-fApB)), 1.0 / (1.0 + np.exp(fApB)))
        q = 1.0 - p
        d1 = t - p
        d2 = p * q
        g1 = np.sum(s * d1)
        g2 = np.sum(d1)
        if abs(g1) < eps and abs(g2) < eps:
            return float(A), float(B), 0
        h11 = np.sum(s * s * d2) + sigma
        h22 = np.sum(d2) + sigma
        h21 = np.sum(s * d2)
        det = h11 * h22 - h21 * h21
        dA = -(h22 * g1 - h21 * g2) / det
        dB = -(-h21 * g1 + h11 * g2) / det
        gd = g1 * dA + g2 * dB
        step = 1.0
        while step >= min_step:
            newA, newB = A + step * dA, B + step * dB
            newf = fval(newA, newB)
            if newf < f + 1e-4 * step * gd:
                A, B, f = newA, newB, newf
                break
            step /= 2.0
        else:
            return float(A), float(B), 1  # line search failure
    return float(A), float(B), 0


def apply_platt(scores: np.ndarray, A: float, B: float) -> np.ndarray:
    fApB = A * np.asarray(scores, np.float64) + B
    return np.where(
        fApB >= 0, np.exp(-fApB) / (1.0 + np.exp(-fApB)), 1.0 / (1.0 + np.exp(fApB))
    ).astype(np.float32)
