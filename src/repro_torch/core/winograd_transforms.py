"""Cook-Toom / Winograd minimal-filtering transform generator.

Generates the (A, G, B) matrices of the Winograd convolution
``y = A^T [ (G g) (.) (B^T d) ]`` for arbitrary F(m, r) — m outputs from
an r-tap correlation over a tile of alpha = m + r - 1 inputs — using the
transpose theorem:

Polynomial multiplication p(x) = a(x) b(x) with deg a = m-1,
deg b = r-1 is computed exactly from evaluations at alpha-1 finite
points plus the point at infinity (leading coefficient):

    p_coeffs = V^{-1} [ (X a) (.) (Y b) ]

where V is the (alpha x alpha) "Vandermonde + infinity row" matrix, and
X, Y are its first m / r columns.  The Toeplitz operator of
multiplication-by-g applied to an m-vector is exactly the transpose of
r-tap correlation over an alpha-tile, hence

    y = X^T [ (Y g) (.) (V^{-T} d) ]
      = A^T [ (G g) (.) (B^T d) ]   with  A = X, G = Y, B^T = V^{-T}.

For good point sets (0, +-1, +-2, +-1/2, ...) and alpha <= 8 the
matrices are exact small rationals and the float64 computation is exact
to ~1e-12, verified in tests against the reference convolution.

This recovers the classical F(2,3), F(4,3) matrices (up to row scaling)
and extends uniformly to the paper's K = 5 variants (F(2,5), F(4,5)).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

__all__ = ["winograd_matrices", "GOOD_POINTS"]

#: well-conditioned interpolation points, consumed in order
GOOD_POINTS = [0.0, 1.0, -1.0, 2.0, -2.0, 0.5, -0.5, 4.0, -4.0, 0.25, -0.25]


@functools.lru_cache(maxsize=None)
def winograd_matrices(m: int, r: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (A, G, Bt) for F(m, r).

    A:  (alpha, m)   output transform (use A.T)
    G:  (alpha, r)   kernel transform
    Bt: (alpha, alpha) input transform  (this IS B^T)
    """
    alpha = m + r - 1
    pts = GOOD_POINTS[: alpha - 1]
    if len(pts) < alpha - 1:
        raise ValueError(f"F({m},{r}): need {alpha - 1} points")

    # V: evaluation of a degree-(alpha-1) polynomial at pts + infinity
    V = np.zeros((alpha, alpha))
    for i, a in enumerate(pts):
        V[i] = [a ** j for j in range(alpha)]
    V[alpha - 1, alpha - 1] = 1.0  # infinity row = leading coefficient

    X = V[:, :m].copy()   # evaluation of deg m-1 poly (note inf row: e_{m-1}
    Y = V[:, :r].copy()   # only if m == alpha which never holds; fix below)
    # the infinity "evaluation" of a degree-(m-1) polynomial is its own
    # leading coefficient:
    X[alpha - 1, :] = 0.0
    X[alpha - 1, m - 1] = 1.0
    Y[alpha - 1, :] = 0.0
    Y[alpha - 1, r - 1] = 1.0

    Bt = np.linalg.inv(V).T
    return X, Y, Bt
