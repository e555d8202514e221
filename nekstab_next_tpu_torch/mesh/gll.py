"""Gauss-Lobatto-Legendre quadrature and spectral differentiation.

Numpy copy of ``nekstab_next_tpu/mesh/gll.py`` (the JAX package's
``__init__`` imports jax, so the port cannot import it).  Everything here is
built host-side in float64 numpy once per run and must stay bit-identical to
the JAX package's copy: the port's tests compare both.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def gll_points_weights(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Return the ``n`` GLL points and quadrature weights on [-1, 1].

    Newton iteration on the derivative of the Legendre polynomial P'_{n-1},
    with Chebyshev-Gauss-Lobatto initial guesses (standard algorithm).
    """
    if n < 2:
        raise ValueError("need at least 2 GLL points")
    p = n - 1  # polynomial order
    # initial guess: Chebyshev-Gauss-Lobatto nodes
    x = np.cos(np.pi * np.arange(n) / p)[::-1].copy()
    P = np.zeros((n, n))  # Legendre Vandermonde P[:, k] = P_k(x)
    x_old = np.full(n, 2.0)
    while np.max(np.abs(x - x_old)) > 1e-15:
        x_old = x.copy()
        P[:, 0] = 1.0
        P[:, 1] = x
        for k in range(2, n):
            P[:, k] = ((2 * k - 1) * x * P[:, k - 1] - (k - 1) * P[:, k - 2]) / k
        # Newton update for roots of (1-x^2) P'_p(x)
        x = x_old - (x * P[:, p] - P[:, p - 1]) / (n * P[:, p])
    P[:, 0] = 1.0
    P[:, 1] = x
    for k in range(2, n):
        P[:, k] = ((2 * k - 1) * x * P[:, k - 1] - (k - 1) * P[:, k - 2]) / k
    w = 2.0 / (p * n * P[:, p] ** 2)
    x[0], x[-1] = -1.0, 1.0
    return x, w


@functools.lru_cache(maxsize=None)
def diff_matrix(n: int) -> np.ndarray:
    """Spectral differentiation matrix D on the n GLL points.

    (D u)_i = u'(x_i) for u in P_{n-1}; built from barycentric weights.
    """
    x, _ = gll_points_weights(n)
    # barycentric weights
    c = np.ones(n)
    for i in range(n):
        for j in range(n):
            if i != j:
                c[i] *= x[i] - x[j]
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                D[i, j] = c[i] / (c[j] * (x[i] - x[j]))
    D[np.arange(n), np.arange(n)] = -D.sum(axis=1)
    return D


def lagrange_interp_matrix(x_from: np.ndarray, x_to: np.ndarray) -> np.ndarray:
    """Interpolation matrix from nodal values at ``x_from`` to points ``x_to``.

    Used for over-integration (dealiasing: GLL -> Gauss fine grid, the
    reference's Nek ``lxd = 3/2 lx1`` rule) and for mode output on plot grids.
    """
    x_from = np.asarray(x_from, dtype=np.float64)
    x_to = np.asarray(x_to, dtype=np.float64)
    n = len(x_from)
    # barycentric weights
    c = np.ones(n)
    for i in range(n):
        for j in range(n):
            if i != j:
                c[i] *= x_from[i] - x_from[j]
    w = 1.0 / c
    J = np.zeros((len(x_to), n))
    for k, xt in enumerate(x_to):
        diff = xt - x_from
        hit = np.isclose(diff, 0.0, atol=1e-14)
        if hit.any():
            J[k, np.argmax(hit)] = 1.0
        else:
            terms = w / diff
            J[k, :] = terms / terms.sum()
    return J


@functools.lru_cache(maxsize=None)
def gauss_points_weights(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre points/weights (dealiasing grid, Nek's ``zwgl``)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x, w
