"""Restarted GMRES on a matrix-free operator with the weighted inner product
(port of ``nekstab_next_tpu/krylov/gmres.py``): per-restart Arnoldi
factorization, host least squares on the projected (k+1, k) Hessenberg,
the solution update as one basis combination."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .arnoldi import arnoldi_step
from .dense import lstsq
from .vector import Basis, VectorSpace


def gmres(
    matvec: Callable,
    space: VectorSpace,
    b,
    x0=None,
    k_dim: int = 64,
    tol: float = 1e-8,
    max_restarts: int = 100,
    callback: Optional[Callable] = None,
):
    """Solve A x = b.  Returns (x, info dict)."""
    x = space.zeros_like(b) if x0 is None else x0
    bnorm = float(space.norm(b))
    if bnorm == 0.0:
        return x, dict(converged=True, residual=0.0, iterations=0)
    nmv = 0
    residual = np.inf

    for restart in range(max_restarts):
        if x0 is None and restart == 0:
            r = b
        else:
            r = space.sub(b, matvec(x))
            nmv += 1
        beta = float(space.norm(r))
        residual = beta / bnorm
        if residual < tol:
            return x, dict(converged=True, residual=residual, iterations=nmv)

        basis = Basis(space, b, capacity=k_dim + 1)
        basis.set(0, space.scale(1.0 / beta, r))
        H = np.zeros((k_dim + 1, k_dim))
        k_used = k_dim
        for j in range(k_dim):
            hb = arnoldi_step(matvec, space, basis, H, j)
            nmv += 1
            # residual of the projected least-squares problem so far
            e1 = np.zeros(j + 2)
            e1[0] = beta
            y = lstsq(H[: j + 2, : j + 1], e1)
            rj = np.linalg.norm(e1 - H[: j + 2, : j + 1] @ y) / bnorm
            if callback is not None:
                callback(restart, j, rj)
            if rj < tol or hb <= 1e-12:
                k_used = j + 1
                break

        e1 = np.zeros(k_used + 1)
        e1[0] = beta
        y = lstsq(H[: k_used + 1, :k_used], e1)
        yfull = np.zeros(basis.capacity)
        yfull[:k_used] = y
        x = space.add(x, basis.combine(yfull))
        residual = float(np.linalg.norm(e1 - H[: k_used + 1, :k_used] @ y)) / bnorm
        if residual < tol:
            return x, dict(converged=True, residual=residual, iterations=nmv)

    return x, dict(converged=False, residual=residual, iterations=nmv)
