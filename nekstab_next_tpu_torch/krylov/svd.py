"""Singular triplets of a matrix-free operator (port of
``nekstab_next_tpu/krylov/svd.py``).

* :func:`svds`: Golub-Kahan-Lanczos bidiagonalization with full
  reorthogonalization and Baglama-Reichel thick restarts.  It works with A
  and A' (one of each per step), so the singular values carry the
  conditioning of A, not of A'A.
* :func:`svds_normal`: Krylov-Schur on the normal operator A'A (the
  reference code's transient-growth route), kept as a cross-check.

Both keep their bases as :class:`~.vector.Basis` (one stacked tensor per
leaf); the small bidiagonal and its SVD stay on the host (numpy).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from ..utils import tracing
from .arnoldi import orthogonalize
from .krylov_schur import eigs
from .vector import Basis, VectorSpace


@dataclasses.dataclass
class SVDResult:
    sigma: np.ndarray  # singular values (descending)
    residuals: np.ndarray
    right: List  # right singular vectors v_i
    left: List  # left singular vectors u_i = A v_i / sigma_i
    n_matvecs: int


@tracing.spanned("krylov.svds")
def svds(
    direct: Callable,
    adjoint: Callable,
    space: VectorSpace,
    x0,
    nsv: int = 2,
    k_dim: int = 64,
    tol: float = 1e-6,
    max_restarts: int = 30,
) -> SVDResult:
    """Leading singular triplets of A by thick-restarted Golub-Kahan.

    Recurrence (upper-bidiagonal B: B[j,j] = alpha_j, B[j,j+1] = beta_j):

        p = A v_j - beta_{j-1} u_{j-1};   alpha_j u_j = p
        s = A' u_j - alpha_j v_j;         beta_j v_{j+1} = s

    giving  A V_k = U_k B_k  and  A' U_k = V_k B_k' + beta_k v_{k+1} e_k'.
    With B_k = P S Q' the triplet residual is ||A' u~_i - s_i v~_i|| =
    beta_k |P[k-1, i]|, the convergence test.  A thick restart keeps the
    first ``nsv + 4`` triplets plus the residual direction v_{k+1}; the
    augmented column is B[i, l] = beta_k P[k-1, i] exactly (no extra
    matvecs)."""
    V = Basis(space, x0, capacity=k_dim + 1)
    U: Optional[Basis] = None  # template comes from the first A v
    B = np.zeros((k_dim, k_dim + 1))
    v0, _ = space.normalize(x0)
    V.set(0, v0)
    nmv = 0
    m = 0  # columns carried over from the restart
    aug: Optional[np.ndarray] = None  # beta_k * rho of the restart column

    for restart in range(max_restarts + 1):
        for j in range(m, k_dim):
            p = direct(V.get(j))
            nmv += 1
            if U is None:
                U = Basis(space, p, capacity=k_dim + 1)
            # subtract the known U components: beta_{j-1} u_{j-1}, or the
            # augmented column after a restart; full reorthogonalization
            # mops up the rest
            with tracing.span("krylov.ortho"):
                p, h = orthogonalize(space, U, p, ncols=j)
                h = h.double().cpu().numpy()
                alpha = float(space.norm(p))
            if alpha <= 1e-300:
                alpha = 0.0
            else:
                U.set(j, space.scale(1.0 / alpha, p))
            if j == m and aug is not None:
                B[: len(aug), j] = h[: len(aug)]
            elif j > 0:
                B[j - 1, j] = h[j - 1]
            B[j, j] = alpha

            s = adjoint(U.get(j))
            nmv += 1
            with tracing.span("krylov.ortho"):
                s, _ = orthogonalize(space, V, s, ncols=j + 1)
                beta = float(space.norm(s))
            B[j, j + 1] = beta
            if beta <= 1e-300:
                break
            V.set(j + 1, space.scale(1.0 / beta, s))

        Bk = B[:k_dim, :k_dim]
        beta_k = B[k_dim - 1, k_dim]
        P, S, Qt = np.linalg.svd(Bk)
        res = beta_k * np.abs(P[k_dim - 1, :])
        conv = res[:nsv] <= tol * np.maximum(S[:nsv], 1.0)
        if np.all(conv) or restart == max_restarts:
            break

        # ---- thick restart ------------------------------------------
        keep = min(nsv + 4, k_dim - 2)
        # V <- [V_k Q_keep | v_{k+1}], U <- U_k P_keep
        W = np.zeros((k_dim + 1, keep + 1))
        W[:k_dim, :keep] = Qt.T[:, :keep]
        W[k_dim, keep] = 1.0
        V.rotate(W)
        Pk = np.zeros((k_dim + 1, keep))
        Pk[:k_dim, :] = P[:, :keep]
        U.rotate(Pk)
        B[:] = 0.0
        B[np.arange(keep), np.arange(keep)] = S[:keep]
        aug = beta_k * P[k_dim - 1, :keep]
        B[:keep, keep] = aug
        m = keep

    sigma = S[:nsv]
    right, left = [], []
    for i in range(nsv):
        yv = np.zeros(k_dim + 1)
        yv[:k_dim] = Qt.T[:, i]
        yu = np.zeros(k_dim + 1)
        yu[:k_dim] = P[:, i]
        right.append(V.combine(yv))
        left.append(U.combine(yu))
    return SVDResult(
        sigma=np.asarray(sigma),
        residuals=np.asarray(res[:nsv]),
        right=right,
        left=left,
        n_matvecs=nmv,
    )


def svds_normal(
    direct: Callable,
    adjoint: Callable,
    space: VectorSpace,
    x0,
    nsv: int = 2,
    k_dim: int = 64,
    tol: float = 1e-6,
    max_restarts: int = 30,
) -> SVDResult:
    """Leading singular triplets via Krylov-Schur on A'A (conditioning goes
    as sigma^2: prefer :func:`svds`)."""

    def normal_op(v):
        return adjoint(direct(v))

    res = eigs(
        normal_op, space, x0, k_dim=k_dim, nev=nsv, tol=tol,
        max_restarts=max_restarts,
    )
    lam = np.real(res.eigenvalues[:nsv])
    sigma = np.sqrt(np.maximum(lam, 0.0))
    right, left = [], []
    for i in range(nsv):
        re, _ = res.mode(i)  # symmetric operator: real eigenvectors
        v, _ = space.normalize(re)
        u = space.scale(1.0 / max(sigma[i], 1e-300), direct(v))
        right.append(v)
        left.append(u)
    return SVDResult(
        sigma=sigma,
        residuals=res.residuals[:nsv],
        right=right,
        left=left,
        n_matvecs=res.n_matvecs * 2 + 2 * nsv,
    )
