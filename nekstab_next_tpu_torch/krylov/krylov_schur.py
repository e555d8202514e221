"""Krylov-Schur eigensolver on a matrix-free operator (port of
``nekstab_next_tpu/krylov/krylov_schur.py``).

k-step Arnoldi, Ritz residuals from the rank-one remainder, and
Schur-condensation restarts that keep the cluster |mu| >= 1 - schur_del (at
least nev + 4 vectors, conjugate pairs intact).  The host orchestrates the
k_dim-sized dense work (scipy); the device does the matvec, the batched
orthogonalization and the basis rotation Q Z (one tensordot).

Not ported: the ``checkpoint``/``checkpoint_steps`` resume (ROADMAP item
16); passing either raises."""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from .arnoldi import arnoldi_step
from .dense import eig_sorted, schur_select
from .vector import Basis, VectorSpace


@dataclasses.dataclass
class EigenResult:
    eigenvalues: np.ndarray  # complex, sorted by decreasing |mu|
    residuals: np.ndarray  # Ritz residual per eigenvalue
    eigvecs_H: np.ndarray  # (k, k) complex Ritz vectors in the H basis
    basis: Basis
    H: np.ndarray
    k: int  # active Krylov dimension at exit
    n_converged: int
    n_matvecs: int
    history: List[dict]

    def mode(self, i: int):
        """Ritz vector i as a (real_part, imag_part) pair: Phi = Q y."""
        y = np.zeros(self.basis.capacity, dtype=np.complex128)
        y[: self.k] = self.eigvecs_H[: self.k, i]
        return self.basis.combine(y.real.copy()), self.basis.combine(y.imag.copy())

    def orthonormality_audit(self, space: VectorSpace, ncols: Optional[int] = None) -> float:
        """max |<q_i, q_j> - delta_ij| over the first ``ncols`` (default k)
        basis columns; one batched row of dots per column."""
        k = self.k if ncols is None else ncols
        G = np.stack([self.basis.dots(self.basis.get(i), k)[:k].double().cpu().numpy()
                      for i in range(k)])
        return float(np.max(np.abs(G - np.eye(k))))


def eigs(
    matvec: Callable,
    space: VectorSpace,
    x0,
    k_dim: int = 100,
    nev: int = 2,
    tol: float = 1e-6,
    schur_del: float = 0.10,
    max_restarts: int = 50,
    callback: Optional[Callable] = None,
    checkpoint=None,
    checkpoint_steps: bool = False,
) -> EigenResult:
    """Leading eigenpairs of the (propagator) operator ``matvec``.

    ``x0`` is the seed vector (tensor or pytree).  Convergence: Ritz
    residual |beta e_k^T y_i| < tol for the ``nev`` leading pairs.
    ``max_restarts`` counts Schur condensations; the factorization and its
    Ritz analysis always run at least once."""
    if checkpoint is not None or checkpoint_steps:
        raise NotImplementedError(
            "not ported: eigs checkpoint/checkpoint_steps resume (ROADMAP item 16)"
        )
    basis = Basis(space, x0, capacity=k_dim + 1)
    q0, _ = space.normalize(x0)
    basis.set(0, q0)
    H = np.zeros((k_dim + 1, k_dim))
    m = 0  # number of columns kept from restarts
    nmv = 0
    history: List[dict] = []

    for restart in range(max_restarts + 1):
        for j in range(m, k_dim):
            beta = arnoldi_step(matvec, space, basis, H, j)
            nmv += 1
            if callback is not None:
                callback(restart, j, beta)
            if beta <= 1e-12:
                break

        Hk = H[:k_dim, :k_dim]
        beta = H[k_dim, k_dim - 1]
        vals, vecs = eig_sorted(Hk)
        # rank-one remainder: A Q - Q H = q_{k+1} * beta * e_k^T
        res = np.abs(beta * vecs[k_dim - 1, :])
        ncv = int(np.sum(res[:nev] < tol)) if len(res) >= nev else 0
        history.append(
            dict(restart=restart, n_converged=int(np.sum(res < tol)),
                 leading=vals[: max(nev, 4)].copy(), residuals=res[: max(nev, 4)].copy())
        )
        if np.all(res[:nev] < tol):
            return EigenResult(vals, res, vecs, basis, H, k_dim, nev, nmv, history)
        if restart == max_restarts:
            break

        # ---- Schur condensation restart ------------------------------
        def select(lams: np.ndarray) -> np.ndarray:
            keep = np.abs(lams) >= 1.0 - schur_del
            need = min(max(int(keep.sum()), nev + 4), k_dim - 2)
            order = np.argsort(-np.abs(lams))
            mask = np.zeros(len(lams), dtype=bool)
            mask[order[:need]] = True
            return mask

        T, Z, m = schur_select(Hk, select)
        # rotate the basis: new q_0..q_{m-1} = Q Z[:, :m]; q_m = old q_k
        qk = space.scale(1.0, basis.get(k_dim))  # a copy: rotate overwrites
        V = np.zeros((k_dim + 1, m))
        V[:k_dim, :] = Z[:, :m]
        basis.rotate(V)
        basis.set(m, qk)
        # new H: leading block T_m, residual row beta * Z[k-1, :m]
        H[:] = 0.0
        H[:m, :m] = T[:m, :m]
        H[m, :m] = beta * Z[k_dim - 1, :m]

    return EigenResult(vals, res, vecs, basis, H, k_dim, ncv, nmv, history)
