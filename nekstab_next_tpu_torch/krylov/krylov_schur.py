"""Krylov-Schur eigensolver on a matrix-free operator (port of
``nekstab_next_tpu/krylov/krylov_schur.py``).

k-step Arnoldi, Ritz residuals from the rank-one remainder, and
Schur-condensation restarts that keep the cluster |mu| >= 1 - schur_del (at
least nev + 4 vectors, conjugate pairs intact).  The host orchestrates the
k_dim-sized dense work (scipy); the device does the matvec, the batched
orthogonalization and the basis rotation Q Z (one tensordot).

``checkpoint`` (``io.checkpoint.ArnoldiCheckpoint``) persists the basis and
the Hessenberg after every restart and resumes a fresh call from the last
saved one; ``checkpoint_steps`` also persists every Arnoldi column as it
is produced, so a run stopped mid-factorization resumes at its last
matvec.  The files are the JAX package's: either package resumes the
other's."""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

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
    Ritz analysis always run at least once.

    ``checkpoint``: the (basis, H) pair persists after every restart and a
    fresh call resumes from the last saved restart.  ``checkpoint_steps``:
    every Arnoldi column and the Hessenberg persist as they are produced,
    and a fresh call resumes at the last completed matvec (only a run that
    opted into step checkpointing adopts step files)."""
    basis = Basis(space, x0, capacity=k_dim + 1)
    q0, _ = space.normalize(x0)
    basis.set(0, q0)
    H = np.zeros((k_dim + 1, k_dim))
    m = 0  # number of columns kept from restarts
    nmv = 0
    history: List[dict] = []
    host = lambda x: [leaf.detach().cpu().numpy() for leaf in tree_leaves(x)]

    if checkpoint is not None:
        saved = checkpoint.load()
        if saved is not None:
            leaves, Hs, m, _meta = saved
            for B, leaf in zip(tree_leaves(basis.Q), leaves):
                B.copy_(torch.as_tensor(leaf, dtype=B.dtype, device=B.device))
            H[:] = Hs
        # per-step columns extend past the last restart bundle (cleared at
        # each restart, so whatever is on disk postdates it); stale step
        # files of an earlier stepped run must not leak into a bundle-only
        # resume
        stepsave = checkpoint.load_columns() if checkpoint_steps else None
        if stepsave is not None:
            cols, Hc, ncols, _smeta = stepsave
            if ncols > m and all(j in cols for j in range(m, ncols + 1)):
                tleaves, spec = tree_flatten(basis.get(0))
                for j, lv in cols.items():
                    basis.set(j, tree_unflatten(
                        [torch.as_tensor(leaf, dtype=t.dtype, device=t.device)
                         for leaf, t in zip(lv, tleaves)], spec))
                H[:] = Hc
                m = ncols

    def save_column(j: int, restart: int) -> None:
        if checkpoint is not None and checkpoint_steps:
            checkpoint.save_column(j, host(basis.get(j)), H, j, restart=restart,
                                   n_matvecs=nmv)

    save_column(m, 0)  # the seed (or the resumed head) column

    for restart in range(max_restarts + 1):
        for j in range(m, k_dim):
            beta = arnoldi_step(matvec, space, basis, H, j)
            nmv += 1
            save_column(j + 1, restart)
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

        if checkpoint is not None:
            checkpoint.save(host(basis.Q), H, m, restart=restart, n_matvecs=nmv)
            # the rotation rewrote every column: step files are stale
            checkpoint.clear_columns()
            save_column(m, restart + 1)

    return EigenResult(vals, res, vecs, basis, H, k_dim, ncv, nmv, history)
