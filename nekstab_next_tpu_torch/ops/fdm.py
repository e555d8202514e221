"""Tensor-product fast-diagonalization (FDM) setup and the Q1 coarse level.

Numpy copy of ``nekstab_next_tpu/ops/fdm.py``.  Each deformed spectral
element is approximated by an axis-aligned box with the element's mean
parametric half-lengths (a, b[, c]); on the box the weak Helmholtz operator
h1*K + h2*B separates, in 2-D:

    h1 [ (b/a) A (x) B  +  (a/b) B (x) A ]  +  h2 (a b) B (x) B

With the generalized eigendecomposition  A1 S = B1 S Lam,  S^T B1 S = I  of
the 1-D stiffness/mass pair on [-1,1], the box operator diagonalizes in the
S-basis (``SEM.fdm_apply``, ``SEM3.fdm_apply``).  All setup is host-side
numpy/scipy, once per mesh, and must stay bit-identical to the JAX
package's copy.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from ..mesh.gll import diff_matrix, gll_points_weights


def fdm_eigensetup(n: int):
    """Generalized eigendecomposition of the 1-D GLL stiffness/mass pair.

    Returns (S, lam) with  A1 S = B1 S diag(lam),  S^T B1 S = I,  lam >= 0
    ascending (lam[0] = 0 is the Neumann constant mode).
    """
    _, w = gll_points_weights(n)
    D = diff_matrix(n)
    B1 = np.diag(w)
    A1 = D.T @ B1 @ D
    A1 = 0.5 * (A1 + A1.T)
    lam, S = scipy.linalg.eigh(A1, B1)
    lam = np.maximum(lam, 0.0)
    return S, lam


def element_half_lengths_2d(mesh) -> np.ndarray:
    """Mean parametric half-lengths (a, b) per element, shape (nelem, 2).

    The forward derivatives are recovered from the stored inverse metrics:
    x_r = jac*sy, y_r = -jac*sx, x_s = -jac*ry, y_s = jac*rx  (mesh.py stores
    rx = d(xi)/dx etc. and jac = det(dx/d(xi)))."""
    x_r = mesh.jac * mesh.sy
    y_r = -mesh.jac * mesh.sx
    x_s = -mesh.jac * mesh.ry
    y_s = mesh.jac * mesh.rx
    hr = np.sqrt(x_r**2 + y_r**2).mean(axis=(1, 2))
    hs = np.sqrt(x_s**2 + y_s**2).mean(axis=(1, 2))
    return np.stack([hr, hs], axis=1)


def coarse_setup(gid: np.ndarray, g_metrics, D: np.ndarray, z: np.ndarray,
                 mask: np.ndarray):
    """Q1 vertex coarse level for the pressure two-level preconditioner
    (the stand-in for Nek5000's XXT coarse solve), 2-D and 3-D.

    Parameters
    ----------
    gid   : (nelem, n, n) or (nelem, n, n, n) global node ids
    g_metrics : weighted metric tensors — 2-D: (g11, g12, g22);
            3-D: (g11, g12, g13, g22, g23, g33)
    D     : (n, n) GLL differentiation matrix
    z     : (n,) GLL points on [-1, 1]
    mask  : (nelem, n, n[, n]) 1 = free dof, 0 = Dirichlet

    Returns (cid, Jc, Acinv):
    cid   : (nelem, nverts) compact coarse ids of the element vertices
    Jc    : (nverts, n, n[, n]) Q1 hat-function values at GLL nodes
    Acinv : (ncoarse, ncoarse) dense (pseudo-)inverse of the assembled coarse
            stiffness, with Dirichlet coarse dofs zeroed
    """
    ndim = gid.ndim - 1
    n = gid.shape[1]
    nelem = gid.shape[0]
    h0 = (1.0 - z) / 2.0
    h1 = (1.0 + z) / 2.0
    hats = [h0, h1]

    if ndim == 2:
        corner_idx = [(ci, cj) for ci in (0, 1) for cj in (0, 1)]
        Jc = np.stack([np.outer(hats[ci], hats[cj]) for ci, cj in corner_idx])
        corners = gid[:, [0, n - 1]][:, :, [0, n - 1]].reshape(nelem, 4)
        g11, g12, g22 = g_metrics
        ur = np.einsum("ai,cij->caj", D, Jc)
        us = np.einsum("bj,cij->cib", D, Jc)
        wr = g11[:, None] * ur[None] + g12[:, None] * us[None]
        ws = g12[:, None] * ur[None] + g22[:, None] * us[None]
        k_e = np.einsum("aij,ebij->eab", ur, wr) + np.einsum(
            "aij,ebij->eab", us, ws
        )
        mask_c = mask[:, [0, n - 1]][:, :, [0, n - 1]].reshape(nelem, 4)
    else:
        corner_idx = [
            (ci, cj, ck) for ci in (0, 1) for cj in (0, 1) for ck in (0, 1)
        ]
        Jc = np.stack(
            [
                hats[ci][:, None, None]
                * hats[cj][None, :, None]
                * hats[ck][None, None, :]
                for ci, cj, ck in corner_idx
            ]
        )
        corners = (
            gid[:, [0, n - 1]][:, :, [0, n - 1]][:, :, :, [0, n - 1]]
        ).reshape(nelem, 8)
        g11, g12, g13, g22, g23, g33 = g_metrics
        ur = np.einsum("ai,cijk->cajk", D, Jc)
        us = np.einsum("bj,cijk->cibk", D, Jc)
        ut = np.einsum("km,cijm->cijk", D, Jc)
        wr = g11[:, None] * ur[None] + g12[:, None] * us[None] + g13[:, None] * ut[None]
        ws = g12[:, None] * ur[None] + g22[:, None] * us[None] + g23[:, None] * ut[None]
        wt = g13[:, None] * ur[None] + g23[:, None] * us[None] + g33[:, None] * ut[None]
        k_e = (
            np.einsum("aijk,ebijk->eab", ur, wr)
            + np.einsum("aijk,ebijk->eab", us, ws)
            + np.einsum("aijk,ebijk->eab", ut, wt)
        )
        mask_c = (
            mask[:, [0, n - 1]][:, :, [0, n - 1]][:, :, :, [0, n - 1]]
        ).reshape(nelem, 8)

    # compact coarse numbering of the element vertices
    uniq, cid_flat = np.unique(corners.reshape(-1), return_inverse=True)
    nc = uniq.size
    cid = cid_flat.reshape(corners.shape).astype(np.int32)

    Ac = np.zeros((nc, nc))
    np.add.at(
        Ac,
        (cid[:, :, None].repeat(cid.shape[1], 2), cid[:, None, :].repeat(cid.shape[1], 1)),
        k_e,
    )

    free = np.ones(nc, dtype=bool)
    np.logical_and.at(free, cid.reshape(-1), mask_c.reshape(-1) > 0.5)

    Acinv = np.zeros((nc, nc))
    if free.any():
        Aff = Ac[np.ix_(free, free)]
        # pure-Neumann coarse operator is singular (constant mode) -> pinv
        if free.all():
            Aff_inv = np.linalg.pinv(Aff, rcond=1e-10)
        else:
            Aff_inv = np.linalg.inv(Aff)
        Acinv[np.ix_(free, free)] = Aff_inv
    return cid, Jc, Acinv


def element_half_lengths_3d(mesh) -> np.ndarray:
    """Mean parametric half-lengths (a, b, c) per element, shape (nelem, 3)."""
    A = np.stack(
        [
            np.stack([mesh.drdx, mesh.drdy, mesh.drdz], axis=-1),
            np.stack([mesh.dsdx, mesh.dsdy, mesh.dsdz], axis=-1),
            np.stack([mesh.dtdx, mesh.dtdy, mesh.dtdz], axis=-1),
        ],
        axis=-2,
    )  # (..., 3, 3) rows = d(r,s,t)/d(x,y,z)
    F = np.linalg.inv(A)  # columns of F are dx/dr, dx/ds, dx/dt
    h = np.linalg.norm(F, axis=-2)  # (..., 3) lengths of the three columns
    return h.mean(axis=tuple(range(1, h.ndim - 1)))
