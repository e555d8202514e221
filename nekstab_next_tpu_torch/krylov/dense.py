"""Host-side dense linear algebra on the k_dim-sized projected problems.

A numpy/scipy copy of ``nekstab_next_tpu/krylov/dense.py`` (that module
imports no JAX, but importing anything of the JAX package runs its
``__init__``, which does).  Mirrors the reference's split: the
Hessenberg-scale eig/Schur/lstsq stays on host LAPACK
(core/lapack_wrapper.f90 -> dgeev/dgees/dtrsen/dgels); here that is
scipy.linalg on host numpy arrays."""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import scipy.linalg as sla


def eig_sorted(H: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Eigenpairs of a (real) dense matrix sorted by decreasing magnitude
    (reference lapack_wrapper.f90:114-228 ``eig`` + ``sort_eigendecomp``)."""
    vals, vecs = sla.eig(H)
    order = np.argsort(-np.abs(vals))
    return vals[order], vecs[:, order]


def schur_select(
    H: np.ndarray, select: Callable[[np.ndarray], np.ndarray]
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Real Schur form of H with the selected cluster ordered first.

    Returns (T, Z, m) with m the size of the leading cluster; conjugate pairs
    are never split (scipy handles this, as dtrsen does for the reference —
    lapack_wrapper.f90:59-111)."""
    T, Z = sla.schur(H, output="real")
    vals = sla.eigvals(T)
    mask = select(vals)
    # complete conjugate pairs (reference select_eigenvalues,
    # eigensolvers.f90:688-756 keeps pairs together)
    T, Z, m = _ordschur(T, Z, mask)
    return T, Z, m


def _ordschur(T: np.ndarray, Z: np.ndarray, mask: np.ndarray):
    """Reorder a real Schur factorization so eigenvalues flagged in ``mask``
    lead.  Uses LAPACK dtrsen via scipy when available."""
    k = T.shape[0]
    # pair completion: if one of a 2x2 block is selected, select both
    i = 0
    mask = mask.copy()
    while i < k - 1:
        if abs(T[i + 1, i]) > 0.0:
            if mask[i] or mask[i + 1]:
                mask[i] = mask[i + 1] = True
            i += 2
        else:
            i += 1
    try:
        trsen = sla.get_lapack_funcs(("trsen",), (T,))[0]
        result = trsen(mask.astype(np.int32), T, Z, job="N")
        T2, Z2 = result[0], result[1]
        m = int(mask.sum())
        return T2, Z2, m
    except Exception:
        # fallback: swap adjacent blocks with trexc
        trexc = sla.get_lapack_funcs(("trexc",), (T,))[0]
        Tc, Zc = T.copy(), Z.copy()
        sel = list(np.where(mask)[0])
        target = 0
        for src in sel:
            if src != target:
                Tc, Zc, info = trexc(Tc, Zc, src + 1, target + 1, compq="V")
            target += 1
        return Tc, Zc, int(mask.sum())


def lstsq(H: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Least-squares solve (GMRES projected problem; reference
    lapack_wrapper.f90:248-300 -> dgels)."""
    y, *_ = sla.lstsq(H, b)
    return y


def log_map(mu: np.ndarray, T: float) -> np.ndarray:
    """Map propagator eigenvalues to NS-plane rates: lambda = log(mu)/T
    (reference eigensolvers.f90:860-869)."""
    return np.log(mu.astype(np.complex128)) / T
