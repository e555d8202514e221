"""Arnoldi factorization with classical Gram-Schmidt and one full
re-orthogonalization pass (port of ``nekstab_next_tpu/krylov/arnoldi.py``).

Classical (not modified) Gram-Schmidt is chosen deliberately: all k dot
products of a pass batch into one reduction (``Basis.ortho_insert``), so an
Arnoldi step costs a fixed handful of device calls whatever k is.  The
Hessenberg matrix stays on the host (numpy)."""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..utils import tracing
from .vector import Basis, VectorSpace


def orthogonalize(space: VectorSpace, basis: Basis, w, ncols: int, reorth: int = 1):
    """CGS + ``reorth`` re-orthogonalization passes of ``w`` against the first
    ``ncols`` basis columns.  Returns (w_orth, h) with h the accumulated
    projection coefficients (length = capacity, zero beyond ncols)."""
    h = basis.dots(w, ncols)
    w = space.sub(w, basis.combine(h))
    for _ in range(reorth):
        c = basis.dots(w, ncols)
        w = space.sub(w, basis.combine(c))
        h = h + c
    return w, h


def arnoldi_step(
    matvec: Callable,
    space: VectorSpace,
    basis: Basis,
    H: np.ndarray,
    j: int,
) -> float:
    """Extend an Arnoldi factorization by one column: w = A q_j, orthogonalize
    against q_0..q_j, normalize into q_{j+1}.  Updates H[:, j] in place
    (host numpy).  Returns the residual norm H[j+1, j]; the column written
    on breakdown (beta ~ 0) is never read, callers stop there."""
    w = matvec(basis.get(j))
    with tracing.span("krylov.ortho"):
        h, beta = basis.ortho_insert(w, j)
        beta = float(beta)
        H[: basis.capacity, j] = h.double().cpu().numpy()
        H[j + 1, j] = beta
    return beta


def arnoldi_factorization(
    matvec: Callable,
    space: VectorSpace,
    basis: Basis,
    H: np.ndarray,
    j_start: int,
    j_end: int,
    callback: Callable = None,
) -> np.ndarray:
    """Run Arnoldi steps j_start..j_end-1.  ``basis`` must hold an
    orthonormal q_0..q_{j_start} set already."""
    for j in range(j_start, j_end):
        beta = arnoldi_step(matvec, space, basis, H, j)
        if callback is not None:
            callback(j, beta)
        if beta <= 1e-12:
            break  # invariant subspace found
    return H
