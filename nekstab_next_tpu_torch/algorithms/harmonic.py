"""Floquet-preconditioned harmonic resolvent (port of
``nekstab_next_tpu/algorithms/harmonic.py``: ``SpectralPreconditioner``,
``preconditioned_gmres``, ``HarmonicResolventResult`` and
``harmonic_resolvent_analysis``).

For a periodic (or steady) base flow with monodromy M = exp(T L), the
harmonic-resolvent / forced-response solve is the periodicity system

    (I - M) x = b,    b = the forced tangent equations' particular solution.

``I - M`` is nearly singular whenever Floquet multipliers mu_r sit close to
+1.  The spectral preconditioner built from the leading direct modes
``v_r`` and the biorthogonalized adjoint modes ``w_r``
(<w_r, v_s>_B = delta_rs),

    P^{-1} = I + sum_r  mu_r / (1 - mu_r) * v_r <w_r, .>_B,

applies the exact inverse of (I - M) on span{v_r} and the identity off it,
so GMRES only handles the well-conditioned rest of the spectrum.  Built
from direct/adjoint Krylov-Schur (``algorithms/stability.py``),
``biorthogonalize`` (``postproc/sensitivity.py``), the forced tangent
integration (``algorithms/resolvent.py``) and right-preconditioned
restarted GMRES."""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..krylov.gmres import gmres
from ..krylov.vector import VectorSpace
from ..postproc.sensitivity import _cdot, biorthogonalize
from ..stepper.navier_stokes import NavierStokes
from .resolvent import FloquetResolventOperator, ResolventOperator
from .stability import linear_stability_analysis, velocity_space


class SpectralPreconditioner:
    """P^{-1} = I + sum_r kappa_r v_r <w_r, .>_B  on real velocity fields.

    ``modes``: list of (mu, (v_re, v_im), (w_re, w_im)) triples, one entry
    per eigenvalue; complex-conjugate partners must NOT be listed (taking
    2 Re(.) of a genuinely complex contribution accounts for them)."""

    def __init__(self, sem, modes: Sequence[Tuple[complex, Tuple, Tuple]],
                 pair_tol: float = 1e-10):
        self.sem = sem
        self.terms = []
        for mu, (v_re, v_im), (w_re, w_im) in modes:
            mu = complex(mu)
            kappa = mu / (1.0 - mu)
            # biorthonormalize: <w, v>_B = 1
            d_re, d_im, a_re, a_im = biorthogonalize(sem, v_re, v_im, w_re, w_im)
            factor = 1.0 if abs(mu.imag) <= pair_tol else 2.0
            self.terms.append((kappa, factor, (d_re, d_im), (a_re, a_im)))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        sem = self.sem
        out = x
        zero = torch.zeros_like(x)
        for kappa, factor, (v_re, v_im), (w_re, w_im) in self.terms:
            # c = <w, x>_B  (x real)
            c_re, c_im = _cdot(sem, w_re, w_im, x, zero)
            # Re(kappa * c * v); factor 2 folds in the conjugate partner
            a = kappa.real * c_re - kappa.imag * c_im
            b = kappa.real * c_im + kappa.imag * c_re
            out = out + factor * (a * v_re - b * v_im)
        return out


def preconditioned_gmres(
    matvec: Callable,
    space: VectorSpace,
    b,
    precond: Callable,
    k_dim: int = 40,
    tol: float = 1e-8,
    max_restarts: int = 40,
):
    """Right-preconditioned GMRES: solve A P^{-1} y = b, return x = P^{-1} y."""
    y, info = gmres(
        lambda z: matvec(precond(z)), space, b,
        k_dim=k_dim, tol=tol, max_restarts=max_restarts,
    )
    return precond(y), info


@dataclasses.dataclass
class HarmonicResolventResult:
    omega: float
    response: Tuple[torch.Tensor, torch.Tensor]  # (re, im) velocity pair
    gain: float                                  # ||uhat|| / ||fhat||  (energy)
    gmres_iterations: int
    precond_rank: int
    floquet_multipliers: np.ndarray


def harmonic_resolvent_analysis(
    ns: NavierStokes,
    base_u: torch.Tensor,
    omega: float,
    f_re: torch.Tensor,
    f_im: Optional[torch.Tensor] = None,
    base_p: Optional[torch.Tensor] = None,
    floquet: bool = False,
    base_period: Optional[float] = None,
    n_precond_modes: int = 2,
    eig_k_dim: int = 30,
    eig_tol: float = 1e-6,
    steps_per_period: int = 128,
    gmres_k_dim: int = 40,
    gmres_tol: float = 1e-8,
    seed: int = 1234,
) -> HarmonicResolventResult:
    """Forced harmonic response  uhat = R(omega) fhat  with the Floquet
    spectral preconditioner.

    1. direct + adjoint Krylov-Schur for the ``n_precond_modes`` leading
       multipliers;
    2. biorthogonalize the pairs, build P^{-1};
    3. the forced particular solution b over one period, then
       right-preconditioned GMRES on (I - M) x = b; quarter-period
       propagation for Im(uhat) (as ``algorithms/resolvent.py``)."""
    sem = ns.sem
    f_re = f_re.to(sem.dtype)
    f_im = torch.zeros_like(f_re) if f_im is None else f_im.to(sem.dtype)

    if floquet:
        # the forced integration linearized along the periodic orbit
        op = FloquetResolventOperator(
            ns, base_u, omega, base_p=base_p, base_period=base_period,
            steps_per_period=steps_per_period,
            gmres_kdim=gmres_k_dim, gmres_tol=gmres_tol,
        )
    else:
        op = ResolventOperator(
            ns, base_u, omega, base_p=base_p,
            steps_per_period=steps_per_period,
            gmres_kdim=gmres_k_dim, gmres_tol=gmres_tol,
        )
    nsteps = op.nsteps

    # leading direct/adjoint modes of the same discrete propagator
    dres = linear_stability_analysis(
        ns, base_u, horizon=op.T, nsteps=nsteps, base_p=base_p,
        mode="direct", floquet=floquet, k_dim=eig_k_dim,
        nev=n_precond_modes, tol=eig_tol, seed=seed,
        nmodes_out=n_precond_modes,
    )
    ares = linear_stability_analysis(
        ns, base_u, horizon=op.T, nsteps=nsteps, base_p=base_p,
        mode="adjoint", floquet=floquet, k_dim=eig_k_dim,
        nev=n_precond_modes, tol=eig_tol, seed=seed + 1,
        nmodes_out=n_precond_modes,
    )

    # pair direct/adjoint modes by matching multipliers mu <-> conj(mu)
    used = set()
    triples: List = []
    for i, mu in enumerate(dres.mu[: len(dres.modes)]):
        best, bestd = None, np.inf
        for j, nu in enumerate(ares.mu[: len(ares.modes)]):
            if j in used:
                continue
            d = abs(np.conj(nu) - mu)
            if d < bestd:
                best, bestd = j, d
        if best is None:
            continue
        used.add(best)
        if mu.imag < 0 and any(abs(np.conj(m) - mu) < 1e-12 for m, _, _ in triples):
            continue  # skip explicit conjugate partners
        triples.append((complex(mu), dres.modes[i], ares.modes[best]))

    precond = SpectralPreconditioner(sem, triples)

    # particular solution + preconditioned periodicity solve
    b = op._deflate(op._apply((f_re, f_im)))
    space = velocity_space(sem)
    x, info = preconditioned_gmres(
        lambda x: op._deflate(x - op._homogeneous(x)), space, b, precond,
        k_dim=gmres_k_dim, tol=gmres_tol,
    )
    x = op._deflate(x)
    x4 = op._integrate(x, f_re, f_im, nsteps // 4)
    u_re, u_im = x, -x4

    fnorm = float(torch.sqrt(space.dot(f_re, f_re) + space.dot(f_im, f_im)))
    unorm = float(torch.sqrt(space.dot(u_re, u_re) + space.dot(u_im, u_im)))
    return HarmonicResolventResult(
        omega=float(omega),
        response=(u_re, u_im),
        gain=unorm / max(fnorm, 1e-300),
        gmres_iterations=info["iterations"],
        precond_rank=len(triples),
        floquet_multipliers=np.asarray(dres.mu),
    )
