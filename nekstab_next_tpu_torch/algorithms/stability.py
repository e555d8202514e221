"""Linear stability and transient growth (port of ``velocity_space``,
``coupled_space``, ``gradient_energy_norm``, ``StabilityResult``,
``linear_stability_analysis``, ``TransientGrowthResult`` and
``transient_growth_analysis`` from ``nekstab_next_tpu/algorithms/stability.py``).

Krylov-Schur on the direct or adjoint exponential propagator, eigenvalues
reported in the propagator plane (mu) and log-mapped to the NS plane
lambda = log(mu)/T; Golub-Kahan svds of the propagator for the optimal
energy growth.  The inner product is the sponge-masked energy product
<u, v>_{bm1s}.  ``floquet=True`` takes the propagator along the periodic
orbit launched from the base (``FloquetOperator``: the monodromy when the
horizon is the orbit's period).  With a thermal stepper (``ns.nscal > 0``)
the Krylov vectors are coupled ``(velocity, scalars)`` pairs in the energy
product over both (``coupled_space``), about ``(base_u, base_T)``.
``SolverConfig.finite_difference`` selects the finite-difference
propagator (direct only)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..krylov.krylov_schur import EigenResult, eigs
from ..krylov.svd import svds
from ..krylov.vector import VectorSpace
from ..stepper.linearized import (
    FiniteDifferenceOperator,
    FloquetOperator,
    LinearizedOperator,
)
from ..stepper.navier_stokes import NavierStokes
from ..utils.noise import make_seed, velocity_noise


def velocity_space(sem, masked: bool = True) -> VectorSpace:
    """Energy inner product over velocity fields (the reference's k_dot)."""

    def dot(a, b):
        return sum(
            sem.inner(a[..., d], b[..., d], masked=masked)
            for d in range(a.shape[-1])
        )

    return VectorSpace(dot)


def coupled_space(sem, masked: bool = True) -> VectorSpace:
    """Energy inner product over coupled (velocity, scalars) pairs: the
    velocity's and the scalars' mass-weighted products summed."""

    def dot(a, b):
        au, aT = a
        bu, bT = b
        return sem.inner(au, bu, masked=masked) + sem.inner(aT, bT, masked=masked)

    return VectorSpace(dot)


def gradient_energy_norm(sem, u) -> float:
    """Energy norm of the velocity gradient of a (unit-norm) mode — the
    reference's spurious-eigenvector detector ``norm_grad``: spurious
    Arnoldi vectors are rough, so their H1 content is anomalously high."""
    total = 0.0
    for d in range(u.shape[-1]):
        g = sem.gradv(u[..., d])
        total += float(sem.inner(g, g))
    return float(np.sqrt(total))


@dataclasses.dataclass
class StabilityResult:
    mu: np.ndarray  # propagator-plane eigenvalues (complex)
    lam: np.ndarray  # NS-plane rates lambda = log(mu)/T
    residuals: np.ndarray
    modes: List[Tuple]  # (re, im) velocity fields, or (u, T) pairs when coupled
    horizon: float
    n_matvecs: int
    eigresult: EigenResult
    mode_gradient_norms: Optional[np.ndarray] = None  # H1 spurious detector
    spurious: Optional[np.ndarray] = None  # bool mask (gradient-norm filter)

    def leading(self, i: int = 0) -> complex:
        return complex(self.lam[i])


def _make_operator(ns, base_u, base_p, nsteps, floquet, base_T=None):
    if floquet:
        return FloquetOperator(ns, base_u, base_p=base_p, nsteps=nsteps, base_T=base_T)
    if ns.solver.finite_difference:
        # the finite-difference cross-check: direct matvec only
        return FiniteDifferenceOperator(ns, base_u, nsteps=nsteps, order=ns.solver.fd_order)
    return LinearizedOperator(ns, base_u, base_p=base_p, nsteps=nsteps, base_T=base_T)


def linear_stability_analysis(
    ns: NavierStokes,
    base_u: torch.Tensor,
    horizon: float,
    nsteps: int,
    base_p: Optional[torch.Tensor] = None,
    mode: str = "direct",
    floquet: bool = False,
    k_dim: int = 100,
    nev: int = 2,
    tol: float = 1e-6,
    schur_del: float = 0.10,
    max_restarts: int = 50,
    seed: int = 1234,
    seed_mode: str = "noise",
    seed_path: Optional[str] = None,
    x0: Optional[torch.Tensor] = None,
    nmodes_out: Optional[int] = None,
    base_T: Optional[torch.Tensor] = None,
    spurious_factor: Optional[float] = 3.0,
    checkpoint=None,
    checkpoint_steps: bool = False,
) -> StabilityResult:
    """Leading direct (``mode='direct'``) or adjoint (``mode='adjoint'``)
    eigenmodes of the linearized flow about the steady ``base_u``, or with
    ``floquet=True`` along the orbit launched from it (Floquet multipliers
    ``mu`` when the horizon is its period).  As in the JAX package, the
    horizon is ``nsteps * ns.dt`` (``horizon`` is accepted for its
    signature).  ``seed_mode``: 'noise' | 'symmetric' | 'load' |
    'baseflow'.

    With a thermal stepper (``ns.nscal > 0``) the Krylov vectors are
    coupled ``(u, T)`` pairs about ``(base_u, base_T)`` and the modes come
    back as pairs; the scalars always seed with noise (no spurious-mode
    filter then).  ``checkpoint`` (an ``io.checkpoint.ArnoldiCheckpoint``)
    and ``checkpoint_steps`` go to :func:`~..krylov.krylov_schur.eigs`."""
    if mode not in ("direct", "adjoint"):
        raise ValueError(f"mode must be 'direct' or 'adjoint', got {mode!r}")
    op = _make_operator(ns, base_u, base_p, nsteps, floquet, base_T=base_T)
    coupled = ns.nscal > 0
    matvec = op.matvec if mode == "direct" else op.rmatvec
    space = coupled_space(ns.sem) if coupled else velocity_space(ns.sem)
    if x0 is None:
        x0 = make_seed(ns.sem, mode=seed_mode, seed=seed, path=seed_path,
                       base_u=base_u)
        if coupled:
            xT = velocity_noise(ns.sem, seed=seed + 1)[..., :1]
            x0 = (x0, torch.cat([xT] * ns.nscal, dim=-1) * ns.sem.tmask[..., None])
    res = eigs(
        matvec, space, x0, k_dim=k_dim, nev=nev, tol=tol,
        schur_del=schur_del, max_restarts=max_restarts, checkpoint=checkpoint,
        checkpoint_steps=checkpoint_steps,
    )
    T = op.T
    lam = np.log(res.eigenvalues.astype(np.complex128)) / T
    nout = min(nmodes_out if nmodes_out is not None else nev, res.k)
    modes = []
    gnorms = []
    for i in range(nout):
        re, im = res.mode(i)
        nrm = float(torch.sqrt(space.dot(re, re) + space.dot(im, im)))
        re = space.scale(1.0 / nrm, re)
        im = space.scale(1.0 / nrm, im)
        modes.append((re, im))
        if spurious_factor is not None and not coupled:
            gnorms.append(
                np.hypot(gradient_energy_norm(ns.sem, re),
                         gradient_energy_norm(ns.sem, im))
            )
    gnorms = np.asarray(gnorms) if gnorms else None
    spurious = None
    if gnorms is not None and len(gnorms) > 1:
        # anomalously rough relative to the smoothest retained mode
        spurious = gnorms > spurious_factor * gnorms.min()
    return StabilityResult(
        mu=res.eigenvalues,
        lam=lam,
        residuals=res.residuals,
        modes=modes,
        horizon=T,
        n_matvecs=res.n_matvecs,
        eigresult=res,
        mode_gradient_norms=gnorms,
        spurious=spurious,
    )


@dataclasses.dataclass
class TransientGrowthResult:
    gains: np.ndarray  # G(T) = sigma^2
    sigma: np.ndarray
    optimal_inputs: List[torch.Tensor]  # right singular vectors
    optimal_responses: List[torch.Tensor]  # left singular vectors
    horizon: float
    n_matvecs: int
    residuals: Optional[np.ndarray] = None  # svds triplet residuals


def transient_growth_analysis(
    ns: NavierStokes,
    base_u: torch.Tensor,
    horizon: float,
    nsteps: int,
    base_p: Optional[torch.Tensor] = None,
    floquet: bool = False,
    nsv: int = 2,
    k_dim: int = 64,
    tol: float = 1e-6,
    seed: int = 1234,
    x0: Optional[torch.Tensor] = None,
) -> TransientGrowthResult:
    """Optimal energy growth over the horizon: G = sigma(exp(T L))^2, the
    leading singular values of the tangent propagator in the sponge-masked
    energy norm (Golub-Kahan :func:`~..krylov.svd.svds` on ``matvec`` and
    ``rmatvec``), about a steady base or, with ``floquet=True``, along the
    orbit launched from it.  As in the JAX package, the horizon is
    ``nsteps * ns.dt`` (``horizon`` is accepted for its signature)."""
    op = _make_operator(ns, base_u, base_p, nsteps, floquet)
    space = velocity_space(ns.sem)
    if x0 is None:
        x0 = velocity_noise(ns.sem, seed=seed)
    # the energy norm is the sponge-masked semi-norm (bm1s): seed components
    # inside the mask have zero norm but would still feed the first matvec,
    # so the optimization is held to the measured subspace (every later
    # Lanczos vector stays there through the W^+-weighted adjoint)
    x0 = x0 * (ns.sem.bms > 0)[..., None].to(x0.dtype)
    x0nrm = float(space.norm(x0))
    if not np.isfinite(x0nrm) or x0nrm == 0.0:
        raise ValueError(
            "transient-growth seed has zero energy in the sponge-masked "
            "norm (supported entirely inside the sponge?): supply a seed "
            "with support in the measured region or use the default noise"
        )
    res = svds(op.matvec, op.rmatvec, space, x0, nsv=nsv, k_dim=k_dim, tol=tol)
    return TransientGrowthResult(
        gains=res.sigma ** 2,
        sigma=res.sigma,
        optimal_inputs=res.right,
        optimal_responses=res.left,
        horizon=op.T,
        n_matvecs=res.n_matvecs,
        residuals=res.residuals,
    )
