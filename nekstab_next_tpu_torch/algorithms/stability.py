"""Linear stability analysis (port of ``velocity_space``,
``gradient_energy_norm``, ``StabilityResult`` and
``linear_stability_analysis`` from
``nekstab_next_tpu/algorithms/stability.py``).

Krylov-Schur on the direct or adjoint exponential propagator, eigenvalues
reported in the propagator plane (mu) and log-mapped to the NS plane
lambda = log(mu)/T; the orthogonalization inner product is the
sponge-masked energy product <u, v>_{bm1s}.

Not ported: Floquet analysis about a periodic base (``floquet=True``),
ROADMAP item 12; coupled scalars (``base_T``), item 10; the transient-growth
analysis (svds), item 11.  Each raises."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..krylov.krylov_schur import EigenResult, eigs
from ..krylov.vector import VectorSpace
from ..stepper.linearized import LinearizedOperator
from ..stepper.navier_stokes import NavierStokes
from ..utils.noise import make_seed


def velocity_space(sem, masked: bool = True) -> VectorSpace:
    """Energy inner product over velocity fields (the reference's k_dot)."""

    def dot(a, b):
        return sum(
            sem.inner(a[..., d], b[..., d], masked=masked)
            for d in range(a.shape[-1])
        )

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
    modes: List[Tuple[torch.Tensor, torch.Tensor]]  # (re, im) velocity fields
    horizon: float
    n_matvecs: int
    eigresult: EigenResult
    mode_gradient_norms: Optional[np.ndarray] = None  # H1 spurious detector
    spurious: Optional[np.ndarray] = None  # bool mask (gradient-norm filter)

    def leading(self, i: int = 0) -> complex:
        return complex(self.lam[i])


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
    eigenmodes of the linearized flow about the steady ``base_u``.  As in
    the JAX package, the horizon is ``nsteps * ns.dt`` (``horizon`` is
    accepted for its signature).  ``seed_mode``: 'noise' | 'symmetric' |
    'load' | 'baseflow'."""
    if floquet:
        raise NotImplementedError(
            "not ported: Floquet analysis about a periodic base (ROADMAP item 12)")
    if base_T is not None:
        raise NotImplementedError("not ported: coupled scalars (ROADMAP item 10)")
    if mode not in ("direct", "adjoint"):
        raise ValueError(f"mode must be 'direct' or 'adjoint', got {mode!r}")
    op = LinearizedOperator(ns, base_u, base_p=base_p, nsteps=nsteps)
    matvec = op.matvec if mode == "direct" else op.rmatvec
    space = velocity_space(ns.sem)
    if x0 is None:
        x0 = make_seed(ns.sem, mode=seed_mode, seed=seed, path=seed_path,
                       base_u=base_u)
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
        if spurious_factor is not None:
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


def transient_growth_analysis(*args, **kwargs):
    raise NotImplementedError(
        "not ported: transient_growth_analysis (the svds path), ROADMAP item 11")
