"""Resolvent (forced-response) analysis via the time-stepper formulation
(port of ``nekstab_next_tpu/algorithms/resolvent.py``: ``_complex_space``,
``ResolventResult``, ``ResolventOperator``, ``FloquetResolventOperator``
and ``resolvent_analysis``).

For forcing  f(t) = Re(fhat e^{i omega t})  around a steady base flow, the
periodic response  u(t) = Re(uhat e^{i omega t})  with  uhat = R(omega) fhat
is obtained matrix-free over one period T = 2 pi / omega:

1. particular solution  b  of the forced tangent equations over one period
   from rest (the forcing phase omega dt n at the start of step n);
2. periodicity solve  (I - exp(T L)) x = b  by restarted GMRES  ->
   x = Re(uhat);
3. quarter-period forced propagation of x gives the imaginary part:
   u_p(T/4) = -Im(uhat) (the reference's phase trick).

Complex fields are (re, im) velocity pairs.  The forced integrations are
the written-out tangent steps of ``stepper/linearized.py``
(:class:`~..stepper.linearized.TangentSteps`); on the f32 ``fused_solves``
path each step launches K1 and K2 once.

The JAX package has two versions of the map: ``matvec`` (host GMRES to
``gmres_tol``) and ``matvec_pure``, whose periodicity solve is a
fixed-iteration on-device GMRES (``_gmres_device``) inside
``lax.custom_linear_solve``, because the TPU path must be transposable
under ``jit``.  Here there is one map: ``matvec_pure`` is ``matvec``, the
host GMRES to ``gmres_tol`` with at most ``gmres_restarts`` cycles of
``gmres_kdim``; ``_gmres_device`` is not ported.  ``rmatvec`` is the
transpose of that whole real-linear map in the ``bm`` product (not the
sponge-masked ``bms`` of the stability operators): the forced full- and
quarter-period integrations are transposed step by step
(``TangentSteps.transpose``, ``torch.func.vjp`` of each step), and
``(I - M)^T`` is solved by host GMRES on the transposed homogeneous
integration."""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..krylov.gmres import gmres
from ..krylov.svd import svds
from ..krylov.vector import VectorSpace
from ..stepper.linearized import TangentSteps
from ..stepper.navier_stokes import NavierStokes
from ..utils.noise import velocity_noise
from .stability import velocity_space


def _complex_space(sem) -> VectorSpace:
    def dot(a, b):
        (ar, ai), (br, bi) = a, b
        return sum(
            sem.inner(ar[..., d], br[..., d]) + sem.inner(ai[..., d], bi[..., d])
            for d in range(ar.shape[-1])
        )

    return VectorSpace(dot)


@dataclasses.dataclass
class ResolventResult:
    omega: float
    sigma: np.ndarray  # resolvent gains
    forcing_modes: List  # (re, im) pairs
    response_modes: List
    n_matvecs: int


class ResolventOperator:
    """Matrix-free R(omega) on (re, im) velocity pairs around a steady base
    (its tangent frozen there at t = 0, as the JAX operator's)."""

    def __init__(
        self,
        ns: NavierStokes,
        base_u: torch.Tensor,
        omega: float,
        base_p: Optional[torch.Tensor] = None,
        steps_per_period: int = 128,
        gmres_kdim: int = 64,
        gmres_tol: float = 1e-8,
        gmres_restarts: int = 8,
    ):
        assert steps_per_period % 4 == 0, "need T/4 to land on a step"
        self._setup(ns, omega, 2.0 * np.pi / float(omega), steps_per_period,
                    gmres_kdim, gmres_tol, gmres_restarts)
        s = ns.sem
        # the tangent does not depend on the base pressure; base_p is kept
        # for the JAX signature.  Four tangent fields, as JAX's template
        self._steps = TangentSteps(ns, base_u.to(device=s.device, dtype=s.dtype), 0.0,
                                   dt=self.dt, warm=False)

    def _setup(self, ns, omega, T, steps_per_period, gmres_kdim, gmres_tol,
               gmres_restarts) -> None:
        self.ns = ns
        self.sem = ns.sem
        self.omega = float(omega)
        self.T = float(T)
        self.nsteps = int(steps_per_period)
        self.dt = self.T / self.nsteps
        self.gmres_kdim = gmres_kdim
        self.gmres_tol = gmres_tol
        self.gmres_restarts = int(gmres_restarts)
        self.n_matvecs = 0
        self.n_rmatvecs = 0
        # The periodicity operator I - M is singular on neutral modes of the
        # propagator (the constant mode of a fully periodic box, mu = 1):
        # deflate them
        self._deflate_mean = not ns.sem.has_pressure_dirichlet and not bool(
            torch.any(ns.sem.vmask == 0.0))

    def _deflate(self, u: torch.Tensor) -> torch.Tensor:
        if not self._deflate_mean:
            return u
        s = self.sem
        vol = s.volume()
        mean = torch.stack([s.glsum(u[..., d] * s.bm) / vol for d in range(u.shape[-1])])
        return u - mean  # (ndim,) broadcasts over the trailing component axis

    def _deflate_t(self, v: torch.Tensor) -> torch.Tensor:
        """The transpose of :meth:`_deflate` (Euclidean)."""
        if not self._deflate_mean:
            return v
        s = self.sem
        total = torch.stack([s.glsum(v[..., d]) for d in range(v.shape[-1])])
        return v - s.bm[..., None] * total / s.volume()

    def _phase(self, n: int) -> Tuple[float, float]:
        ph = self.omega * self.dt * n
        return math.cos(ph), math.sin(ph)

    # -- forced tangent integration ------------------------------------
    def _integrate(self, q0, f_re, f_im, nsteps: int) -> torch.Tensor:
        """Integrate the forced linearized equations for ``nsteps`` steps
        from the perturbation q0 with forcing Re(fhat e^{i omega t}); zero
        forcing where ``f_re`` is None."""
        if f_re is None:
            return self._steps.integrate(q0, nsteps)

        def fc(n):
            c, sn = self._phase(n)
            return f_re * c - f_im * sn

        return self._steps.integrate(q0, nsteps, forcing=fc)

    def _integrate_t(self, ct: torch.Tensor, nsteps: int, ct_f=None) -> torch.Tensor:
        """The transpose of :meth:`_integrate`: the seed's cotangent; with
        ``ct_f`` = [ct_re, ct_im] the forcing's cotangents are added there."""
        def acc(n, c):
            cs, sn = self._phase(n)
            ct_f[0] = ct_f[0] + cs * c
            ct_f[1] = ct_f[1] - sn * c

        return self._steps.transpose(ct, nsteps, None if ct_f is None else acc)

    # -- R(omega) --------------------------------------------------------
    def _apply(self, fpair) -> torch.Tensor:
        """The particular solution over one period from rest."""
        f_re, f_im = fpair
        return self._integrate(torch.zeros_like(f_re), f_re, f_im, self.nsteps)

    def _homogeneous(self, q: torch.Tensor) -> torch.Tensor:
        return self._integrate(q, None, None, self.nsteps)

    def matvec(self, fpair) -> Tuple[torch.Tensor, torch.Tensor]:
        """uhat = R(omega) fhat  as an (re, im) pair."""
        f_re, f_im = (f.to(self.sem.dtype) for f in fpair)
        b = self._deflate(self._apply((f_re, f_im)))
        x, info = gmres(lambda x: self._deflate(x - self._homogeneous(x)),
                        velocity_space(self.sem), b, k_dim=self.gmres_kdim,
                        tol=self.gmres_tol, max_restarts=self.gmres_restarts)
        x = self._deflate(x)
        self.n_matvecs += info["iterations"] + 1
        # quarter-period forced propagation for the imaginary part
        x4 = self._integrate(x, f_re, f_im, self.nsteps // 4)
        return (x, -x4)

    def matvec_pure(self, fpair) -> Tuple[torch.Tensor, torch.Tensor]:
        """The same map as :meth:`matvec` (the JAX package's transposable
        fixed-iteration version is not needed here)."""
        return self.matvec(fpair)

    def rmatvec(self, upair) -> Tuple[torch.Tensor, torch.Tensor]:
        """Adjoint resolvent in the energy product ``bm``: the transpose of
        the whole (re, im) -> (re, im) map, ``ct / bm`` around its
        transpose applied to ``(u_re bm, u_im bm)``."""
        s = self.sem
        bm = s.bm[..., None]
        ur, ui = (u.to(s.dtype) for u in upair)
        ct_f = [torch.zeros_like(ur), torch.zeros_like(ur)]
        # output (x, -x4), x4 the quarter-period forced propagation of x
        gx = ur * bm + self._integrate_t(-(ui * bm), self.nsteps // 4, ct_f)
        # x = D A^-1 D b with A = D (I - M): solve A^T z = D^T gx, where
        # A^T = (I - M^T) D^T
        def At(v):
            w = self._deflate_t(v)
            return w - self._integrate_t(w, self.nsteps)

        z, info = gmres(At, velocity_space(s, masked=False), self._deflate_t(gx),
                        k_dim=self.gmres_kdim, tol=self.gmres_tol,
                        max_restarts=self.gmres_restarts)
        self.n_rmatvecs += info["iterations"] + 1
        # b = the particular solution: its forcing's cotangents
        self._integrate_t(self._deflate_t(z), self.nsteps, ct_f)
        return (ct_f[0] / bm, ct_f[1] / bm)


class FloquetResolventOperator(ResolventOperator):
    """R(omega) around a *T_b-periodic base orbit* (the reference's
    Floquet-resolvent mode, uparam 3.41): the orbit launched from ``base_u``
    at t = 0 with zero forcing is stored once, and the forced tangent is
    replayed along it, the forcing phase locked to the orbit.  ``omega``
    must be a harmonic of the orbit, omega = 2 pi m / base_period, so that
    the periodicity solve over one orbit period is well posed.

    As the reference's resolvent solver, the T/4 phase trick recovers
    Im(uhat) exactly only for a monochromatic response; on a periodic base
    the response carries Floquet sidebands, which the harmonic resolvent
    (``algorithms/harmonic.py``) treats.  ``remat`` is accepted for the JAX
    signature (the orbit is stored)."""

    def __init__(
        self,
        ns: NavierStokes,
        base_u: torch.Tensor,
        omega: float,
        base_p: Optional[torch.Tensor] = None,
        base_period: Optional[float] = None,
        steps_per_period: int = 128,
        gmres_kdim: int = 64,
        gmres_tol: float = 1e-8,
        gmres_restarts: int = 8,
        remat: bool = True,
    ):
        assert steps_per_period % 4 == 0, "need T/4 to land on a step"
        omega = float(omega)
        T = float(base_period) if base_period is not None else 2.0 * np.pi / omega
        harmonic = omega * T / (2.0 * np.pi)
        if abs(harmonic - round(harmonic)) > 1e-8:
            raise ValueError(
                f"omega={omega} is not a harmonic of the base period "
                f"{T} (omega T / 2 pi = {harmonic:.6f})"
            )
        self._setup(ns, omega, T, steps_per_period, gmres_kdim, gmres_tol, gmres_restarts)
        s = ns.sem
        base_u = base_u.to(device=s.device, dtype=s.dtype)
        self._steps = TangentSteps.along_orbit(ns, base_u, base_p, self.nsteps, dt=self.dt)
        self.monodromy_drift = float(s.norm(self._steps.final - base_u))

    def _integrate(self, q0, f_re, f_im, nsteps: int) -> torch.Tensor:
        if nsteps not in (self.nsteps, self.nsteps // 4):
            raise ValueError(
                f"Floquet resolvent integrates one period ({self.nsteps} steps) "
                f"or a quarter period, got {nsteps}"
            )
        return super()._integrate(q0, f_re, f_im, nsteps)


def resolvent_analysis(
    ns: NavierStokes,
    base_u: torch.Tensor,
    omega: float,
    base_p: Optional[torch.Tensor] = None,
    nsv: int = 1,
    k_dim: int = 20,
    tol: float = 1e-6,
    steps_per_period: int = 128,
    seed: int = 1234,
    floquet: bool = False,
    base_period: Optional[float] = None,
) -> ResolventResult:
    """Leading resolvent gains and modes at frequency ``omega`` (Golub-Kahan
    ``svds`` of R(omega) in the energy product).  ``floquet=True`` analyzes
    the forced response around the periodic base orbit launched from
    ``base_u`` with period ``base_period``; ``omega`` must then be one of
    its harmonics."""
    if floquet:
        op = FloquetResolventOperator(
            ns, base_u, omega, base_p=base_p, base_period=base_period,
            steps_per_period=steps_per_period,
        )
    else:
        op = ResolventOperator(
            ns, base_u, omega, base_p=base_p, steps_per_period=steps_per_period
        )
    space = _complex_space(ns.sem)
    x0r = velocity_noise(ns.sem, seed=seed)
    x0i = velocity_noise(ns.sem, seed=seed + 1)
    res = svds(
        op.matvec_pure, op.rmatvec, space, (x0r, x0i), nsv=nsv, k_dim=k_dim,
        tol=tol,
    )
    return ResolventResult(
        omega=omega,
        sigma=res.sigma,
        forcing_modes=res.right,
        response_modes=res.left,
        n_matvecs=res.n_matvecs,
    )
