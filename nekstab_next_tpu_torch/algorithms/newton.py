"""Newton-Krylov fixed points and periodic orbits (port of
``newton_krylov`` and ``NewtonResult`` from
``nekstab_next_tpu/algorithms/newton.py``).

The outer Newton loop on F(q) = Phi_T(q) - q with a restarted-GMRES inner
solve on the Jacobian J = D Phi_T - I (the time-stepper formulation) and an
Eisenstat-Walker forcing of the GMRES tolerance from the current residual.

* fixed points: the tangent linearized about every iterate, frozen;
* unstable periodic orbits (``upo=True``): the period T joins the unknowns;
  the bordered Jacobian gets the column b = d Phi_T / dT, a one-step
  difference of the flow at t = T, and the phase row <qdot(0), dq> = 0;
* forced orbits (``forced=True``): a fixed period, the orbit phase-locked
  to the forcing (integration from t = 0).

Both orbit kinds linearize along the trajectory
(``stepper/linearized.py`` :class:`TangentSteps`): each Newton iteration
integrates the orbit once, storing it, and takes Phi_T(q) from that pass;
every GMRES matvec of the iteration replays the tangent along it (the JAX
package recomputes the primal in every matvec).  ``NewtonConfig.
finite_difference`` is read nowhere, as in the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import NewtonConfig
from ..krylov.gmres import gmres
from ..krylov.vector import VectorSpace
from ..stepper.linearized import TangentSteps, make_tangent_propagator
from ..stepper.navier_stokes import NavierStokes


@dataclasses.dataclass
class NewtonResult:
    u: torch.Tensor
    p: torch.Tensor
    period: Optional[float]
    residual: float
    converged: bool
    iterations: int
    n_matvecs: int
    history: list


def _dotv(sem, a, b):
    return sum(
        sem.inner(a[..., d], b[..., d], masked=False) for d in range(a.shape[-1])
    )


def _vspace(sem) -> VectorSpace:
    return VectorSpace(lambda a, b: _dotv(sem, a, b))


def _vspace_upo(sem) -> VectorSpace:
    """Augmented (velocity, period) vector space: the period's component
    joins the inner product (the reference's ``krylov_vector`` time
    component)."""

    def dot(a, b):
        u, t = a
        v, s = b
        return _dotv(sem, u, v) + t * s

    return VectorSpace(dot)


def newton_krylov(
    ns: NavierStokes,
    u0: torch.Tensor,
    horizon: float,
    nsteps: int,
    upo: bool = False,
    forced: bool = False,
    cfg: NewtonConfig = NewtonConfig(),
    k_dim: int = 64,
    callback: Optional[Callable] = None,
) -> NewtonResult:
    """Solve Phi_T(q) = q (fixed point), or (Phi_T(q) = q, T) for a UPO.

    For fixed points ``horizon`` is an arbitrary integration time T (a
    larger T damps stable transients harder per Newton step), split into
    ``nsteps`` steps of T / nsteps; for UPOs it is the initial period guess,
    and for forced orbits (``forced=True``) the forcing period, which stays
    fixed.  ``callback(it, res, T)`` is called once per iteration."""
    if upo and forced:
        raise ValueError(
            "upo=True (unknown period) and forced=True (fixed forcing "
            "period) are mutually exclusive: pick the reference's uparam "
            "2.1 or 2.2"
        )
    s = ns.sem
    q = u0.to(device=s.device, dtype=s.dtype)
    T = float(horizon)
    orbit = upo or forced
    tangent = None if orbit else make_tangent_propagator(ns, nsteps)
    space = _vspace_upo(s) if upo else _vspace(s)
    nmv_total = 0
    history = []
    res = np.inf
    p_final = torch.zeros(ns.p_shape, dtype=s.dtype, device=s.device)

    for it in range(cfg.max_iter):
        dt = T / nsteps
        if orbit:
            # one pass stores the orbit (the tangent's linearization points,
            # phase t = 0) and gives Phi_T(q)
            steps = TangentSteps.along_orbit(ns, q, p_final, nsteps, dt=dt)
            Phi = steps.final
        else:
            Phi = ns.propagator(q, nsteps, dt=dt)
        F = Phi - q
        res = float(torch.sqrt(_dotv(s, F, F)))
        history.append((it, res, T))
        if callback is not None:
            callback(it, res, T)
        if not np.isfinite(res):
            raise FloatingPointError(f"Newton residual not finite at iter {it}")
        if res < cfg.tol:
            # the pressure: a few steps from the solution (the Newton
            # unknown is the velocity only)
            stf = ns.advance(ns.make_state(q), min(nsteps, 20))
            return NewtonResult(q, stf.p, T if orbit else None, res, True, it,
                                nmv_total, history)

        # GMRES tolerance relative to ||F||: loose while the residual is
        # large, tightened near convergence
        if cfg.dynamic_tol:
            gtol = float(np.clip(0.1 * np.sqrt(res), 1e-6, 0.1))
        else:
            gtol = cfg.tol

        if upo:
            # bordered system: J (dq, dT) = (-F, 0)
            bvec = (ns.propagator(Phi, 1, dt=dt) - Phi) / dt  # d Phi_T / dT ~ u_dot(T)
            qdot0 = (ns.propagator(q, 1, dt=dt) - q) / dt  # phase direction at t=0

            def J(x, steps=steps, qdot0=qdot0, bvec=bvec):
                dq, dT = x
                Mdq = steps.integrate(dq, nsteps)
                return (Mdq - dq + dT * bvec, _dotv(s, qdot0, dq))

            zero_T = torch.zeros((), dtype=s.dtype, device=s.device)
            sol, info = gmres(J, space, (-F, zero_T), x0=(torch.zeros_like(q), zero_T),
                              k_dim=k_dim, tol=gtol, max_restarts=cfg.gmres_restarts)
            dq, dT = sol
            # keep the iterate in the SEM dtype
            q = (q + dq).to(s.dtype)
            T = float(T + float(dT))
        else:
            if orbit:
                def J(dq, steps=steps):
                    return steps.integrate(dq, nsteps) - dq
            else:
                def J(dq, q=q, dt=dt):
                    return tangent(q, p_final, dq, dt) - dq

            sol, info = gmres(J, space, -F, k_dim=k_dim, tol=gtol,
                              max_restarts=cfg.gmres_restarts)
            q = (q + sol).to(s.dtype)
        nmv_total += info["iterations"] + 2

    return NewtonResult(q, p_final, T if orbit else None, res, False, cfg.max_iter,
                        nmv_total, history)
