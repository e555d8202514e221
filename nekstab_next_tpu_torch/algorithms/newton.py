"""Newton-Krylov fixed points (port of ``newton_krylov`` and
``NewtonResult`` from ``nekstab_next_tpu/algorithms/newton.py``).

The outer Newton loop on F(q) = Phi_T(q) - q with a restarted-GMRES inner
solve on the Jacobian J = D Phi_T - I (the time-stepper formulation), the
tangent linearized about every iterate, and an Eisenstat-Walker forcing of
the GMRES tolerance from the current residual.

Not ported: unstable periodic orbits (``upo=True``) and forced orbits
(``forced=True``), ROADMAP item 12; each raises.  ``NewtonConfig.
finite_difference`` is read nowhere, as in the JAX package: Newton always
takes the exact tangent."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import NewtonConfig
from ..krylov.gmres import gmres
from ..krylov.vector import VectorSpace
from ..stepper.linearized import make_tangent_propagator
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
    """Solve Phi_T(q) = q for a steady state.  ``horizon`` is an arbitrary
    integration time T (a larger T damps stable transients harder per Newton
    step), split into ``nsteps`` steps of T / nsteps.  ``callback(it, res,
    T)`` is called once per iteration."""
    if upo or forced:
        raise NotImplementedError(
            "not ported: Newton for periodic orbits (upo=True, forced=True), "
            "ROADMAP item 12"
        )
    s = ns.sem
    q = u0.to(device=s.device, dtype=s.dtype)
    T = float(horizon)
    dt = T / nsteps
    tangent = make_tangent_propagator(ns, nsteps)
    space = _vspace(s)
    nmv_total = 0
    history = []
    res = np.inf
    p_final = torch.zeros(ns.p_shape, dtype=s.dtype, device=s.device)

    for it in range(cfg.max_iter):
        F = ns.propagator(q, nsteps, dt=dt) - q
        res = float(torch.sqrt(_dotv(s, F, F)))
        history.append((it, res, T))
        if callback is not None:
            callback(it, res, T)
        if not np.isfinite(res):
            raise FloatingPointError(f"Newton residual not finite at iter {it}")
        if res < cfg.tol:
            # the steady pressure: a few steps from the fixed point (the
            # Newton unknown is the velocity only)
            stf = ns.advance(ns.make_state(q), min(nsteps, 20))
            return NewtonResult(q, stf.p, None, res, True, it, nmv_total, history)

        # GMRES tolerance relative to ||F||: loose while the residual is
        # large, tightened near convergence
        if cfg.dynamic_tol:
            gtol = float(np.clip(0.1 * np.sqrt(res), 1e-6, 0.1))
        else:
            gtol = cfg.tol

        def J(dq, q=q):
            return tangent(q, p_final, dq, dt) - dq

        sol, info = gmres(J, space, -F, k_dim=k_dim, tol=gtol,
                          max_restarts=cfg.gmres_restarts)
        q = (q + sol).to(s.dtype)
        nmv_total += info["iterations"] + 2

    return NewtonResult(q, p_final, None, res, False, cfg.max_iter, nmv_total, history)
