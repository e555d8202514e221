"""Fixed-point and steady-state accelerators: SFD, BoostConv, TDF (port of
``nekstab_next_tpu/algorithms/fixed_point.py``).

* SFD: selective frequency damping, DNS forced by ``gain (u - ubar)`` with
  ``ubar`` a low-pass-filtered copy of the flow; converges to unstable
  steady states.
* BoostConv: every ``skip`` steps the one-step residual is boosted through
  a least-squares problem on a small stored residual subspace (modified
  Gram-Schmidt QR in the mass-weighted product, on the host).
* TDF: time-delayed feedback ``gain (u(t) - u(t - T))`` with a ring buffer
  of one period's snapshots; stabilizes periodic orbits.

The JAX package runs the steps of a chunk as one jitted ``lax.scan``; here
they are plain loops over ``ns.step`` and ``ns.advance``, with the same
residuals checked at the same points.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..stepper.navier_stokes import NavierStokes


@dataclasses.dataclass
class FixedPointResult:
    u: torch.Tensor
    p: torch.Tensor
    residual: float
    converged: bool
    iterations: int
    history: list


def _energy_norm(s, du: torch.Tensor) -> float:
    """Unmasked energy norm of a velocity field (mass weight bm)."""
    return float(torch.sqrt(sum(s.inner(du[..., d], du[..., d], masked=False)
                                for d in range(du.shape[-1]))))


def sfd(
    ns: NavierStokes,
    u0: torch.Tensor,
    gain: float = -0.05,
    cutoff: float = 0.05,
    tol: float = 1e-9,
    max_steps: int = 200_000,
    chunk: int = 200,
    callback: Optional[Callable] = None,
) -> FixedPointResult:
    """Selective frequency damping toward an unstable steady state.

    Filter ODE  d(ubar)/dt = cutoff (u - ubar), forward Euler alongside the
    flow; forcing  fc = gain (u - ubar)  (gain < 0 damps).  The residual
    ||u - ubar||_B, read every ``chunk`` steps, goes to 0 at the steady
    state."""
    dt = ns.dt
    st = ns.make_state(u0)
    ubar = st.u
    history = []
    steps = 0
    res = np.inf
    while steps < max_steps:
        for _ in range(chunk):
            st = ns.step(st, fc=gain * (st.u - ubar))
            ubar = ubar + dt * cutoff * (st.u - ubar)
        steps += chunk
        res = _energy_norm(ns.sem, st.u - ubar)
        history.append((steps, res))
        if callback is not None:
            callback(steps, res)
        if not np.isfinite(res):
            raise FloatingPointError(f"SFD diverged at step {steps}")
        if res < tol:
            return FixedPointResult(st.u, st.p, res, True, steps, history)
    return FixedPointResult(st.u, st.p, res, False, steps, history)


def boostconv_dns(
    ns: NavierStokes,
    u0: torch.Tensor,
    skip: int = 10,
    subspace: int = 10,
    tol: float = 1e-9,
    max_steps: int = 200_000,
    callback: Optional[Callable] = None,
) -> FixedPointResult:
    """BoostConv-accelerated march to a steady state (Citro et al. 2017, as
    the JAX package rebuilds it).

    Every ``skip`` DNS steps the one-step residual  r = u(t) - u(t-dt)  is
    replaced by a boosted residual  xi  and the state reset to
    ``u(t-dt) + xi``.  The accelerator keeps cyclic buffers of
    input-residual differences Y and boosted outputs X with the recursive
    update (y_rot -= r; x_rot -= y_rot), solves the small least-squares
    problem on the Y subspace by modified Gram-Schmidt QR in the
    mass-weighted product (with its zero-column guard) and
    back-substitution, then emits  xi = r + X ccb."""
    s = ns.sem
    nd = s.ndim
    dot = lambda a, b: sum(
        float(s.inner(a[..., d], b[..., d], masked=False)) for d in range(nd)
    )

    st = ns.make_state(u0)
    m = subspace
    zeros = torch.zeros_like(st.u)
    X = [zeros] * m
    Y = [zeros] * m
    rot = 0
    init = False
    history = []
    steps = 0
    res = np.inf
    while steps < max_steps:
        st_prev = ns.advance(st, skip - 1)
        st = ns.step(st_prev)
        steps += skip
        r = st.u - st_prev.u
        res = float(np.sqrt(max(dot(r, r), 0.0)))
        history.append((steps, res))
        if callback is not None:
            callback(steps, res)
        if not np.isfinite(res):
            raise FloatingPointError(f"BoostConv diverged at step {steps}")
        if res < tol:
            return FixedPointResult(st.u, st.p, res, True, steps, history)

        # --- boostconv_core -------------------------------------------
        if not init:
            X[0] = r
            Y[0] = r
            rot = 0
            init = True
            xi = r  # first call: unboosted (v = vold + r)
        else:
            Y[rot] = Y[rot] - r
            X[rot] = X[rot] - Y[rot]
            # MGS QR of the Y buffer in the mass-weighted product, with the
            # zero/degenerate-column guard (norm -> 1, q -> 0)
            Q = []
            R = np.zeros((m, m))
            for j in range(m):
                v = Y[j]
                for i in range(j):
                    R[i, j] = dot(v, Q[i])
                    v = v - R[i, j] * Q[i]
                nrm2 = dot(v, v)
                if nrm2 < 1e-60:
                    Q.append(torch.zeros_like(v))
                    R[j, j] = 1.0
                else:
                    nrm = float(np.sqrt(nrm2))
                    Q.append(v / nrm)
                    R[j, j] = nrm
            c = np.array([dot(r, q) for q in Q])
            ccb = np.zeros(m)
            for j in range(m - 1, -1, -1):
                ccb[j] = (c[j] - R[j, j + 1:] @ ccb[j + 1:]) / R[j, j]
            rot = (rot + 1) % m
            Y[rot] = r
            xi = r
            for j in range(m):
                xi = xi + ccb[j] * X[j]
            X[rot] = xi
        st = ns.make_state(st_prev.u + xi, p=st.p, time=float(st.time))
    return FixedPointResult(st.u, st.p, res, False, steps, history)


def tdf(
    ns: NavierStokes,
    u0: torch.Tensor,
    period: float,
    gain: float = -0.05,
    tol: float = 1e-8,
    max_periods: int = 200,
    callback: Optional[Callable] = None,
) -> FixedPointResult:
    """Time-delayed feedback stabilization of a periodic orbit: forcing
    fc = gain (u(t) - u(t - T)) with a ring buffer of the last period's
    snapshots."""
    norbit = max(int(round(period / ns.dt)), 1)
    st = ns.make_state(u0)
    ring = [st.u] * norbit
    history = []
    res = np.inf
    for it in range(max_periods):
        u_prev = st.u
        for i in range(norbit):
            st = ns.step(st, fc=gain * (st.u - ring[i]))
            ring[i] = st.u
        res = _energy_norm(ns.sem, st.u - u_prev)
        history.append(((it + 1) * norbit, res))
        if callback is not None:
            callback(it, res)
        if res < tol:
            return FixedPointResult(st.u, st.p, res, True, (it + 1) * norbit, history)
    return FixedPointResult(st.u, st.p, res, False, max_periods * norbit, history)
