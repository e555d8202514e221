"""Tangent propagator about a frozen steady base (port of
``nekstab_next_tpu/stepper/linearized.py`` ``LinearizedOperator``).

The JAX package gets the tangent step from ``jax.linearize`` of the
nonlinear step, once per BDF-ramp stage.  PyTorch has no linearization of a
whole step, and none is needed: the step is affine in its fields except for
the bilinear convection, the Dirichlet lift and the sponge target are
constants, and each inner solve's tangent is the same solve applied to the
tangent right-hand side (``lax.custom_linear_solve`` re-invokes the solve in
JAX too).  So the tangent step is ``NavierStokes._core`` run with the
explicit term linearized about the base,

    dE = -(C(base) du + C(du) base) - B lam du,

and the lift set to zero (in both pressure schemes, the ``+ u_bc`` of the
'laplacian' projection included) — exact, with no autograd on the hot path,
and exactly one velocity and one pressure solve per tangent step; in a
mixed-precision step each is the same refined solve on the tangent
right-hand side (on the fused-IR path ``mixed_ir_cycles`` launches of K1
and of K2 per tangent step).  Stage k = min(step, 2) uses its own BDF/EXT coefficients,
as in the JAX ramp.  2-D and 3-D: the component count comes from ``q``.

The adjoint ``rmatvec`` is the transpose in the sponge-masked energy
product, ``M* = W^+ M^T W`` with ``W = diag(bms)``.  ``M^T`` comes from
``torch.func.vjp`` of the same written-out tangent step, once per BDF stage
(the step is linear in its fields, so one vjp at the zero history serves
every step of that stage), applied in reverse step order: the transpose of
a product of steps, as JAX's ``linear_transpose`` of its ``lax.scan``.
Each inner solve's transpose is the same solve on the cotangent
(``ops/cg.py`` :class:`SymmetricSolve`): on the f32 ``fused_solves`` path
the backward pass launches the K1 and K2 kernels once each per step, and
on the fused-IR mixed path ``mixed_ir_cycles`` times each per step (the
refinement cycles run inside the Function, so its backward is the refined
solve).  The legacy mixed-precision step has no adjoint here (its refined
solve is not differentiable).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .navier_stokes import NavierStokes


class LinearizedOperator:
    """Tangent propagator  q -> D Phi_T(base) q  around a frozen steady base
    flow (velocity-only steppers).  ``dt`` overrides the stepper's time step
    (Newton on a horizon ``ns.dt`` does not divide)."""

    def __init__(
        self,
        ns: NavierStokes,
        base_u: torch.Tensor,
        base_p: Optional[torch.Tensor] = None,
        nsteps: int = 100,
        t0: float = 0.0,
        dt: Optional[float] = None,
    ):
        if ns.forcing is not None:
            raise NotImplementedError(
                "the tangent of a user forcing hook is not ported"
            )
        s = ns.sem
        self.ns = ns
        self.sem = s
        self.nsteps = int(nsteps)
        self.dt = ns.dt if dt is None else float(dt)
        self.T = self.nsteps * self.dt
        self.t0 = float(t0)
        # the tangent does not depend on the base pressure; base_p is kept
        # for call compatibility with the JAX operator
        self.base_u = base_u.to(device=s.device, dtype=s.dtype)
        self.warm = ns.solver.warm_start
        self._vjps: Optional[List[Callable]] = None  # built at the first rmatvec

    def _tangent0(self, q: torch.Tensor) -> tuple:
        """Zero-history tangent field tuple seeded with q (its last axis
        holds the components)."""
        s = self.sem
        zp = torch.zeros(self.ns.p_shape, dtype=s.dtype, device=s.device)
        zl = torch.zeros((2,) + tuple(q.shape), dtype=s.dtype, device=s.device)
        df = (q.to(s.dtype), zp, zl, zl.clone())
        if self.warm:
            df = df + (torch.zeros_like(zp),)
        return df

    def _step(self, df: tuple, k: int) -> tuple:
        """One tangent step of BDF stage k (0, 1, 2 -> BDF1, 2, 3)."""
        return self.ns._core(df, self.t0, k, lin_base=self.base_u, dt=self.dt)

    def matvec(self, q: torch.Tensor) -> torch.Tensor:
        """Direct map: nsteps tangent steps from a zero history."""
        df = self._tangent0(q)
        for i in range(self.nsteps):
            df = self._step(df, min(i, 2))
        return df[0]

    # -- adjoint -------------------------------------------------------
    def _mass_weight(self, w: torch.Tensor) -> torch.Tensor:
        # the sponge-masked weight bm1s: the inner product the Krylov space
        # uses (algorithms/stability.py velocity_space)
        return w * self.sem.bms[..., None]

    def _mass_unweight(self, w: torch.Tensor) -> torch.Tensor:
        # pseudo-inverse of bms (zero inside the sponge, a semi-norm), then
        # the vmask projection onto the admissible (homogeneous-BC)
        # subspace: the raw transpose has nonzero rows at Dirichlet input
        # dofs, which the direct map never produces
        bm = self.sem.bms[..., None]
        inv = torch.where(bm > 0, 1.0 / torch.where(bm > 0, bm, torch.ones_like(bm)),
                          torch.zeros_like(bm))
        return w * inv * self.sem.vmask

    def _stage_vjps(self) -> List[Callable]:
        """The transpose of each BDF stage's tangent step: ``torch.func.vjp``
        at the zero history, built once (the step is linear, so the vjp does
        not depend on the point)."""
        if self._vjps is None:
            if self.ns.mixed is not None:
                raise NotImplementedError(
                    "not ported: the adjoint of the legacy mixed-precision step "
                    "(its refined solve is not differentiable; ROADMAP items 11 "
                    "and 15)"
                )
            s = self.sem
            zero = self._tangent0(torch.zeros(tuple(s.bm.shape) + (s.ndim,),
                                              dtype=s.dtype, device=s.device))
            self._vjps = [
                torch.func.vjp(lambda df, k=k: self._step(df, k), zero)[1]
                for k in range(min(self.nsteps, 3))
            ]
        return self._vjps

    def rmatvec(self, w: torch.Tensor) -> torch.Tensor:
        """Adjoint in the (sponge-masked) energy product:
        M* = W^+ M^T W with W = diag(bm1s)."""
        vjps = self._stage_vjps()
        ct = self._tangent0(self._mass_weight(w.to(self.sem.dtype)))
        for i in reversed(range(self.nsteps)):
            (ct,) = vjps[min(i, 2)](ct)
        return self._mass_unweight(ct[0])


def make_tangent_propagator(ns: NavierStokes, nsteps: int) -> Callable:
    """Tangent propagator  ``(base_u, base_p, q, dt) -> M q``  with the base
    flow and dt as arguments (Newton re-linearizes about every iterate).
    The JAX package jit-compiles one function for all bases; here each call
    builds a :class:`LinearizedOperator`, which precomputes nothing."""

    def apply(base_u, base_p, q, dt):
        return LinearizedOperator(ns, base_u, base_p=base_p, nsteps=nsteps,
                                  dt=dt).matvec(q)

    return apply
