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
and exactly one velocity and one pressure solve per tangent step; in the
mixed-precision step each is the same refined solve on the tangent
right-hand side.  Stage k = min(step, 2) uses its own BDF/EXT coefficients,
as in the JAX ramp.  2-D and 3-D: the component count comes from ``q``.

The adjoint ``rmatvec`` comes with the Krylov layer and raises here.
"""

from __future__ import annotations

from typing import Optional

import torch

from .navier_stokes import NavierStokes


class LinearizedOperator:
    """Tangent propagator  q -> D Phi_T(base) q  around a frozen steady base
    flow (velocity-only steppers)."""

    def __init__(
        self,
        ns: NavierStokes,
        base_u: torch.Tensor,
        base_p: Optional[torch.Tensor] = None,
        nsteps: int = 100,
        t0: float = 0.0,
    ):
        if ns.forcing is not None:
            raise NotImplementedError(
                "the tangent of a user forcing hook is not ported"
            )
        s = ns.sem
        self.ns = ns
        self.sem = s
        self.nsteps = int(nsteps)
        self.T = self.nsteps * ns.dt
        self.t0 = float(t0)
        # the tangent does not depend on the base pressure; base_p is kept
        # for call compatibility with the JAX operator
        self.base_u = base_u.to(device=s.device, dtype=s.dtype)
        self.warm = ns.solver.warm_start

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

    def matvec(self, q: torch.Tensor) -> torch.Tensor:
        """Direct map: nsteps tangent steps from a zero history."""
        df = self._tangent0(q)
        for i in range(self.nsteps):
            df = self.ns._core(df, self.t0, min(i, 2), lin_base=self.base_u)
        return df[0]

    def rmatvec(self, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "the adjoint propagator is not ported yet (it comes with the "
            "Krylov layer)"
        )
