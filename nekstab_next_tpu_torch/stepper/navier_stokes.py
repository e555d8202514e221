"""Incompressible Navier-Stokes time-stepper (port of
``nekstab_next_tpu/stepper/navier_stokes.py``), 2-D and 3-D.

Scheme: BDFk/EXTk (k ramps 1->3) with incremental pressure correction:

1. explicit terms  E^n = -C(u^n)u^n + B f^n  (dealiased weak convection,
   sponge + user forcing), extrapolated with EXTk;
2. velocity Helmholtz solve  (g0/dt B + nu K) u* = rhs  with Dirichlet lift
   and a residual-correction warm start from u^n;
3. pressure increment, one of two schemes (``SolverConfig.pressure_operator``):
   ``'pnpn2'``: E dp = -(g0/dt) D u* on the discontinuous P_{N-2} Gauss
   space, E = D M^-1 D^T, then u <- u* + (dt/g0) M^-1 D^T dp (discretely
   divergence-free), the same code in 2-D and 3-D;
   ``'laplacian'``: K dp = -(g0/dt) B div(u*) on the velocity GLL grid
   (an approximate projection, safe on affine meshes), then
   u <- u* - (dt/g0) grad(dp), mass-averaged back onto the C0 space with
   the Dirichlet values re-imposed;
4. p <- p + dp.

``mixed_precision=True`` keeps the f64 state and runs both solves as
float32 inner solves under f64 iterative refinement, on one of two paths,
chosen where the JAX package chooses them:

* fused-IR, on a 2-D ``'pnpn2'`` step with ``fused_solves`` on a mesh whose
  exchange shift-decomposes (``ops/exchange.py``): the same PnPn-2 scheme
  as the f32 path, each solve ``mixed_ir_cycles`` refinement cycles around
  the fused CUDA kernels K1 and K2 (``ops/cg.py``, ``ops/fused_cg.py``);
* legacy, everywhere else: float32 inner CG with the fused local Helmholtz
  kernel K4 (``ops/mixed.py``) on the ``'laplacian'`` scheme.

The tangent step (``stepper/linearized.py``) is the same :meth:`_core` run
with the explicit term linearized about a base velocity (frozen, or the
stored state of each step of an orbit) and the Dirichlet lift set to zero;
the step is affine in its fields apart from the convection and the forcing
hook.

Every option the port does not implement raises where it is read; the JAX
stepper would quietly take another path instead.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..config import SolverConfig
from ..ops.cg import cg_solve
from ..ops.elliptic import elliptic_solve
from ..ops.exchange import shift_decomposes
from ..ops.mixed import MixedPrecision, elliptic_solve_mixed
from .state import FlowState, initial_state

# BDFk / EXTk coefficients, index k-1 (padded to length 3)
_BDF = {
    1: (1.0, [1.0, 0.0, 0.0]),
    2: (1.5, [2.0, -0.5, 0.0]),
    3: (11.0 / 6.0, [3.0, -1.5, 1.0 / 3.0]),
}
_EXT = {
    1: [1.0, 0.0, 0.0],
    2: [2.0, -1.0, 0.0],
    3: [3.0, -3.0, 1.0],
}


def _fused_ir(sem, solver: SolverConfig) -> bool:
    """Whether ``mixed_precision`` takes the fused-IR path, as the JAX
    constructor decides it: a 2-D ``'pnpn2'`` step with ``fused_solves`` on
    a mesh whose exchange shift-decomposes."""
    return (sem.ndim == 2 and solver.pressure_operator == "pnpn2"
            and solver.fused_solves and shift_decomposes(sem))


def _scheme(sem, solver: SolverConfig, legacy_mixed: bool) -> str:
    """The pressure scheme the JAX constructor picks, or raise where the
    port does not implement it.  The legacy mixed path runs ``'laplacian'``
    whatever ``pressure_operator`` says."""
    if solver.pressure_operator not in ("pnpn2", "laplacian", "consistent"):
        raise ValueError(f"unknown pressure_operator {solver.pressure_operator!r}")
    if legacy_mixed:
        return "laplacian"
    if solver.pressure_operator == "consistent":
        raise NotImplementedError(
            "not ported: SolverConfig.pressure_operator='consistent'")
    if solver.fused_solves and (sem.ndim == 3 or solver.pressure_operator != "pnpn2"):
        raise NotImplementedError(
            "not ported: fused_solves outside the 2-D 'pnpn2' step"
        )
    return solver.pressure_operator


def _check_supported(solver: SolverConfig, u_bc_fn, scalar_diff) -> None:
    """Raise for every option the port does not implement."""
    unsupported = {
        "u_bc_fn (time-dependent Dirichlet data)": u_bc_fn is not None,
        "scalars (scalar_diff)": bool(scalar_diff),
        "SolverConfig.lanes_layout": solver.lanes_layout,
        "SolverConfig.pressure_direct": solver.pressure_direct,
        "SolverConfig.cg_fixed_iters": solver.cg_fixed_iters,
        "SolverConfig.finite_difference": solver.finite_difference,
        "SolverConfig.fused_pressure=False": solver.fused_solves and not solver.fused_pressure,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError("not ported: " + ", ".join(bad))
    if solver.pressure_precond not in ("fdm", "block", "schwarz"):
        raise ValueError(f"unknown pressure_precond {solver.pressure_precond!r}")
    if solver.pressure_patch_overlap not in ("face", "node"):
        raise ValueError(f"unknown pressure_patch_overlap {solver.pressure_patch_overlap!r}")
    if solver.velocity_precond not in ("fdm", "block"):
        raise ValueError(f"unknown velocity_precond {solver.velocity_precond!r}")


class NavierStokes:
    """Matrix-free incompressible NS stepper on one SEM mesh.

    Parameters
    ----------
    sem : SEM (2-D) or SEM3 (3-D) operator context; the velocity has
          ``sem.ndim`` components
    viscosity : kinematic viscosity (1/Re)
    dt : time step (constant)
    u_bc : (nelem, n, .., n, ndim) Dirichlet values (zero except at
           Dirichlet nodes)
    forcing : optional ``f(u, t) -> (nelem, n, .., n, ndim)`` pointwise
              acceleration
    sponge_ref : field toward which the sponge damps (None: no sponge term)
    solver : SolverConfig
    mixed_precision : f64 state, float32 inner solves with f64 iterative
              refinement.  On a 2-D ``'pnpn2'`` step with ``fused_solves``
              on a shift-decomposable mesh this is the fused-IR path
              (``_mixed_ir``): the PnPn-2 scheme, each solve
              ``solver.mixed_ir_cycles`` cycles around K1/K2 run to 3e-6 at
              caps ``min(velocity_maxiter, 100)`` and
              ``min(pressure_maxiter, 150)``.  Elsewhere it is the legacy
              path (``mixed``, ``ops/mixed.py``) on the ``'laplacian'``
              scheme (an approximate projection on the velocity GLL grid),
              whatever ``solver.pressure_operator`` says.

    ``SolverConfig.bdf_order`` is read nowhere, as in the JAX stepper: the
    step always ramps BDF1 -> BDF3.  ``u_bc_fn`` and the scalar arguments
    of the JAX stepper are accepted so a call written for it fails loudly
    here."""

    def __init__(
        self,
        sem,
        viscosity: float,
        dt: float,
        u_bc: Optional[torch.Tensor] = None,
        forcing: Optional[Callable] = None,
        sponge_ref: Optional[torch.Tensor] = None,
        solver: SolverConfig = SolverConfig(),
        mixed_precision: bool = False,
        u_bc_fn: Optional[Callable] = None,
        scalar_diff: Optional[Tuple[float, ...]] = None,
    ):
        _check_supported(solver, u_bc_fn, scalar_diff)
        # fused-IR mixed precision, or the legacy path (ops/mixed.py)
        self._mixed_ir = bool(mixed_precision) and _fused_ir(sem, solver)
        legacy = bool(mixed_precision) and not self._mixed_ir
        self._scheme = _scheme(sem, solver, legacy)
        self.sem = s = sem
        self.ndim = s.ndim
        self.nu = float(viscosity)
        self.dt = float(dt)
        self.solver = solver
        zeros_u = torch.zeros(tuple(s.bm.shape) + (self.ndim,), dtype=s.dtype,
                              device=s.device)
        u_bc = zeros_u if u_bc is None else u_bc.to(device=s.device, dtype=s.dtype)
        # keep only Dirichlet-node values in the lift field
        self.u_bc = (1.0 - s.vmask) * u_bc
        self.forcing = forcing
        self.sponge_ref = sponge_ref
        self._convect = s.convect if solver.dealias else s.convect_colloc_v
        # local stiffness diagonal, for the Jacobi preconditioners
        self._kdiag_local = None if solver.fdm_precond else s.stiffness_diag()

        # legacy mixed precision (ops/mixed.py): f32 inner CG through the
        # fused local Helmholtz kernel K4, f64 refinement
        self.mixed = MixedPrecision(s) if legacy else None

        # the exact-block preconditioners (ops/schwarz.py), built once here
        if self._scheme == "pnpn2":
            if solver.pressure_precond == "schwarz":
                s.setup_pressure_schwarz(adjacency=solver.pressure_patch_overlap)
            elif solver.pressure_precond == "block":
                s.setup_pressure_blocks()
        # velocity blocks for the final (BDF3) stage's h2 = (11/6)/dt; the
        # two ramp steps see a mildly mismatched but SPD preconditioner
        self._vblocks = None
        if solver.velocity_precond == "block" and not mixed_precision:
            self._vblocks = s.setup_velocity_blocks(self.nu, _BDF[3][0] / self.dt)

        # both inner solves as one CUDA kernel each (ops/fused_cg.py); on the
        # fused-IR path the f32 inner solves of refinement, run to the
        # f32-reachable 3e-6 at bounded caps (refinement supplies the rest)
        self.fused_v = None
        self.fused_p = None
        if solver.fused_solves and self.mixed is None:
            from ..ops.fused_cg import FusedHelmholtzCG, FusedPressureCG

            if self._mixed_ir:
                v_tol, v_cap = 3e-6, min(solver.velocity_maxiter, 100)
                p_tol, p_cap = 3e-6, min(solver.pressure_maxiter, 150)
            else:
                v_tol, v_cap = solver.velocity_tol, solver.velocity_maxiter
                p_tol, p_cap = solver.pressure_tol, solver.pressure_maxiter
            self.fused_v = FusedHelmholtzCG(s, s.vmask, maxiter=v_cap, tol=v_tol,
                                            ir=self._mixed_ir)
            self.fused_p = FusedPressureCG(
                s, maxiter=p_cap, tol=p_tol,
                project_mean=not s.has_pressure_dirichlet, ir=self._mixed_ir,
            )
        # refinement cycles of both solves: 0 (one plain solve) off fused-IR
        self._ir_cycles = int(solver.mixed_ir_cycles) if self._mixed_ir else 0

    # ------------------------------------------------------------------
    @property
    def p_shape(self):
        """The pressure space: P_{N-2} Gauss points for 'pnpn2', else the
        velocity GLL grid."""
        if self._scheme == "pnpn2":
            return self.sem.p_shape
        return tuple(self.sem.bm.shape)

    def make_state(self, u, p=None, time: float = 0.0) -> FlowState:
        s = self.sem
        if p is None:
            p = torch.zeros(self.p_shape, dtype=s.dtype, device=s.device)
        return initial_state(u.to(s.dtype), p=p, time=time, dtype=s.dtype,
                             warm_start=self.solver.warm_start)

    def _convect_all(self, c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Weak convection of every component of u by c."""
        s = self.sem
        return torch.stack([self._convect(c, u[..., d]) for d in range(u.shape[-1])], dim=-1)

    def _explicit_weak(self, u: torch.Tensor, t: float, fc=None) -> torch.Tensor:
        """Weak explicit terms E = -C(u)u + B lam (u_ref - u) + B f(u,t) + B fc."""
        s = self.sem
        E = -self._convect_all(u, u)
        bm = s.bm[..., None]
        if self.sponge_ref is not None:
            E = E + bm * s.sponge[..., None] * (self.sponge_ref - u)
        if self.forcing is not None:
            E = E + bm * self.forcing(u, t)
        if fc is not None:
            E = E + bm * fc
        return E

    def _explicit_tangent(self, base: torch.Tensor, du: torch.Tensor, t: float = 0.0,
                          fc=None) -> torch.Tensor:
        """Derivative of :meth:`_explicit_weak` at ``(base, t)`` along ``du``,
        plus ``B fc`` (the explicit forcing enters affinely, as in JAX's
        linearization in (state, fc)): the convection is bilinear, the
        sponge target is a constant, and the pointwise forcing hook is
        differentiated by ``torch.func.jvp`` at the step's physical time."""
        s = self.sem
        E = -(self._convect_all(base, du) + self._convect_all(du, base))
        bm = s.bm[..., None]
        if self.sponge_ref is not None:
            E = E - bm * s.sponge[..., None] * du
        if self.forcing is not None:
            E = E + bm * torch.func.jvp(lambda u: self.forcing(u, t), (base,), (du,))[1]
        if fc is not None:
            E = E + bm * fc
        return E

    # ------------------------------------------------------------------
    def step(self, state: FlowState, fc=None, dt: Optional[float] = None) -> FlowState:
        """Advance one time step; ``dt`` overrides the constructor's time
        step for this step (Newton on a horizon that ``ns.dt`` does not
        divide)."""
        k = min(state.step, 2)  # 0,1,2 -> BDF1,2,3
        dt = self.dt if dt is None else float(dt)
        carry_dp = state.dp is not None
        fields = (state.u, state.p, state.ulag, state.nlag) + (
            (state.dp,) if carry_dp else ()
        )
        out = self._core(fields, state.time, k, fc=fc, dt=dt)
        return FlowState(
            u=out[0], p=out[1], ulag=out[2], nlag=out[3],
            time=state.time + dt, step=state.step + 1,
            dp=out[4] if carry_dp else None,
        )

    def _core(self, fields: Tuple, time: float, k: int, fc=None,
              lin_base: Optional[torch.Tensor] = None,
              dt: Optional[float] = None) -> Tuple:
        """One step on the field tuple (u, p, ulag, nlag[, dp]).

        ``k`` selects the BDF/EXT order (0,1,2 -> BDF1,2,3).  With
        ``lin_base`` the step is the TANGENT step about the base velocity
        ``lin_base`` at physical time ``time``: the explicit term is
        linearized there (``fc`` then enters as a tangent forcing) and the
        Dirichlet lift is zero (its derivative); everything else is affine
        in the fields and runs unchanged, solves included.  ``dt``
        overrides the constructor's time step."""
        u0 = fields[0]
        if lin_base is None:
            return self._implicit(fields, self._explicit_weak(u0, time, fc=fc), k,
                                  self.u_bc, dt)
        return self._implicit(fields, self._explicit_tangent(lin_base, u0, time, fc=fc),
                              k, torch.zeros_like(u0), dt)

    def _implicit(self, fields: Tuple, E0: torch.Tensor, k: int, u_bc: torch.Tensor,
                  dt: Optional[float] = None) -> Tuple:
        """The rest of a step once its explicit term ``E0`` is known: the
        extrapolation, both solves and the projection.  Affine in
        ``(fields, E0)``, linear with a zero lift ``u_bc``: the transpose of
        a tangent step along an evolving base is this function's transpose
        (one per BDF stage) and the explicit term's (one per base)."""
        u0, p0, ulag0, nlag0 = fields[:4]
        dp0 = fields[4] if len(fields) > 4 else None
        s = self.sem
        dt = self.dt if dt is None else float(dt)
        g0, b = _BDF[k + 1]
        a = _EXT[k + 1]
        bm = s.bm[..., None]
        vmask = s.vmask
        binv = s.binv_assembled[..., None]
        pnpn2 = self._scheme == "pnpn2"

        def Minv_free(g):
            return vmask * (binv * s.dssum(vmask * g))

        # weak RHS for the Helmholtz solve, with the weak gradient of the
        # current pressure (D^T p for 'pnpn2', -B grad p for 'laplacian')
        rhs = (
            (1.0 / dt) * bm * (b[0] * u0 + b[1] * ulag0[0] + b[2] * ulag0[1])
            + a[0] * E0 + a[1] * nlag0[0] + a[2] * nlag0[1]
        )
        if pnpn2:
            rhs = rhs + s.grad_from_p(p0)
        else:
            rhs = rhs - bm * s.gradv(p0)

        # ---- velocity Helmholtz solve with Dirichlet lift ---------------
        h2 = g0 / dt
        ndim = self.ndim

        def helm_local(w):
            return torch.stack(
                [s.helmholtz_local(w[..., d], self.nu, h2) for d in range(ndim)], dim=-1
            )

        fdm = self.solver.fdm_precond
        if self.mixed is not None:
            # the mixed branch takes no warm start (as the JAX package's)
            w = elliptic_solve_mixed(
                s, self.mixed, self.nu, h2, rhs - helm_local(u_bc), vmask,
                maxiter=self.solver.velocity_maxiter,
            )
        else:
            # warm start from the current velocity: solve for the correction
            # only; the guess must lie in the masked continuous subspace
            if self.solver.warm_start:
                x0v = vmask * s.dsavg(vmask * (u0 - u_bc))
            else:
                x0v = torch.zeros_like(u0)
            fused_v = None
            if self.fused_v is not None:
                fv = self.fused_v
                # the kernels take contiguous tensors; einsum outputs may be views
                fused_v = lambda r: fv.solve(r.contiguous(), self.nu, h2)
            w = x0v + elliptic_solve(
                s,
                helm_local,
                rhs - helm_local(u_bc + x0v),
                vmask,
                tol=self.solver.velocity_tol,
                maxiter=self.solver.velocity_maxiter,
                diag_local=None if fdm else self.nu * self._kdiag_local + h2 * s.bm,
                fdm=(self.nu, h2) if fdm else None,
                vblocks=self._vblocks,
                fused_solve=fused_v,
                ir_cycles=self._ir_cycles,
            )
        ustar = w + u_bc

        if not pnpn2:
            dp = self._pressure_laplacian(ustar, dp0, g0, dt)
            # approximate projection, mass-averaged back onto C0; the lift
            # is zero in the tangent step
            u_new = ustar - (dt / g0) * s.gradv(dp)
            u_new = vmask * s.dsavg_mass(u_new) + u_bc
            return self._pack(u_new, p0 + dp, u0, ulag0, E0, nlag0, dp0, dp)

        # ---- pressure-increment solve on the Gauss space ----------------
        def E_op(q):
            return s.div_to_p(Minv_free(s.grad_from_p(q)))

        x0p = dp0 if (dp0 is not None and self.solver.warm_start) else None
        project = None
        if not s.has_pressure_dirichlet:
            # fully-enclosed flow: constants span null(E) exactly
            def project(q):
                return q - torch.sum(q) / q.numel()

            if x0p is not None:
                x0p = project(x0p)
        rhs_p = -(g0 / dt) * s.div_to_p(ustar)
        if x0p is not None:
            rhs_p = rhs_p - E_op(x0p)
        pp = self.solver.pressure_precond
        if pp == "schwarz" and s.pschwarz is not None:
            precond_p = s.pressure_precond_schwarz
        elif pp in ("block", "schwarz") and s.pblock_inv is not None:
            precond_p = s.pressure_precond_block
        else:
            precond_p = s.pressure_precond_pnpn2
        dp = cg_solve(
            E_op,
            rhs_p,
            precond=precond_p,
            tol=self.solver.pressure_tol,
            maxiter=self.solver.pressure_maxiter,
            dot=lambda x, y: torch.sum(x * y),
            project=project,
            fused_solve=(
                (lambda r: self.fused_p.solve(r.contiguous()))
                if self.fused_p is not None else None
            ),
            ir_cycles=self._ir_cycles,
        )
        if x0p is not None:
            dp = dp + x0p

        # ---- projection: discretely divergence-free; Dirichlet rows of the
        # correction vanish (Minv_free masks), so BCs stay intact
        u_new = ustar + (dt / g0) * Minv_free(s.grad_from_p(dp))
        return self._pack(u_new, p0 + dp, u0, ulag0, E0, nlag0, dp0, dp)

    @staticmethod
    def _pack(u_new, p_new, u0, ulag0, E0, nlag0, dp0, dp) -> Tuple:
        out = (
            u_new,
            p_new,
            torch.stack([u0, ulag0[0]]),
            torch.stack([E0, nlag0[0]]),
        )
        if dp0 is not None:
            out = out + (dp,)
        return out

    def _pressure_laplacian(self, ustar, dp0, g0, dt) -> torch.Tensor:
        """Pressure increment of the 'laplacian' scheme on the GLL grid:
        K dp = -(g0/dt) B div(u*), Dirichlet 0 at outflow nodes, the mean
        removed on enclosed meshes.  The mixed branch carries ``dp`` but
        takes no warm start from it, as the JAX package's."""
        s = self.sem
        rhs_p = -(g0 / dt) * s.bm * s.divv(ustar)
        project_mean = not s.has_pressure_dirichlet
        if self.mixed is not None:
            return elliptic_solve_mixed(
                s, self.mixed, 1.0, 0.0, rhs_p, s.pmask,
                maxiter=self.solver.pressure_maxiter,
                project_mean=project_mean, coarse=True,
            )
        # warm start from the previous increment (residual-correction form)
        x0p = dp0 if (dp0 is not None and self.solver.warm_start) else None
        if x0p is not None:
            rhs_p = rhs_p - s.stiffness_local(x0p)
        fdm = self.solver.fdm_precond
        dp = elliptic_solve(
            s,
            s.stiffness_local,
            rhs_p,
            s.pmask,
            tol=self.solver.pressure_tol,
            maxiter=self.solver.pressure_maxiter,
            diag_local=self._kdiag_local,
            project_mean=project_mean,
            fdm=(1.0, 0.0) if fdm else None,
            coarse=fdm,
        )
        return dp if x0p is None else dp + x0p

    # ------------------------------------------------------------------
    def advance(self, state: FlowState, nsteps: int, dt: Optional[float] = None) -> FlowState:
        """nsteps time steps — one propagator application."""
        for _ in range(nsteps):
            state = self.step(state, dt=dt)
        return state

    def propagator(self, u0: torch.Tensor, nsteps: int, time0: float = 0.0,
                   dt: Optional[float] = None) -> torch.Tensor:
        """exp(T L)-style map on velocity fields: fresh state, integrate,
        return the final velocity."""
        return self.advance(self.make_state(u0, time=time0), nsteps, dt=dt).u
