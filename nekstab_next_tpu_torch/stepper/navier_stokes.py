"""Incompressible Navier-Stokes time-stepper (port of
``nekstab_next_tpu/stepper/navier_stokes.py``), 2-D and 3-D, with optional
temperature / passive scalars and Boussinesq coupling.

Scheme: BDFk/EXTk (k ramps 1->3) with incremental pressure correction:

1. explicit terms  E^n = -C(u^n)u^n + B f^n  (dealiased weak convection,
   sponge + user forcing + buoyancy b(T)), extrapolated with EXTk;
2. velocity Helmholtz solve  (g0/dt B + nu K) u* = rhs  with Dirichlet lift
   (fixed, or ``u_bc_fn(t)`` evaluated at the new time level) and a
   residual-correction warm start from u^n;
3. pressure increment, one of three schemes (``SolverConfig.pressure_operator``):
   ``'pnpn2'``: E dp = -(g0/dt) D u* on the discontinuous P_{N-2} Gauss
   space, E = D M^-1 D^T, then u <- u* + (dt/g0) M^-1 D^T dp (discretely
   divergence-free), the same code in 2-D and 3-D;
   ``'consistent'``: the same E = D M^-1 D^T with D = B div on the
   continuous velocity GLL grid (an assembled elliptic solve);
   ``'laplacian'``: K dp = -(g0/dt) B div(u*) on the velocity GLL grid
   (an approximate projection, safe on affine meshes), then
   u <- u* - (dt/g0) grad(dp), mass-averaged back onto the C0 space with
   the Dirichlet values re-imposed;
4. p <- p + dp;
5. scalars (``scalar_diff``): one advection-diffusion Helmholtz solve per
   scalar, (g0/dt B + alpha K) T = rhs_T, convected by u^n with the same
   EXTk treatment, Dirichlet data ``t_bc`` at ``tmask == 0`` nodes.

``mixed_precision=True`` keeps the f64 state and runs the velocity and
pressure solves as float32 inner solves under f64 iterative refinement, on
one of two paths, chosen where the JAX package chooses them:

* fused-IR, on a 2-D ``'pnpn2'`` step with ``fused_solves`` on a mesh whose
  exchange shift-decomposes (``ops/exchange.py``): the same PnPn-2 scheme
  as the f32 path, each solve ``mixed_ir_cycles`` refinement cycles around
  the fused CUDA kernels K1 and K2 (``ops/cg.py``, ``ops/fused_cg.py``);
* legacy, everywhere else: float32 inner CG with the fused local Helmholtz
  kernel K4 (``ops/mixed.py``) on the ``'laplacian'`` scheme.

The scalar solves are plain PyTorch PCG on every path (the JAX package has
no kernel for them): f64 on the mixed paths.

The tangent step (``stepper/linearized.py``) is the same :meth:`_core` run
with the explicit terms linearized about a base (velocity, or velocity and
scalars; frozen, or the stored state of each step of an orbit) and the
Dirichlet lifts set to zero; the step is affine in its fields apart from
the convection and the pointwise hooks (forcing, buoyancy, scalar source).

Every option the port does not implement raises where it is read; the JAX
stepper would quietly take another path instead.  ``fused_solves`` is no
such option: outside the kernels' scope the step runs the plain solves, as
JAX's does.

On a shard view of the SEM (``parallel/sharded.py``) the same step runs on
one rank's elements; the SEM's sums and dots are collectives, and no
kernel is built.

Every fused solve goes through :meth:`NavierStokes._fused`, which a CUDA
graph capture of the tangent step (``stepper/graphs.py``) turns into the
holes between its graph segments.

Spans (``utils/tracing.py``): ``step`` around :meth:`_core`, inside it
``step.explicit`` (the explicit terms and lifts), ``step.velocity`` (the
velocity RHS and solve, to ``ustar``), ``step.pressure`` (its RHS and
solve) and ``step.projection`` (the projection and the packing).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..config import SolverConfig
from ..ops.cg import cg_solve
from ..ops.elliptic import elliptic_solve
from ..ops.exchange import shift_decomposes
from ..ops.mixed import MixedPrecision, elliptic_solve_mixed
from ..utils import tracing
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


def _scheme(solver: SolverConfig, legacy_mixed: bool) -> str:
    """The pressure scheme the JAX constructor picks.  The legacy mixed path
    runs ``'laplacian'`` whatever ``pressure_operator`` says."""
    if solver.pressure_operator not in ("pnpn2", "laplacian", "consistent"):
        raise ValueError(f"unknown pressure_operator {solver.pressure_operator!r}")
    return "laplacian" if legacy_mixed else solver.pressure_operator


def _check_supported(solver: SolverConfig) -> None:
    """Raise for every option the port does not implement."""
    unsupported = {
        "SolverConfig.lanes_layout": solver.lanes_layout,
        "SolverConfig.pressure_direct": solver.pressure_direct,
        "SolverConfig.cg_fixed_iters": solver.cg_fixed_iters,
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

    u_bc_fn : optional ``t -> (nelem, n, .., n, ndim)`` time-dependent
              Dirichlet data (e.g. the FST inflow, ``stepper/fst.py``),
              added to ``u_bc`` at Dirichlet nodes at the new time level
              ``time + dt``; it has no tangent (the tangent's lift is zero)

    Temperature / passive scalars:

    scalar_diff : per-scalar diffusivities (alpha_i); enables the coupled
              advection-diffusion solve  dT/dt + u.grad T = alpha lap T + q
    t_bc : (nelem, n, .., n, nscal) Dirichlet values at ``tmask == 0`` nodes
    t_forcing : optional ``q(u, T, t) -> (nelem, n, .., n, nscal)`` source
    buoyancy : optional ``b(T) -> (nelem, n, .., n, ndim)`` body
              acceleration in the momentum equation (Boussinesq coupling)
    sponge_ref_T : scalar field the sponge damps T toward

    ``SolverConfig.bdf_order`` is read nowhere, as in the JAX stepper: the
    step always ramps BDF1 -> BDF3."""

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
        t_bc: Optional[torch.Tensor] = None,
        t_forcing: Optional[Callable] = None,
        buoyancy: Optional[Callable] = None,
        sponge_ref_T: Optional[torch.Tensor] = None,
    ):
        _check_supported(solver)
        # a shard view (parallel/sharded.py) takes the JAX constructor's
        # branches for ``sem.axis_name is not None``: no kernel, no set-up
        # of preconditioners that are not element-local
        sharded = sem.sharded
        if sharded and mixed_precision:
            raise NotImplementedError(
                "mixed_precision on a shard view: the JAX reference cannot trace "
                "it either (FusedHelmholtz.padfield converts the shard-local "
                "geometry to numpy inside shard_map, "
                "nekstab_next_tpu/ops/pallas_kernels.py:153)"
            )
        # fused-IR mixed precision, or the legacy path (ops/mixed.py)
        self._mixed_ir = bool(mixed_precision) and _fused_ir(sem, solver)
        legacy = bool(mixed_precision) and not self._mixed_ir
        self._scheme = _scheme(solver, legacy)
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
        self.u_bc_fn = u_bc_fn
        self.forcing = forcing
        self.sponge_ref = sponge_ref
        self._convect = s.convect if solver.dealias else s.convect_colloc_v

        # temperature / passive scalars
        self.scalar_diff = tuple(float(a) for a in scalar_diff) if scalar_diff else ()
        self.nscal = len(self.scalar_diff)
        self.t_forcing = t_forcing
        self.buoyancy = buoyancy
        self.sponge_ref_T = (None if sponge_ref_T is None
                             else sponge_ref_T.to(device=s.device, dtype=s.dtype))
        self.t_bc = None
        if self.nscal:
            zeros_t = torch.zeros(tuple(s.bm.shape) + (self.nscal,), dtype=s.dtype,
                                  device=s.device)
            self.t_bc = zeros_t if t_bc is None else (
                (1.0 - s.tmask[..., None]) * t_bc.to(device=s.device, dtype=s.dtype))
        # local stiffness diagonal, for the Jacobi preconditioners
        self._kdiag_local = None if solver.fdm_precond else s.stiffness_diag()

        # legacy mixed precision (ops/mixed.py): f32 inner CG through the
        # fused local Helmholtz kernel K4, f64 refinement
        self.mixed = MixedPrecision(s) if legacy else None

        # the exact-block preconditioners (ops/schwarz.py), built once here;
        # a shard view's element blocks arrive sharded (parallel/sharded.py)
        # and its 'schwarz' falls back to them, as JAX's does
        if self._scheme == "pnpn2" and not sharded:
            if solver.pressure_precond == "schwarz":
                s.setup_pressure_schwarz(adjacency=solver.pressure_patch_overlap)
            elif solver.pressure_precond == "block":
                s.setup_pressure_blocks()
        # velocity blocks for the final (BDF3) stage's h2 = (11/6)/dt; the
        # two ramp steps see a mildly mismatched but SPD preconditioner
        self._vblocks = None
        if solver.velocity_precond == "block" and not mixed_precision and not sharded:
            self._vblocks = s.setup_velocity_blocks(self.nu, _BDF[3][0] / self.dt)

        # the inner solves as one CUDA kernel each (ops/fused_cg.py), where
        # the JAX constructor builds its kernels: a 2-D single-device step
        # with float32 fields or on the fused-IR path, K1 for the velocity
        # and on 'pnpn2' K2 for the pressure; everywhere else (3-D, float64
        # off fused-IR, a shard view) the plain solves, without a word.  JAX
        # also asks that the mesh's exchange shift-decompose; the port's
        # kernels gather over the node->copies table and need no shift, so
        # they are built on any conforming mesh.  On the fused-IR path they
        # are the f32 inner solves of refinement, run to the f32-reachable
        # 3e-6 at bounded caps (refinement supplies the rest).
        self.fused_v = None
        self.fused_p = None
        if (solver.fused_solves and s.ndim == 2 and not sharded and self.mixed is None
                and (s.dtype == torch.float32 or self._mixed_ir)):
            from ..ops.fused_cg import FusedHelmholtzCG, FusedPressureCG

            if self._mixed_ir:
                v_tol, v_cap = 3e-6, min(solver.velocity_maxiter, 100)
                p_tol, p_cap = 3e-6, min(solver.pressure_maxiter, 150)
            else:
                v_tol, v_cap = solver.velocity_tol, solver.velocity_maxiter
                p_tol, p_cap = solver.pressure_tol, solver.pressure_maxiter
            self.fused_v = FusedHelmholtzCG(s, s.vmask, maxiter=v_cap, tol=v_tol,
                                            ir=self._mixed_ir)
            if self._scheme == "pnpn2":
                self.fused_p = FusedPressureCG(
                    s, maxiter=p_cap, tol=p_tol,
                    project_mean=not s.has_pressure_dirichlet, ir=self._mixed_ir,
                )
        # refinement cycles of both solves: 0 (one plain solve) off fused-IR
        self._ir_cycles = int(solver.mixed_ir_cycles) if self._mixed_ir else 0
        # set while stepper/graphs.py captures a step: takes each fused solve
        self._hole: Optional[Callable] = None

    # ------------------------------------------------------------------
    @property
    def p_shape(self):
        """The pressure space: P_{N-2} Gauss points for 'pnpn2', else the
        velocity GLL grid."""
        if self._scheme == "pnpn2":
            return self.sem.p_shape
        return tuple(self.sem.bm.shape)

    @property
    def t_shape(self):
        """The scalar block: (nelem, n, .., n, nscal)."""
        return tuple(self.sem.bm.shape) + (self.nscal,)

    def make_state(self, u, p=None, time: float = 0.0, T=None) -> FlowState:
        """Fresh :class:`FlowState` with pressure (and the warm-start dp
        carry) in this stepper's pressure space; ``T`` the scalar block."""
        s = self.sem
        if p is None:
            p = torch.zeros(self.p_shape, dtype=s.dtype, device=s.device)
        return initial_state(u.to(s.dtype), p=p, time=time, dtype=s.dtype, T=T,
                             warm_start=self.solver.warm_start)

    def _convect_all(self, c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Weak convection of every component of u by c."""
        s = self.sem
        return torch.stack([self._convect(c, u[..., d]) for d in range(u.shape[-1])], dim=-1)

    def _explicit_weak(self, u: torch.Tensor, t: float, fc=None, T=None) -> torch.Tensor:
        """Weak explicit terms E = -C(u)u + B lam (u_ref - u) + B f(u,t)
        + B b(T) + B fc (the buoyancy only with a scalar block ``T``)."""
        s = self.sem
        E = -self._convect_all(u, u)
        bm = s.bm[..., None]
        if self.sponge_ref is not None:
            E = E + bm * s.sponge[..., None] * (self.sponge_ref - u)
        if self.forcing is not None:
            E = E + bm * self.forcing(u, t)
        if self.buoyancy is not None and T is not None:
            E = E + bm * self.buoyancy(T)
        if fc is not None:
            E = E + bm * fc
        return E

    def _explicit_scalar(self, u: torch.Tensor, T: torch.Tensor, t: float,
                         fcT=None) -> torch.Tensor:
        """Weak explicit scalar terms E_T = -C(u)T + B lam (T_ref - T)
        + B q(u,T,t) + B fcT, per scalar."""
        s = self.sem
        E = -self._convect_all(u, T)
        bm = s.bm[..., None]
        if self.sponge_ref_T is not None:
            E = E + bm * s.sponge[..., None] * (self.sponge_ref_T - T)
        if self.t_forcing is not None:
            E = E + bm * self.t_forcing(u, T, t)
        if fcT is not None:
            E = E + bm * fcT
        return E

    def _explicit_tangent(self, base: torch.Tensor, du: torch.Tensor, t: float = 0.0,
                          fc=None, base_T=None, dT=None) -> torch.Tensor:
        """Derivative of :meth:`_explicit_weak` at ``(base, base_T, t)``
        along ``(du, dT)``, plus ``B fc`` (the explicit forcing enters
        affinely, as in JAX's linearization in (state, fc)): the convection
        is bilinear, the sponge target is a constant, and the pointwise
        forcing and buoyancy hooks are differentiated by ``torch.func.jvp``
        (the forcing at the step's physical time)."""
        s = self.sem
        E = -(self._convect_all(base, du) + self._convect_all(du, base))
        bm = s.bm[..., None]
        if self.sponge_ref is not None:
            E = E - bm * s.sponge[..., None] * du
        if self.forcing is not None:
            E = E + bm * torch.func.jvp(lambda u: self.forcing(u, t), (base,), (du,))[1]
        if self.buoyancy is not None and dT is not None:
            E = E + bm * torch.func.jvp(self.buoyancy, (base_T,), (dT,))[1]
        if fc is not None:
            E = E + bm * fc
        return E

    def _explicit_scalar_tangent(self, base_u, base_T, du, dT, t: float = 0.0,
                                 fcT=None) -> torch.Tensor:
        """Derivative of :meth:`_explicit_scalar` at ``(base_u, base_T, t)``
        along ``(du, dT)``: -C(base_u) dT - C(du) base_T - B lam dT
        + B dq, plus ``B fcT``."""
        s = self.sem
        E = -(self._convect_all(base_u, dT) + self._convect_all(du, base_T))
        bm = s.bm[..., None]
        if self.sponge_ref_T is not None:
            E = E - bm * s.sponge[..., None] * dT
        if self.t_forcing is not None:
            E = E + bm * torch.func.jvp(lambda u, T: self.t_forcing(u, T, t),
                                        (base_u, base_T), (du, dT))[1]
        if fcT is not None:
            E = E + bm * fcT
        return E

    def _explicit_lin(self, base, d, t: float = 0.0, fc=None, fcT=None):
        """The explicit terms' tangent about ``base`` along ``d``: a tensor
        for a velocity-only stepper; with scalars ``base`` and ``d`` are
        ``(u, T)`` pairs and so is the result ``(E, E_T)``."""
        if not self.nscal:
            return self._explicit_tangent(base, d, t, fc=fc)
        (bu, bT), (du, dT) = base, d
        return (self._explicit_tangent(bu, du, t, fc=fc, base_T=bT, dT=dT),
                self._explicit_scalar_tangent(bu, bT, du, dT, t, fcT=fcT))

    def _lift(self, time: float, dt: float) -> torch.Tensor:
        """The velocity Dirichlet lift of the step from ``time``: ``u_bc``,
        plus ``u_bc_fn`` at the new time level at Dirichlet nodes."""
        if self.u_bc_fn is None:
            return self.u_bc
        return self.u_bc + (1.0 - self.sem.vmask) * self.u_bc_fn(time + dt)

    def _fused(self, kernel: str, r: torch.Tensor, *args) -> torch.Tensor:
        """One fused inner solve on ``r``: ``solve`` of the kernel instance
        ``kernel`` (``'fused_v'``, ``'fused_p'``), looked up at the call, so
        a wrapper on it sees every launch; while a step is captured as CUDA
        graphs (``stepper/graphs.py``), the capture's hole instead."""
        if self._hole is not None:
            return self._hole(kernel, r, args)
        return getattr(self, kernel).solve(r, *args)

    # ------------------------------------------------------------------
    def step(self, state: FlowState, fc=None, dt: Optional[float] = None) -> FlowState:
        """Advance one time step; ``dt`` overrides the constructor's time
        step for this step (Newton on a horizon that ``ns.dt`` does not
        divide)."""
        k = min(state.step, 2)  # 0,1,2 -> BDF1,2,3
        dt = self.dt if dt is None else float(dt)
        carry_dp = state.dp is not None
        fields = (state.u, state.p, state.ulag, state.nlag)
        if self.nscal:
            fields = fields + (state.T, state.tlag, state.ntlag)
        if carry_dp:
            fields = fields + (state.dp,)
        out = self._core(fields, state.time, k, fc=fc, dt=dt)
        tf = dict(T=out[4], tlag=out[5], ntlag=out[6]) if self.nscal else {}
        return FlowState(
            u=out[0], p=out[1], ulag=out[2], nlag=out[3],
            time=state.time + dt, step=state.step + 1,
            dp=out[-1] if carry_dp else None, **tf,
        )

    def _core(self, fields: Tuple, time: float, k: int, fc=None,
              lin_base=None, dt: Optional[float] = None, fcT=None) -> Tuple:
        """One step on the field tuple (u, p, ulag, nlag[, T, tlag, ntlag][, dp]).

        ``k`` selects the BDF/EXT order (0,1,2 -> BDF1,2,3).  With
        ``lin_base`` the step is the TANGENT step about the base
        (velocity, or the ``(u, T)`` pair of a stepper with scalars) at
        physical time ``time``: the explicit terms are linearized there
        (``fc``/``fcT`` then enter as tangent forcings) and the Dirichlet
        lifts are zero (their derivative); everything else is affine in the
        fields and runs unchanged, solves included.  ``dt`` overrides the
        constructor's time step."""
        u0 = fields[0]
        T0 = fields[4] if self.nscal else None
        with tracing.span("step"):
            with tracing.span("step.explicit"):
                if lin_base is None:
                    E = self._explicit_weak(u0, time, fc=fc, T=T0)
                    lift = self._lift(time, self.dt if dt is None else float(dt))
                    if self.nscal:
                        E = (E, self._explicit_scalar(u0, T0, time, fcT=fcT))
                        lift = (lift, self.t_bc)
                elif self.nscal:
                    E = self._explicit_lin(lin_base, (u0, T0), time, fc=fc, fcT=fcT)
                    lift = (torch.zeros_like(u0), torch.zeros_like(T0))
                else:
                    E, lift = self._explicit_lin(lin_base, u0, time, fc=fc), torch.zeros_like(u0)
            return self._implicit(fields, E, k, lift, dt)

    def _implicit(self, fields: Tuple, E0, k: int, u_bc,
                  dt: Optional[float] = None) -> Tuple:
        """The rest of a step once its explicit terms are known: the
        extrapolation, the solves and the projection.  ``E0`` and ``u_bc``
        are the velocity's explicit term and Dirichlet lift, or with
        scalars the pairs ``(E, E_T)`` and ``(u_bc, t_bc)``.  Affine in
        ``(fields, E0)``, linear with zero lifts: the transpose of a
        tangent step along an evolving base is this function's transpose
        (one per BDF stage) and the explicit terms' (one per base)."""
        u0, p0, ulag0, nlag0 = fields[:4]
        if self.nscal:
            (E0, ET0), (u_bc, t_bc) = E0, u_bc
        s = self.sem
        dt = self.dt if dt is None else float(dt)
        g0, b = _BDF[k + 1]
        a = _EXT[k + 1]
        bm = s.bm[..., None]
        vmask = s.vmask
        binv = s.binv_assembled[..., None]
        pnpn2 = self._scheme == "pnpn2"
        consistent = self._scheme == "consistent"

        def Minv_free(g):
            return vmask * (binv * s.dssum(vmask * g))

        with tracing.span("step.velocity"):
            # weak RHS for the Helmholtz solve, with the weak gradient of the
            # current pressure (D^T p for 'pnpn2' and 'consistent', -B grad p
            # for 'laplacian')
            rhs = (
                (1.0 / dt) * bm * (b[0] * u0 + b[1] * ulag0[0] + b[2] * ulag0[1])
                + a[0] * E0 + a[1] * nlag0[0] + a[2] * nlag0[1]
            )
            if pnpn2:
                rhs = rhs + s.grad_from_p(p0)
            elif consistent:
                rhs = rhs + s.divv_weak_t(p0)
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
                    # the kernels take contiguous tensors; einsum outputs may be views
                    fused_v = lambda r: self._fused("fused_v", r.contiguous(), self.nu, h2)
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
        out = self._pressure(ustar, fields, E0, g0, dt, u_bc, Minv_free)
        if self.nscal:
            out = out[:4] + self._scalars(fields, ET0, t_bc, g0, b, a, dt) + out[4:]
        return out

    def _pressure(self, ustar, fields, E0, g0, dt, u_bc, Minv_free) -> Tuple:
        """The pressure increment and the projection of one step's
        intermediate velocity ``ustar``; returns the packed fields
        (u, p, ulag, nlag[, dp])."""
        u0, p0, ulag0, nlag0 = fields[:4]
        rest = fields[7:] if self.nscal else fields[4:]
        dp0 = rest[0] if rest else None
        s = self.sem
        vmask = s.vmask
        if self._scheme == "laplacian":
            with tracing.span("step.pressure"):
                dp = self._pressure_laplacian(ustar, dp0, g0, dt)
            with tracing.span("step.projection"):
                # approximate projection, mass-averaged back onto C0; the lift
                # is zero in the tangent step
                u_new = ustar - (dt / g0) * s.gradv(dp)
                u_new = vmask * s.dsavg_mass(u_new) + u_bc
                return self._pack(u_new, p0 + dp, u0, ulag0, E0, nlag0, dp0, dp)
        if self._scheme == "consistent":
            with tracing.span("step.pressure"):
                dp = self._pressure_consistent(ustar, dp0, g0, dt, Minv_free)
            with tracing.span("step.projection"):
                # discretely divergence-free; Dirichlet rows of the correction
                # vanish (Minv_free masks), so BCs stay intact
                u_new = ustar + (dt / g0) * Minv_free(s.divv_weak_t(dp))
                return self._pack(u_new, p0 + dp, u0, ulag0, E0, nlag0, dp0, dp)

        with tracing.span("step.pressure"):
            # ---- pressure-increment solve on the Gauss space ----------------
            def E_op(q):
                return s.div_to_p(Minv_free(s.grad_from_p(q)))

            x0p = dp0 if (dp0 is not None and self.solver.warm_start) else None
            project = None
            if not s.has_pressure_dirichlet:
                # fully-enclosed flow: constants span null(E) exactly
                def project(q):
                    return q - s.glsum(q) / (q.numel() * s.nshards)

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
                dot=lambda x, y: s.glsum(x * y),
                project=project,
                fused_solve=(
                    (lambda r: self._fused("fused_p", r.contiguous()))
                    if self.fused_p is not None else None
                ),
                ir_cycles=self._ir_cycles,
            )
            if x0p is not None:
                dp = dp + x0p

        with tracing.span("step.projection"):
            # ---- projection: discretely divergence-free; Dirichlet rows of the
            # correction vanish (Minv_free masks), so BCs stay intact
            u_new = ustar + (dt / g0) * Minv_free(s.grad_from_p(dp))
            return self._pack(u_new, p0 + dp, u0, ulag0, E0, nlag0, dp0, dp)

    def _scalars(self, fields, ET0, t_bc, g0, b, a, dt) -> Tuple:
        """One advection-diffusion Helmholtz solve per scalar (plain PCG,
        no warm start, as the JAX step): (g0/dt B + alpha K) T = rhs_T with
        the Dirichlet lift ``t_bc``; returns (T, tlag, ntlag)."""
        s = self.sem
        T0, tlag0, ntlag0 = fields[4:7]
        bm = s.bm[..., None]
        rhsT = (
            (1.0 / dt) * bm * (b[0] * T0 + b[1] * tlag0[0] + b[2] * tlag0[1])
            + a[0] * ET0 + a[1] * ntlag0[0] + a[2] * ntlag0[1]
        )
        h2 = g0 / dt
        fdm = self.solver.fdm_precond
        Ti = []
        for i, alpha in enumerate(self.scalar_diff):
            local = lambda w, alpha=alpha: s.helmholtz_local(w, alpha, h2)
            tb = t_bc[..., i]
            wT = elliptic_solve(
                s,
                local,
                rhsT[..., i] - local(tb),
                s.tmask,
                tol=self.solver.scalar_tol,
                maxiter=self.solver.scalar_maxiter,
                diag_local=None if fdm else alpha * self._kdiag_local + h2 * s.bm,
                fdm=(alpha, h2) if fdm else None,
            )
            Ti.append(wT + tb)
        return (torch.stack(Ti, dim=-1), torch.stack([T0, tlag0[0]]),
                torch.stack([ET0, ntlag0[0]]))

    def _pressure_consistent(self, ustar, dp0, g0, dt, Minv_free) -> torch.Tensor:
        """Pressure increment of the 'consistent' scheme on the velocity GLL
        grid: E dp = -(g0/dt) D u* with D = B div and E = D M^-1 D^T, an
        assembled elliptic solve (pmask Dirichlet nodes, the mean removed
        on enclosed meshes), warm-started from the previous increment."""
        s = self.sem

        def p_op(q):
            return s.bm * s.divv(Minv_free(s.divv_weak_t(q)))

        x0p = dp0 if (dp0 is not None and self.solver.warm_start) else None
        rhs_p = -(g0 / dt) * (s.bm * s.divv(ustar))
        if x0p is not None:
            rhs_p = rhs_p - p_op(x0p)
        fdm = self.solver.fdm_precond
        dp = elliptic_solve(
            s,
            p_op,
            rhs_p,
            s.pmask,
            tol=self.solver.pressure_tol,
            maxiter=self.solver.pressure_maxiter,
            diag_local=self._kdiag_local,
            project_mean=not s.has_pressure_dirichlet,
            fdm=(1.0, 0.0) if fdm else None,
            coarse=fdm,
        )
        return dp if x0p is None else dp + x0p

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
