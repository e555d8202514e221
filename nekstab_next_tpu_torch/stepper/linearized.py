"""Tangent propagators about a frozen steady base and along a periodic
orbit (port of ``nekstab_next_tpu/stepper/linearized.py``:
``LinearizedOperator``, ``make_tangent_propagator``,
``make_orbit_tangent_propagator``, ``FloquetOperator``,
``FiniteDifferenceOperator``).

With scalars (``ns.nscal > 0``) the operators act on coupled ``(u, T)``
pairs: the tangent fields carry the scalar block and its history
``(du, dp, dulag, dnlag, dT, dtlag, dntlag[, ddp])``, the explicit terms
are linearized in both (``-C(base_u) dT - C(du) base_T - B lam dT`` and
the buoyancy and scalar-source hooks by ``torch.func.jvp``), and the scalar
Dirichlet lift is zero, as the velocity's.

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

Along an evolving base (a periodic orbit, a forced orbit) the JAX package
takes ``jax.jvp``/``jax.linearize`` of the whole nonlinear trajectory.  Here
:class:`TangentSteps` stores and replays, as the reference's Fortran does
(``uor/vor``, core/matvec.f90:189-231): one primal pass stores the state
``u_n`` entering each step, and the tangent runs the written-out tangent
step about ``u_n`` at the step's physical time ``t0 + n dt`` (the forcing
hook is linearized there).  The primal runs once per linearization point,
not once per matvec.  Its transpose splits each step into the part after
the explicit term (``NavierStokes._implicit``, one ``vjp`` per BDF stage,
built once) and the explicit term's tangent about ``u_n`` (one small
``vjp`` a step, no solves), so an f32 transpose launches K1 and K2 once
each per step in its backward, as ``rmatvec`` does.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from .navier_stokes import NavierStokes

# a velocity field, or the (u, T) pair of a stepper with scalars
Base = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


class TangentSteps:
    """Written-out tangent steps of ``ns`` along a base trajectory, with
    their transposes.

    ``bases`` is one base (a frozen base, at the one physical time
    ``times``) or a list with the state entering each step (a stored
    orbit, with each step's time in ``times``); a base is the velocity, or
    the ``(u, T)`` pair of a stepper with scalars.  ``warm`` carries the
    pressure-increment slot in the tangent fields (the JAX operators built
    on ``ns.step`` carry it when ``solver.warm_start`` is on; those built
    on four-field ``jax.linearize`` templates, the resolvent's, do not).
    A step may add a tangent forcing ``fc`` (``B fc`` in the explicit
    term)."""

    def __init__(self, ns: NavierStokes, bases: Union[Base, List[Base]],
                 times: Union[float, Sequence[float]] = 0.0, dt: Optional[float] = None,
                 warm: Optional[bool] = None):
        self.ns = ns
        self.sem = ns.sem
        self.bases = bases
        self.times = times
        self.coupled = ns.nscal > 0
        self.frozen = not isinstance(bases, list)
        self.dt = ns.dt if dt is None else float(dt)
        self.warm = ns.solver.warm_start if warm is None else bool(warm)
        self.final: Optional[torch.Tensor] = None  # the orbit's end state (along_orbit)
        self._stage_vjps: List[Callable] = []
        self._explicit_vjp: Optional[Callable] = None  # a frozen base's, built once

    @classmethod
    def along_orbit(cls, ns: NavierStokes, base_u: torch.Tensor,
                    base_p: Optional[torch.Tensor], nsteps: int,
                    dt: Optional[float] = None, t0: float = 0.0) -> "TangentSteps":
        """Run the nonlinear trajectory from ``base_u`` (fresh state at
        physical time ``t0``, BDF ramp) for ``nsteps`` steps and store the
        state entering each step; ``final`` is the state after the last."""
        s = ns.sem
        T0 = None
        if ns.nscal:
            base_u, T0 = base_u
        st = ns.make_state(base_u.to(device=s.device, dtype=s.dtype), p=base_p, time=t0,
                           T=T0)
        bases, times = [], []
        for _ in range(int(nsteps)):
            bases.append((st.u, st.T) if ns.nscal else st.u)
            times.append(st.time)
            st = ns.step(st, dt=dt)
        steps = cls(ns, bases, times, dt=dt)
        steps.final = (st.u, st.T) if ns.nscal else st.u
        return steps

    def base(self, n: int) -> Base:
        return self.bases if self.frozen else self.bases[n]

    def time(self, n: int) -> float:
        return self.times if self.frozen else self.times[n]

    def fields(self, q: Base) -> tuple:
        """Zero-history tangent field tuple seeded with q (the velocity, or
        the ``(u, T)`` pair)."""
        s = self.sem
        zlag = lambda x: torch.zeros((2,) + tuple(x.shape), dtype=s.dtype, device=s.device)
        qu = (q[0] if self.coupled else q).to(s.dtype)
        zp = torch.zeros(self.ns.p_shape, dtype=s.dtype, device=s.device)
        df = (qu, zp, zlag(qu), zlag(qu))
        if self.coupled:
            qT = q[1].to(s.dtype)
            df = df + (qT, zlag(qT), zlag(qT))
        return df + (torch.zeros_like(zp),) if self.warm else df

    def out(self, df: tuple) -> Base:
        """The propagated vector of a field tuple: the velocity, or the
        ``(u, T)`` pair."""
        return (df[0], df[4]) if self.coupled else df[0]

    def step(self, df: tuple, n: int, fc: Optional[torch.Tensor] = None) -> tuple:
        """Tangent step n (BDF stage min(n, 2)) about base n at time n."""
        return self.ns._core(df, self.time(n), min(n, 2), fc=fc, lin_base=self.base(n),
                             dt=self.dt)

    def integrate(self, q: torch.Tensor, nsteps: int,
                  forcing: Optional[Callable[[int], torch.Tensor]] = None) -> torch.Tensor:
        """``nsteps`` tangent steps from the zero history seeded with q,
        step n forced by ``forcing(n)``."""
        df = self.fields(q)
        for n in range(nsteps):
            df = self.step(df, n, None if forcing is None else forcing(n))
        return self.out(df)

    # -- transpose -----------------------------------------------------
    def _stage(self, k: int, ct: tuple) -> Callable:
        """The transpose of BDF stage k's part after the explicit terms: a
        ``vjp`` of ``NavierStokes._implicit`` at the zero history, built
        once (the map is linear).  It covers every field slot (seven with
        scalars, plus the warm-start slot) and the explicit terms, a
        tensor or the ``(E, E_T)`` pair; the lifts are zero."""
        while len(self._stage_vjps) <= k:
            kk = len(self._stage_vjps)
            zero = tuple(torch.zeros_like(c) for c in ct)
            E = tuple(torch.zeros_like(x) for x in self.out(ct)) if self.coupled \
                else torch.zeros_like(ct[0])
            lift = tuple(torch.zeros_like(x) for x in E) if self.coupled \
                else torch.zeros_like(ct[0])
            self._stage_vjps.append(torch.func.vjp(
                lambda df, E, kk=kk: self.ns._implicit(df, E, kk, lift, self.dt),
                zero, E)[1])
        return self._stage_vjps[k]

    def _explicit_t(self, n: int, ct_E: Base) -> Base:
        """The transpose of the explicit terms' tangent about base n: maps
        the cotangent of E (or of the ``(E, E_T)`` pair) to that of the
        velocity (or of the ``(u, T)`` pair)."""
        if self.frozen and self._explicit_vjp is not None:
            return self._explicit_vjp(ct_E)[0]
        base, t = self.base(n), self.time(n)
        zero = tuple(torch.zeros_like(c) for c in ct_E) if self.coupled \
            else torch.zeros_like(ct_E)
        vjp = torch.func.vjp(lambda v: self.ns._explicit_lin(base, v, t), zero)[1]
        if self.frozen:
            self._explicit_vjp = vjp
        return vjp(ct_E)[0]

    def transpose(self, ct_u: Base, nsteps: int,
                  forcing_ct: Optional[Callable[[int, torch.Tensor], None]] = None
                  ) -> Base:
        """The transpose of :meth:`integrate` (Euclidean, element-local
        layout): the cotangent of its seed for the output cotangent
        ``ct_u`` (a velocity, or a ``(u, T)`` pair); ``forcing_ct(n, c)``
        receives the cotangent of step n's velocity forcing."""
        bm = self.sem.bm[..., None]
        ct = self.fields(ct_u)
        for n in reversed(range(nsteps)):
            ct_df, ct_E = self._stage(min(n, 2), ct)(ct)
            c = self._explicit_t(n, ct_E)
            if self.coupled:
                ct = ((ct_df[0] + c[0],) + tuple(ct_df[1:4]) + (ct_df[4] + c[1],)
                      + tuple(ct_df[5:]))
                ct_E = ct_E[0]
            else:
                ct = (ct_df[0] + c,) + tuple(ct_df[1:])
            if forcing_ct is not None:
                forcing_ct(n, bm * ct_E)
        return self.out(ct)


def _on(s, x: torch.Tensor) -> torch.Tensor:
    return x.to(device=s.device, dtype=s.dtype)


def _coupled_base(ns: NavierStokes, base_u: torch.Tensor, base_T) -> Base:
    """The linearization point: the velocity, or with scalars the
    ``(u, T)`` pair (T zero when not given, as in the JAX operators)."""
    s = ns.sem
    if not ns.nscal:
        return _on(s, base_u)
    if base_T is None:
        base_T = torch.zeros(ns.t_shape, dtype=s.dtype, device=s.device)
    return _on(s, base_u), _on(s, base_T)


class LinearizedOperator:
    """Tangent propagator  q -> D Phi_T(base) q  around a frozen steady base
    flow: :class:`TangentSteps` about the one base.  With scalars
    (``ns.nscal > 0``) it acts on ``(u, T)`` pairs about ``(base_u,
    base_T)``.  ``dt`` overrides the stepper's time step (Newton on a
    horizon ``ns.dt`` does not divide).  A forcing hook ``ns.forcing`` is
    linearized at the frozen base and at ``t0`` for every step, as in the
    JAX operator."""

    def __init__(
        self,
        ns: NavierStokes,
        base_u: torch.Tensor,
        base_p: Optional[torch.Tensor] = None,
        nsteps: int = 100,
        t0: float = 0.0,
        dt: Optional[float] = None,
        base_T: Optional[torch.Tensor] = None,
    ):
        s = ns.sem
        self.ns = ns
        self.sem = s
        self.nsteps = int(nsteps)
        self.dt = ns.dt if dt is None else float(dt)
        self.T = self.nsteps * self.dt
        self.t0 = float(t0)
        self.coupled = ns.nscal > 0
        # the tangent does not depend on the base pressure; base_p is kept
        # for call compatibility with the JAX operator
        base = _coupled_base(ns, base_u, base_T)
        self.base_u = base[0] if self.coupled else base
        self.base_T = base[1] if self.coupled else None
        self.steps = TangentSteps(ns, base, self.t0, dt=self.dt)
        self._vjps: Optional[List[Callable]] = None  # built at the first rmatvec

    def matvec(self, q: Base) -> Base:
        """Direct map: nsteps tangent steps from a zero history."""
        return self.steps.integrate(q, self.nsteps)

    # -- adjoint -------------------------------------------------------
    def _mass_weight(self, w: Base) -> Base:
        # the sponge-masked weight bm1s: the inner product the Krylov space
        # uses (algorithms/stability.py velocity_space, coupled_space)
        bm = self.sem.bms[..., None]
        if self.coupled:
            return (w[0] * bm, w[1] * bm)
        return w * bm

    def _mass_unweight(self, w: Base) -> Base:
        # pseudo-inverse of bms (zero inside the sponge, a semi-norm), then
        # the vmask (tmask) projection onto the admissible (homogeneous-BC)
        # subspace: the raw transpose has nonzero rows at Dirichlet input
        # dofs, which the direct map never produces
        bm = self.sem.bms[..., None]
        inv = torch.where(bm > 0, 1.0 / torch.where(bm > 0, bm, torch.ones_like(bm)),
                          torch.zeros_like(bm))
        if self.coupled:
            return (w[0] * inv * self.sem.vmask, w[1] * inv * self.sem.tmask[..., None])
        return w * inv * self.sem.vmask

    def _stage_vjps(self) -> List[Callable]:
        """The transpose of each BDF stage's whole tangent step:
        ``torch.func.vjp`` at the zero history, built once (the step is
        linear, so the vjp does not depend on the point)."""
        if self._vjps is None:
            if self.ns.mixed is not None:
                raise NotImplementedError(
                    "not ported: the adjoint of the legacy mixed-precision step "
                    "(its refined solve is not differentiable)"
                )
            zero = self.steps.fields(self._zero())
            self._vjps = [
                torch.func.vjp(lambda df, k=k: self.steps.step(df, k), zero)[1]
                for k in range(min(self.nsteps, 3))
            ]
        return self._vjps

    def _zero(self) -> Base:
        s = self.sem
        zu = torch.zeros(tuple(s.bm.shape) + (s.ndim,), dtype=s.dtype, device=s.device)
        if self.coupled:
            return zu, torch.zeros(self.ns.t_shape, dtype=s.dtype, device=s.device)
        return zu

    def rmatvec(self, w: Base) -> Base:
        """Adjoint in the (sponge-masked) energy product:
        M* = W^+ M^T W with W = diag(bm1s)."""
        vjps = self._stage_vjps()
        ct = self.steps.fields(self._mass_weight(w))
        for i in reversed(range(self.nsteps)):
            (ct,) = vjps[min(i, 2)](ct)
        return self._mass_unweight(self.steps.out(ct))


def make_tangent_propagator(ns: NavierStokes, nsteps: int) -> Callable:
    """Tangent propagator  ``(base_u, base_p, q, dt) -> M q``  with the base
    flow and dt as arguments (Newton re-linearizes about every iterate).
    The JAX package jit-compiles one function for all bases; here each call
    builds a :class:`LinearizedOperator`, which precomputes nothing."""

    def apply(base_u, base_p, q, dt):
        return LinearizedOperator(ns, base_u, base_p=base_p, nsteps=nsteps,
                                  dt=dt).matvec(q)

    return apply


def make_orbit_tangent_propagator(ns: NavierStokes, nsteps: int,
                                  remat: bool = True) -> Callable:
    """Tangent of the full nonlinear trajectory:  ``(base_u, base_p, q, dt,
    t0) -> D Phi_T(base_u) q``  linearized along the orbit launched from
    ``base_u`` at physical time ``t0`` (fresh state, BDF ramp), the forcing
    hook at each step's time.  Each call integrates and stores the orbit,
    then replays the tangent along it, as the JAX function recomputes the
    primal inside every call; to apply one linearization many times, hold a
    :class:`TangentSteps` (``along_orbit``) or a :class:`FloquetOperator`.
    ``remat`` is accepted for the JAX signature: the orbit is stored,
    ``nsteps`` x the velocity field."""

    def apply(base_u, base_p, q, dt, t0=0.0):
        steps = TangentSteps.along_orbit(ns, base_u, base_p, nsteps, dt=float(dt),
                                         t0=float(t0))
        return steps.integrate(q, nsteps)

    return apply


class FloquetOperator:
    """Tangent propagator around a *periodic* base orbit (the reference's
    Floquet path: orbit store/replay, core/matvec.f90:189-231): the orbit
    launched from ``base_u`` at ``t0`` with the stepper's ``dt`` is stored
    at the first application (``monodromy_drift`` = ||Phi_T(base) - base||
    then), and every matvec replays the tangent along it.  ``rmatvec`` is
    the adjoint in the sponge-masked energy product, ``M* = W^+ M^T W``
    with ``W = diag(bms)``, as :class:`LinearizedOperator`'s.  With scalars
    it acts on ``(u, T)`` pairs along the orbit launched from ``(base_u,
    base_T)`` and stores ``T`` beside ``u``; ``monodromy_drift`` measures
    the velocity, as JAX's.  ``remat`` is accepted for the JAX signature
    (the orbit is stored)."""

    def __init__(
        self,
        ns: NavierStokes,
        base_u: torch.Tensor,
        base_p: Optional[torch.Tensor] = None,
        nsteps: int = 100,
        t0: float = 0.0,
        remat: bool = True,
        base_T: Optional[torch.Tensor] = None,
    ):
        self.ns = ns
        self.sem = ns.sem
        self.nsteps = int(nsteps)
        self.T = self.nsteps * ns.dt
        self.t0 = float(t0)
        self.coupled = ns.nscal > 0
        self._base = _coupled_base(ns, base_u, base_T)
        self.base_u = self._base[0] if self.coupled else self._base
        self.base_p = base_p
        self._steps: Optional[TangentSteps] = None

    def _orbit(self) -> TangentSteps:
        if self._steps is None:
            self._steps = TangentSteps.along_orbit(self.ns, self._base, self.base_p,
                                                   self.nsteps, t0=self.t0)
            final = self._steps.final[0] if self.coupled else self._steps.final
            self.monodromy_drift = float(self.sem.norm(final - self.base_u))
        return self._steps

    def matvec(self, q: Base) -> Base:
        return self._orbit().integrate(q, self.nsteps)

    # sponge-masked energy weighting, as in LinearizedOperator
    _mass_weight = LinearizedOperator._mass_weight
    _mass_unweight = LinearizedOperator._mass_unweight

    def rmatvec(self, w: Base) -> Base:
        steps = self._orbit()
        ct = steps.transpose(self._mass_weight(w), self.nsteps)
        return self._mass_unweight(ct)


class FiniteDifferenceOperator:
    """Frechet derivative of the nonlinear propagator by central finite
    differences (the reference's ``forward_finite_difference_map``,
    selected by ``SolverConfig.finite_difference``): a cross-check on the
    exact tangent, direct only (it has no adjoint), velocity only.
    ``order`` = 2 or 4; eps = eps_base (1 + ||base||) / ||q|| per apply."""

    def __init__(
        self,
        ns: NavierStokes,
        base_u: torch.Tensor,
        nsteps: int = 100,
        t0: float = 0.0,
        order: int = 2,
        eps_base: float = 1e-6,
    ):
        if order not in (2, 4):
            raise ValueError("finite-difference order must be 2 or 4")
        s = ns.sem
        self.ns = ns
        self.sem = s
        self.nsteps = int(nsteps)
        self.T = self.nsteps * ns.dt
        self.t0 = float(t0)
        self.order = order
        self.base_u = _on(s, base_u)
        # a +1 floor so a zero or weak base still perturbs at eps_base scale
        self.eps0 = eps_base * (1.0 + float(s.norm(self.base_u)))

    def _prop(self, u0: torch.Tensor) -> torch.Tensor:
        return self.ns.propagator(u0, self.nsteps, time0=self.t0)

    def matvec(self, q: torch.Tensor) -> torch.Tensor:
        q = _on(self.sem, q)
        eps = self.eps0 / max(float(self.sem.norm(q)), 1e-30)
        b = self.base_u
        fp, fm = self._prop(b + eps * q), self._prop(b - eps * q)
        if self.order == 2:
            return (fp - fm) / (2.0 * eps)
        fp2, fm2 = self._prop(b + 2.0 * eps * q), self._prop(b - 2.0 * eps * q)
        return (-fp2 + 8.0 * fp - 8.0 * fm + fm2) / (12.0 * eps)

    def rmatvec(self, w):
        raise NotImplementedError(
            "the finite-difference propagator has no adjoint (direct matvec only)")
