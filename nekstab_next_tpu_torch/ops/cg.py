"""Matrix-free preconditioned conjugate gradient + the solve wrapper.

Port of ``nekstab_next_tpu/ops/cg.py``.  The JAX package wraps every inner
solve in ``lax.custom_linear_solve(symmetric=True)``; the port wraps it in
:class:`SymmetricSolve`, a ``torch.autograd.Function`` whose backward (and
forward-mode ``jvp``) is the same solve applied to the cotangent (tangent)
right-hand side.  The CG loop, its early exit and live mask run inside the
Function's forward and are never recorded.  Only the right-hand side is
differentiated: the derivative with respect to the operator
(``dx = A^-1 (db - dA x)``, needed when the step depends on a varying
``dt``) is not ported.  The direct tangent step is written out
(``stepper/linearized.py``) and calls the same solve without a tape.

Iterative refinement (``ir_cycles``, the fused-IR mixed-precision path):
the state stays in float64 and a fused float32 solve (ops/fused_cg.py) is
the inner solve of ``ir_cycles`` refinement cycles, each against the f64
operator.  ``SolverConfig.mixed_ir_cycles`` sets the count and defaults to
2 (the JAX docstring's "3 cycles" is not what its config ships).  The
cycles run inside :class:`SymmetricSolve`, so the tangent and the adjoint
of a refined solve are the same refined solve, as JAX's
``custom_linear_solve`` gives them.

Spans (``utils/tracing.py``): ``solve.inner`` around each inner solve
(``pcg``, or a fused kernel's launch with its casts) and
``solve.residual`` around each later refinement cycle's residual with its
projection.

Not ported (TPU workarounds): the lanes layout, ``unroll`` and
``cg_fixed_iters``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils import tracing


def _sdiv(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """a / d where d > 0, else 0 (CG breakdown guard)."""
    pos = d > 0
    return torch.where(pos, a / torch.where(pos, d, torch.ones_like(d)),
                       torch.zeros_like(a))


# how often (in iterations) pcg reads its live mask on the host
_CHECK_EVERY = 8


def pcg(
    operator: Callable,
    b: torch.Tensor,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    maxiter: int = 500,
    dot: Optional[Callable] = None,
    return_iters: bool = False,
):
    """Preconditioned CG on an SPD operator, with early exit on
    ||r|| <= tol * ||b|| and at most ``maxiter`` iterations.  Returns the
    solution, or ``(x, k)`` with ``k`` the number of live iterations when
    ``return_iters``.

    Each iteration is live-masked: once the residual test fails, alpha and
    beta are zero and the iterate freezes.  The mask is essential, not an
    optimization: letting CG iterate past its (f32) attainable accuracy turns
    beta into amplified rounding noise and the iterate drifts away (measured
    7e-2 on the 50-step tangent matvec without it, JAX package).  Because a
    frozen iteration changes nothing, the host leaves the loop once the mask
    is off; it reads the mask every ``_CHECK_EVERY`` iterations, so a solve
    on a GPU syncs the host that often and no more."""
    if precond is None:
        precond = lambda r: r
    if dot is None:
        dot = lambda a, c: torch.sum(a * c)

    bnorm = torch.sqrt(dot(b, b))
    atol2 = (tol * bnorm.clamp_min(1e-300)) ** 2

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    rz = dot(r, z)
    p = z
    k = torch.zeros((), dtype=torch.int64, device=b.device)

    for it in range(maxiter):
        live = dot(r, r) > atol2
        if it % _CHECK_EVERY == 0 and not bool(live):
            break
        k = k + live
        Ap = operator(p)
        alpha = torch.where(live, _sdiv(rz, dot(p, Ap)), torch.zeros_like(rz))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(live, _sdiv(rz_new, rz), torch.zeros_like(rz))
        p = torch.where(live, z + beta * p, p)
        rz = torch.where(live, rz_new, rz)
    return (x, int(k)) if return_iters else x


class SymmetricSolve(torch.autograd.Function):
    """``x = solve(b)`` for a linear solve with a symmetric operator: the
    transpose (and the tangent) of the solve is the solve itself.  The
    cotangent goes in contiguous, as the fused kernels take it."""

    @staticmethod
    def forward(b, solve):
        return solve(b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.solve = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ctx.solve(g.contiguous()), None

    @staticmethod
    def jvp(ctx, db, _):
        return ctx.solve(db.contiguous())


def cg_solve(
    operator: Callable,
    b: torch.Tensor,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    maxiter: int = 500,
    dot: Optional[Callable] = None,
    project: Optional[Callable] = None,
    inner_op: Optional[tuple] = None,
    fused_solve: Optional[Callable] = None,
    ir_cycles: int = 0,
) -> torch.Tensor:
    """Solve the SPD system A x = b.

    ``project`` (optional) is an idempotent symmetric projection applied to
    both RHS and solution (removes the constant nullspace of a pure-Neumann
    pressure operator).

    ``inner_op`` (optional) is ``(A_sub, P, M_sub)``: a cheaper operator
    equal to ``operator`` on ``range(P)`` (on whose complement ``operator``
    is the identity), the projector itself, and a preconditioner mapping
    ``range(P)`` into itself.  The CG iteration runs in ``range(P)``; the
    complement part of the RHS passes through unchanged.

    ``fused_solve`` (optional): the whole iteration as one call
    (ops/fused_cg.py) — the same subspace solve.  With ``ir_cycles > 0`` it
    is the inner solve of that many cycles of iterative refinement
    (:func:`_refined`) against ``A_sub`` on ``range(P)`` when ``inner_op``
    is given, else against ``operator``.

    Differentiable in ``b`` (:class:`SymmetricSolve`): the backward pass
    runs the same solve on the cotangent, through ``fused_solve`` when one
    is given."""
    return SymmetricSolve.apply(b, lambda rhs: _solve(
        operator, rhs, precond, tol, maxiter, dot, project, inner_op, fused_solve,
        ir_cycles))


def _refined(inner: Callable, A: Callable, rhs: torch.Tensor, cycles: int,
             project: Optional[Callable]) -> torch.Tensor:
    """Iterative refinement: ``cycles`` inner solves, each of the residual
    against ``A`` at the precision of ``rhs`` (the first takes ``rhs``
    itself), with ``project`` applied to every residual and correction."""
    x = torch.zeros_like(rhs)
    r = rhs
    for i in range(cycles):
        if i:
            with tracing.span("solve.residual"):
                r = rhs - A(x)
                if project is not None:
                    r = project(r)
        elif project is not None:
            r = project(r)
        with tracing.span("solve.inner"):
            dx = inner(r)
        if project is not None:
            dx = project(dx)
        x = x + dx
    return x


def _solve(operator, b, precond, tol, maxiter, dot, project, inner_op, fused_solve,
           ir_cycles):
    """The body of :func:`cg_solve`, without autograd."""

    def _iterate(A_it, rhs, M_it):
        if project is not None:
            rhs = project(rhs)
        with tracing.span("solve.inner"):
            x = pcg(A_it, rhs, precond=M_it, tol=tol, maxiter=maxiter, dot=dot)
        return x if project is None else project(x)

    if inner_op is not None:
        A_sub, P, M_sub = inner_op
        rP = P(b)
        comp = b - rP
        if fused_solve is None:
            x = _iterate(A_sub, rP, M_sub)
        elif ir_cycles:
            x = _refined(fused_solve, A_sub, rP, ir_cycles, project)
        else:
            with tracing.span("solve.inner"):
                x = fused_solve(rP)
        return x + comp
    if fused_solve is not None:
        if ir_cycles:
            return _refined(fused_solve, operator, b, ir_cycles, project)
        b = b if project is None else project(b)
        with tracing.span("solve.inner"):
            x = fused_solve(b)
        return x if project is None else project(x)
    return _iterate(operator, b, precond)
