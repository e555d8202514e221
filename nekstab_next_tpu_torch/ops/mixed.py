"""Mixed-precision elliptic solves: float32 inner CG + float64 iterative
refinement (port of ``nekstab_next_tpu/ops/mixed.py``, the legacy mixed path).

    repeat:  r  = b - A x            (f64, exact residual)
             dx = CG_f32(A32, r)     (inner solve, fused local apply K4)
             x  = x + dx             (f64 accumulate)

Each cycle multiplies the error by the inner solve's relative accuracy
(~1e-5..1e-6), so 2-3 cycles reach 1e-10.  The inner operator is the
assembled projected operator of ``ops/elliptic.py`` with the local Helmholtz
apply replaced by :class:`~.fused_helmholtz.FusedHelmholtz` (a CUDA kernel
on the card) and the FDM / Q1-coarse preconditioners in float32.

The JAX package wraps the refined solve in
``lax.custom_linear_solve(symmetric=True)``; the port runs it inside
:class:`~.cg.SymmetricSolve`, so the transpose of the solve (the adjoint
step's backward) is the same refined solve on the cotangent, K4 launches
included, and the tangent step (``stepper/linearized.py``) calls
:func:`elliptic_solve_mixed` on the tangent right-hand side directly.
``lax.scan`` over the cycles becomes a Python loop.

Not on a shard view (``parallel/sharded.py``): a sharded stepper with
``mixed_precision=True`` raises, because the JAX reference cannot trace
it either (``FusedHelmholtz.padfield`` converts the shard-local geometry
to numpy inside ``shard_map``, ``nekstab_next_tpu/ops/pallas_kernels.py:153``),
so there is nothing to hold a port to.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .cg import SymmetricSolve, pcg
from .elliptic import make_projector
from .fused_helmholtz import FusedHelmholtz

_f32 = torch.float32
_f64 = torch.float64
INNER_TOL = 3e-6  # relative tolerance of each f32 inner CG solve
CYCLES = 3  # refinement cycles per solve


class MixedPrecision:
    """Float32 solve context for one SEM/SEM3: the fused Helmholtz apply
    (K4) + float32 copies of the FDM and Q1-coarse preconditioner constants."""

    def __init__(self, sem):
        self.sem = sem
        self.fused = FusedHelmholtz(sem)
        self.ndim = sem.ndim
        f = lambda a: a.to(_f32)
        self.S32 = f(sem.fdm_S)
        self.lam32 = f(sem.fdm_lam)
        self.len32 = f(sem.fdm_len)
        self.inv_mult32 = f(sem.inv_mult)
        self.Jc32 = f(sem.pc_Jc)
        self.Acinv32 = f(sem.pc_Acinv)

    # -- local applies ---------------------------------------------------
    def helmholtz32(self, u: torch.Tensor, h1, h2) -> torch.Tensor:
        """Fused f32 local Helmholtz; accepts a trailing component axis, all
        components in one kernel launch."""
        return self.fused.apply(u.contiguous(), h1, h2)

    def fdm32(self, r: torch.Tensor, h1, h2) -> torch.Tensor:
        """f32 twin of ``SEM.fdm_apply`` / ``SEM3.fdm_apply`` (threshold
        1e-6 ref, as the JAX package's)."""
        S, lam = self.S32, self.lam32
        h1 = float(h1)
        h2 = float(h2)
        if self.ndim == 2:
            a = self.len32[:, 0][:, None, None]
            b = self.len32[:, 1][:, None, None]
            denom = h1 * ((b / a) * lam[:, None] + (a / b) * lam[None, :]) + h2 * (a * b)
            ref = h1 * (b / a + a / b) * lam[1] + h2 * (a * b)
            inv = torch.where(denom > 1e-6 * ref, 1.0 / denom.clamp_min(1e-30), 1.0 / ref)
            inv = inv.reshape(tuple(inv.shape) + (1,) * (r.dim() - 3))
            t = torch.einsum("ia,jb,eij...->eab...", S, S, r)
            return torch.einsum("ia,jb,eab...->eij...", S, S, t * inv)
        a = self.len32[:, 0][:, None, None, None]
        b = self.len32[:, 1][:, None, None, None]
        c = self.len32[:, 2][:, None, None, None]
        denom = h1 * ((b * c / a) * lam[:, None, None] + (a * c / b) * lam[None, :, None]
                      + (a * b / c) * lam[None, None, :]) + h2 * (a * b * c)
        ref = h1 * (b * c / a + a * c / b + a * b / c) * lam[1] + h2 * (a * b * c)
        inv = torch.where(denom > 1e-6 * ref, 1.0 / denom.clamp_min(1e-30), 1.0 / ref)
        inv = inv.reshape(tuple(inv.shape) + (1,) * (r.dim() - 4))
        t = torch.einsum("ia,jb,kc,eijk...->eabc...", S, S, S, r)
        return torch.einsum("ia,jb,kc,eabc...->eijk...", S, S, S, t * inv)

    def coarse32(self, r: torch.Tensor) -> torch.Tensor:
        """f32 twin of ``coarse_apply_pressure`` (vertex sums gathered over
        the SEM's vertex table in table order)."""
        sem = self.sem
        sub = "cij,eij->ec" if self.ndim == 2 else "cijk,eijk->ec"
        rc_e = torch.einsum(sub, self.Jc32, r).reshape(-1)
        ext = torch.cat([rc_e, rc_e.new_zeros(1)])
        rc = ext[sem._vtx_table].sum(dim=1)
        xc = self.Acinv32 @ rc
        back = "cij,ec->eij" if self.ndim == 2 else "cijk,ec->eijk"
        return torch.einsum(back, self.Jc32, xc[sem.pc_cid])

    # -- assembled operator / projector in f32 ----------------------------
    def assembled32(self, mask: torch.Tensor, h1, h2):
        sem = self.sem
        mask32 = mask.to(_f32)
        bc = sem._bc

        def P32(x):
            y = mask32 * x
            return mask32 * (sem.dssum(y) * bc(self.inv_mult32, y))

        def A32(x):
            Px = P32(x)
            return P32(self.helmholtz32(Px, h1, h2)) + (x - Px)

        return A32, P32

    @staticmethod
    def dot32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """f32 dot product accumulated in f64."""
        return torch.sum((a * b).to(_f64)).to(_f32)

    # -- the refined solve -------------------------------------------------
    def ir_solve(
        self,
        mask: torch.Tensor,
        h1,
        h2,
        A64: Callable,
        rhs: torch.Tensor,
        maxiter: int,
        coarse: bool = False,
        project: Optional[Callable] = None,
        cycles: Optional[int] = None,
    ) -> torch.Tensor:
        """Iteratively refined solve of the assembled system A64 x = rhs,
        preconditioned by the f32 FDM (+ Q1 coarse) blocks.  ``rhs`` must
        already be projected (range of P, nullspace removed)."""
        A32, P32 = self.assembled32(mask, h1, h2)

        def precond32(r):
            Pr = P32(r)
            z = self.fdm32(Pr, h1, h2)
            if coarse:
                z = z + self.coarse32(Pr)
            return P32(z) + (r - Pr)

        ncyc = CYCLES if cycles is None else cycles
        x = torch.zeros_like(rhs)
        r = rhs
        for cyc in range(ncyc):
            dx = pcg(A32, r.to(_f32), precond=precond32, tol=INNER_TOL,
                     maxiter=maxiter, dot=self.dot32).to(_f64)
            if project is not None:
                dx = project(dx)
            x = x + dx
            # the JAX scan also forms the residual after the last cycle,
            # where nothing reads it
            if cyc + 1 < ncyc:
                r = rhs - A64(x)
                if project is not None:
                    r = project(r)
        return x


def elliptic_solve_mixed(
    sem,
    mixed: MixedPrecision,
    h1,
    h2,
    rhs_local: torch.Tensor,
    mask: torch.Tensor,
    maxiter: int,
    project_mean: bool = False,
    coarse: bool = False,
    cycles: Optional[int] = None,
) -> torch.Tensor:
    """Mixed-precision twin of ``ops.elliptic.elliptic_solve`` for Helmholtz
    operators (local op = h1 K + h2 B): solves ``A x = P rhs_local`` with
    ``A = P (h1 K + h2 B) P + (I - P)``, ``P = mask dsavg mask``.
    Differentiable in ``rhs_local``: the refined solve is symmetric, so its
    transpose is itself (:class:`~.cg.SymmetricSolve`)."""
    P = make_projector(sem, mask)

    def helm64(u):
        if u.dim() == sem.ndim + 2:  # trailing velocity-component axis
            return torch.stack(
                [sem.helmholtz_local(u[..., d], h1, h2) for d in range(u.shape[-1])],
                dim=-1,
            )
        return sem.helmholtz_local(u, h1, h2)

    def A(x):
        Px = P(x)
        return P(helm64(Px)) + (x - Px)

    rhs = P(rhs_local)

    dot = lambda a, b: torch.sum(a * b)
    project = None
    if project_mean:
        ones = torch.ones_like(rhs)
        csq = dot(ones, ones)

        def project(q):
            return q - (dot(q, ones) / csq) * ones

    def solve(b):
        if project is not None:
            b = project(b)
        x = mixed.ir_solve(mask, h1, h2, A, b, maxiter, coarse=coarse,
                           project=project, cycles=cycles)
        return x if project is None else project(x)

    # symmetric: the backward is the same refined solve on the cotangent
    return SymmetricSolve.apply(rhs, solve)
