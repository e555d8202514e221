"""Assembled SPD elliptic solves (port of ``nekstab_next_tpu/ops/elliptic.py``).

The assembled operator is conjugated with the Euclid-orthogonal projector
onto the continuous-and-unmasked subspace,

    P = mask . dsavg . mask,      A = P K_local P + (I - P),

so ``A`` is Euclid-SPD and on ``range(P)`` the system ``A x = P r_local`` is
exactly the assembled Galerkin system.  The CG iteration runs in ``range(P)``
with ``A_sub = P K_local`` (one gather-scatter per apply)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .cg import cg_solve


def make_projector(sem, mask: torch.Tensor) -> Callable:
    def P(x):
        return mask * sem.dsavg(mask * x)

    return P


def elliptic_solve(
    sem,
    local_op: Callable,
    rhs_local: torch.Tensor,
    mask: torch.Tensor,
    tol: float,
    maxiter: int,
    diag_local: Optional[torch.Tensor] = None,
    project_mean: bool = False,
    fdm: Optional[tuple] = None,
    coarse: bool = False,
    vblocks=None,
    fused_solve: Optional[Callable] = None,
    ir_cycles: int = 0,
) -> torch.Tensor:
    """Solve the assembled system  (P local_op P) x = P rhs_local  by PCG.

    ``local_op``   : unassembled element-local SPD weak operator
    ``rhs_local``  : unassembled local weak RHS (will be P-projected)
    ``mask``       : 1 = free dof, 0 = Dirichlet (may carry component axes)
    ``diag_local`` : local diagonal of ``local_op`` (Jacobi preconditioner)
    ``project_mean``: remove the constant nullspace (pure-Neumann Poisson)
    ``fdm``        : (h1, h2) — FDM block preconditioner instead of Jacobi
    ``coarse``     : with ``fdm``, add the Q1 vertex coarse correction
    ``vblocks``    : (ndim, nelem, nloc, nloc) exact velocity block inverses
                     (ops/schwarz.py), used before ``fdm`` and Jacobi
    ``fused_solve``: the whole subspace CG as one call (ops/fused_cg.py)
    ``ir_cycles``  : with ``fused_solve``, that many cycles of iterative
                     refinement around it (ops/cg.py ``cg_solve``)
    """
    P = make_projector(sem, mask)

    def A(x):
        Px = P(x)
        return P(local_op(Px)) + (x - Px)

    rhs = P(rhs_local)
    dot = lambda a, b: torch.sum(a * b)

    def A_sub(x):
        return P(local_op(x))

    if vblocks is not None:
        # exact element-block inverses of the assembled operator
        # (ops/schwarz.py build_velocity_blocks), one batched matmul a
        # component
        from .schwarz import velocity_block_apply

        def M_sub(r):
            return P(velocity_block_apply(vblocks, r))

    elif fdm is not None:
        h1, h2 = fdm

        def M_sub(r):
            z = sem.fdm_apply(r, h1, h2)
            if coarse:
                z = z + sem.coarse_apply_pressure(r)
            return P(z)

    elif diag_local is not None:
        dinv = 1.0 / sem.dssum(diag_local)
        if dinv.dim() < rhs.dim():
            dinv = dinv.reshape(tuple(dinv.shape) + (1,) * (rhs.dim() - dinv.dim()))

        def M_sub(r):
            return P(dinv * r)

    else:
        M_sub = None

    project = None
    if project_mean:
        ones = torch.ones_like(rhs)
        csq = dot(ones, ones)

        def project(q):
            return q - (dot(q, ones) / csq) * ones

    return cg_solve(
        A, rhs, tol=tol, maxiter=maxiter, dot=dot, project=project,
        inner_op=(A_sub, P, M_sub), fused_solve=fused_solve, ir_cycles=ir_cycles,
    )
