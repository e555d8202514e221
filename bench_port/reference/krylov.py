"""Plain Krylov loops for the control: Arnoldi (classical Gram-Schmidt
with one re-orthogonalisation, as ``eigs`` specifies its step) and
Golub-Kahan bidiagonalisation (as ``svds`` specifies its recurrence), in a
given precision, with the vector operands of every product rounded by
``rnd`` (TF32 for the control of a float32 configuration).  No restarts: a window
stays inside the first factorisation.  Imports neither JAX nor the
program."""

from __future__ import annotations

from typing import Callable, List

import torch


class Space:
    """The sponge-masked energy product in precision ``dtype``."""

    def __init__(self, weight: torch.Tensor, dtype, rnd: Callable):
        self.rnd = rnd
        self.w = weight.to(dtype)[..., None]
        self.dtype = dtype

    def dot(self, a, b):
        return torch.sum(self.rnd(a) * self.rnd(b) * self.w)

    def ortho(self, w, Q: List[torch.Tensor]):
        """CGS of w against Q with one re-orthogonalisation; returns the
        normalised vector."""
        for _ in range(2):
            if Q:
                S = torch.stack(Q)
                h = torch.stack([self.dot(q, w) for q in Q])
                w = w - torch.einsum("k,k...->...", h, self.rnd(S))
        return w / torch.sqrt(self.dot(w, w))


def arnoldi(apply: Callable, x0: torch.Tensor, k_dim: int, space: Space) -> None:
    """k_dim Arnoldi steps from x0 (the basis is built, nothing returned:
    the caller's ``apply`` records what it needs)."""
    Q = [space.ortho(x0.to(space.dtype), [])]
    for _ in range(k_dim):
        Q.append(space.ortho(apply(Q[-1]).to(space.dtype), Q))


def golub_kahan(direct: Callable, adjoint: Callable, x0: torch.Tensor, k_dim: int,
                space: Space) -> None:
    """k_dim Golub-Kahan steps from x0 with full re-orthogonalisation."""
    V = [space.ortho(x0.to(space.dtype), [])]
    U: List[torch.Tensor] = []
    for _ in range(k_dim):
        U.append(space.ortho(direct(V[-1]).to(space.dtype), U))
        V.append(space.ortho(adjoint(U[-1]).to(space.dtype), V))
