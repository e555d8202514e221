"""Vortex-identification criteria (port of
``nekstab_next_tpu/postproc/vortex.py``: lambda2 / Q / delta / swirling /
omega, the symmetric and antisymmetric magnitudes, the vorticity).

All criteria derive from the velocity-gradient tensor G_ab = du_a/dx_b,
computed per element with the tensor-product derivatives and made C0 by
dsavg.  In 2-D the flow embeds in 3-D with w = d/dz = 0, so S^2 + Omega^2
has one zero eigenvalue and the criteria reduce to closed forms on the 2x2
block; in 3-D lambda2 takes a batched symmetric eigensolve."""

from __future__ import annotations

import torch


def velocity_gradient(sem, u: torch.Tensor, smooth: bool = True) -> torch.Tensor:
    """G[..., a, b] = du_a/dx_b, shape (nelem, n, .., n, ndim, ndim), made
    C0 by dsavg when ``smooth``."""
    cols = []
    for a in range(u.shape[-1]):
        cols.append(torch.stack(sem.grad(u[..., a]), dim=-1))
    G = torch.stack(cols, dim=-2)
    if smooth:
        G = sem.dsavg(G)
    return G


def vorticity(sem, u: torch.Tensor, smooth: bool = True) -> torch.Tensor:
    """Out-of-plane vorticity dv/dx - du/dy (2-D)."""
    w = sem.curl(u[..., 0], u[..., 1])
    return sem.dsavg(w) if smooth else w


def _split(G):
    S = 0.5 * (G + G.transpose(-1, -2))
    W = 0.5 * (G - G.transpose(-1, -2))
    return S, W


def _sq(A: torch.Tensor) -> torch.Tensor:
    return torch.sum(A * A, dim=(-1, -2))


def symmetric_criterion(G: torch.Tensor) -> torch.Tensor:
    """Pointwise strain magnitude |S|, S = (G + G^T)/2."""
    S, _ = _split(G)
    return torch.sqrt(_sq(S))


def antisymmetric_criterion(G: torch.Tensor) -> torch.Tensor:
    """Pointwise rotation magnitude |Omega|, Omega = (G - G^T)/2."""
    _, W = _split(G)
    return torch.sqrt(_sq(W))


def q_criterion(G: torch.Tensor) -> torch.Tensor:
    """Q = (|Omega|^2 - |S|^2) / 2; Q > 0 marks vortex cores."""
    S, W = _split(G)
    return 0.5 * (_sq(W) - _sq(S))


def lambda2_criterion(G: torch.Tensor) -> torch.Tensor:
    """lambda2 of S^2 + Omega^2 (Jeong & Hussain); < 0 marks vortex cores.

    2-D: the 3-D tensor has eigenvalues {mu1, mu2, 0} with mu_i from the 2x2
    block; lambda2 is the median of the three."""
    S, W = _split(G)
    M = S @ S + W @ W
    if G.shape[-1] == 2:
        tr = M[..., 0, 0] + M[..., 1, 1]
        det = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
        disc = torch.sqrt(torch.clamp(0.25 * tr * tr - det, min=0.0))
        mu1 = 0.5 * tr - disc
        mu2 = 0.5 * tr + disc
        # median of {mu1, mu2, 0}
        return torch.sort(torch.stack([mu1, mu2, torch.zeros_like(mu1)], dim=-1),
                          dim=-1).values[..., 1]
    return torch.linalg.eigvalsh(M)[..., 1]  # ascending


def delta_criterion(G: torch.Tensor) -> torch.Tensor:
    """Discriminant of the characteristic polynomial of G; > 0 means complex
    eigenvalues (swirling motion).  2-D: delta = det(G) - (tr G / 2)^2."""
    if G.shape[-1] == 2:
        tr = G[..., 0, 0] + G[..., 1, 1]
        det = G[..., 0, 0] * G[..., 1, 1] - G[..., 0, 1] * G[..., 1, 0]
        return det - 0.25 * tr * tr
    # 3-D: (Q/3)^3 + (R/2)^2 with P = tr G = 0 assumed (incompressible)
    S, W = _split(G)
    Q = 0.5 * (_sq(W) - _sq(S))
    R = -torch.linalg.det(G)
    return (Q / 3.0) ** 3 + (R / 2.0) ** 2


def swirling_strength(G: torch.Tensor) -> torch.Tensor:
    """lambda_ci: imaginary part of the complex eigenvalue pair of G."""
    d = delta_criterion(G)
    if G.shape[-1] == 2:
        return torch.sqrt(torch.clamp(d, min=0.0))
    return torch.sqrt(torch.clamp(d, min=0.0)) ** (1.0 / 3.0)


def omega_criterion(G: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Liu et al. Omega method: |W|^2 / (|W|^2 + |S|^2 + eps); ~1 in cores."""
    S, W = _split(G)
    a, b = _sq(W), _sq(S)
    return a / (a + b + eps)
