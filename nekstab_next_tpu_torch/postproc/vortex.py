"""The velocity-gradient tensor (port of ``velocity_gradient`` from
``nekstab_next_tpu/postproc/vortex.py``; the vortex criteria wait for
ROADMAP item 16)."""

from __future__ import annotations

import torch


def velocity_gradient(sem, u: torch.Tensor, smooth: bool = True) -> torch.Tensor:
    """G[..., a, b] = du_a/dx_b, shape (nelem, n, n, 2, 2), made C0 by
    dsavg when ``smooth``."""
    cols = []
    for a in range(u.shape[-1]):
        gx, gy = sem.grad(u[..., a])
        cols.append(torch.stack([gx, gy], dim=-1))
    G = torch.stack(cols, dim=-2)
    if smooth:
        G = sem.dsavg(G)
    return G
