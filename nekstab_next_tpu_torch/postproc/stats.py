"""Running time-averages / statistics (port of
``nekstab_next_tpu/postproc/stats.py``; the reference's ``nekStab_avg``,
Nek's avg/rms/rm2 machinery).

Time-weighted accumulation of mean, squared mean, and cross products:

    avg <- (atime * avg + dt * f) / (atime + dt)

on the device; ``atime`` is a host float."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RunningStats:
    """avg(u), rms(u) = avg(u*u), rm2 = avg(u_a u_b) cross products."""

    avg: torch.Tensor  # (nelem, n, n, nc)
    rms: torch.Tensor  # (nelem, n, n, nc)
    rm2: torch.Tensor  # (nelem, n, n, npairs) cross products uv[, uw, vw]
    atime: float = 0.0  # accumulated averaging time

    @classmethod
    def zeros(cls, shape, nc: int, dtype=torch.float64, device=None) -> "RunningStats":
        npairs = nc * (nc - 1) // 2
        z = lambda k: torch.zeros(tuple(shape) + (k,), dtype=dtype, device=device)
        return cls(avg=z(nc), rms=z(nc), rm2=z(max(npairs, 1)), atime=0.0)

    def update(self, u: torch.Tensor, dt: float) -> "RunningStats":
        """Accumulate one sample with weight dt."""
        newt = self.atime + float(dt)
        beta = float(dt) / newt
        alpha = 1.0 - beta
        nc = u.shape[-1]
        pairs = [u[..., a] * u[..., b] for a in range(nc) for b in range(a + 1, nc)]
        cross = torch.stack(pairs, dim=-1) if pairs else torch.zeros_like(self.rm2)
        return RunningStats(
            avg=alpha * self.avg + beta * u,
            rms=alpha * self.rms + beta * u * u,
            rm2=alpha * self.rm2 + beta * cross,
            atime=newt,
        )

    def variance(self) -> torch.Tensor:
        """rms - avg^2 (per component)."""
        return self.rms - self.avg * self.avg
