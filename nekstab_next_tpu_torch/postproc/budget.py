"""Perturbation kinetic-energy budget (port of
``nekstab_next_tpu/postproc/budget.py``; the reference's
``stability_energy_budget`` with ``compute_production`` and
``compute_dissipation``).

For a complex eigenmode u' = uRe + i uIm around a base flow U:

* production: P_ab = -1/2 Re(u'_a conj(u'_b)) dU_a/dx_b, the full
  (..., ndim, ndim) tensor plus its integrals;
* dissipation: D = 1/2 nu Re(conj(u') . Laplacian(u')), the Laplacian as
  repeated C0-smoothed gradients (the reference's ``compute_laplacian``).

The budget identity sigma ~ (sum P - |D|) / (2 E) is the growth-rate check
the reference prints per mode into its ``PKE_*`` files.  2-D layout."""

from __future__ import annotations

import dataclasses

import torch

from .vortex import velocity_gradient


@dataclasses.dataclass
class EnergyBudget:
    production: torch.Tensor  # (nelem, n, n, ndim, ndim) pointwise P_ab
    dissipation: torch.Tensor  # (nelem, n, n) pointwise D
    production_integrals: torch.Tensor  # (ndim, ndim)
    dissipation_integral: torch.Tensor  # ()

    @property
    def total_production(self) -> torch.Tensor:
        return torch.sum(self.production_integrals)

    @property
    def net(self) -> torch.Tensor:
        """The sum of the production integrals minus the dissipation."""
        return self.total_production - self.dissipation_integral


def _laplacian(sem, f: torch.Tensor) -> torch.Tensor:
    """Repeated smoothed gradients (the reference's compute_laplacian)."""
    gx, gy = sem.grad(f)
    gx, gy = sem.dsavg(gx), sem.dsavg(gy)
    gxx, _ = sem.grad(gx)
    _, gyy = sem.grad(gy)
    return sem.dsavg(gxx) + sem.dsavg(gyy)


def energy_budget(
    sem,
    base_u: torch.Tensor,
    mode_re: torch.Tensor,
    mode_im: torch.Tensor,
    viscosity: float,
    normalize: bool = True,
) -> EnergyBudget:
    """Production + dissipation of one complex mode."""
    if normalize:
        # unit energy norm of the complex pair
        e = torch.sqrt(sum(
            sem.inner(mode_re[..., d], mode_re[..., d])
            + sem.inner(mode_im[..., d], mode_im[..., d])
            for d in range(mode_re.shape[-1])))
        mode_re = mode_re / e
        mode_im = mode_im / e

    ndim = base_u.shape[-1]
    GU = velocity_gradient(sem, base_u)  # dU_a/dx_b
    # Re(u'_a conj(u'_b))
    uu = mode_re[..., :, None] * mode_re[..., None, :] + mode_im[..., :, None] * mode_im[..., None, :]
    prod = -0.5 * uu * GU

    diss = torch.zeros(tuple(base_u.shape[:-1]), dtype=base_u.dtype, device=base_u.device)
    for d in range(ndim):
        diss = diss + (mode_re[..., d] * _laplacian(sem, mode_re[..., d])
                       + mode_im[..., d] * _laplacian(sem, mode_im[..., d]))
    diss = 0.5 * viscosity * diss

    pint = torch.stack([
        torch.stack([sem.glsum(sem.bm * prod[..., a, b]) for b in range(ndim)])
        for a in range(ndim)
    ])
    return EnergyBudget(
        production=prod,
        dissipation=diss,
        production_integrals=pint,
        dissipation_integral=sem.glsum(sem.bm * diss),
    )
