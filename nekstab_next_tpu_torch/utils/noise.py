"""Deterministic noise seeding for Krylov starts (port of
``nekstab_next_tpu/utils/noise.py``).

A seeded numpy generator draws the raw field on the host, as in the JAX
package, so both packages start their Krylov runs from the same vector; it
is then made C0 (dsavg) and masked on the device."""

from __future__ import annotations

import numpy as np
import torch


def velocity_noise(sem, seed: int = 1234, amplitude: float = 1.0) -> torch.Tensor:
    """C0, BC-compatible random velocity field (nelem, n, n[, n], ndim).  On
    a shard view (``parallel/sharded.py``) the whole mesh's field is drawn
    and this rank's elements kept, so a sharded seed is the single-device
    seed, sharded."""
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal((sem.nelem_total,) + tuple(sem.bm.shape[1:]) + (sem.ndim,))
    raw = raw[sem.elem_offset:sem.elem_offset + sem.nelem]
    q = torch.as_tensor(raw, dtype=sem.dtype, device=sem.device)
    q = sem.dsavg(q)  # make C0
    q = sem.vmask * q  # honor Dirichlet/symmetry masks
    return amplitude * q


def symmetric_seed(sem, amplitude: float = 1.0) -> torch.Tensor:
    """Smooth deterministic trigonometric seed (the reference's
    ``add_symmetric_seed``): u_x = cos(2 pi z^) sin(2 pi y^),
    u_z = -cos(2 pi z^) cos(2 pi y^) on coordinates scaled to the domain;
    2-D keeps u_x = sin(2 pi y^).  Energy-normalized.  Needs ``sem.mesh``."""
    m = sem.mesh
    y = np.asarray(m.y)
    yh = (y - y.min()) / max(y.max() - y.min(), 1e-30)
    q = np.zeros(tuple(sem.bm.shape) + (sem.ndim,))
    if sem.ndim == 3:
        z = np.asarray(m.z)
        zh = (z - z.min()) / max(z.max() - z.min(), 1e-30)
        q[..., 0] = np.cos(2 * np.pi * zh) * np.sin(2 * np.pi * yh)
        q[..., 2] = -np.cos(2 * np.pi * zh) * np.cos(2 * np.pi * yh)
    else:
        q[..., 0] = np.sin(2 * np.pi * yh)
    q = sem.vmask * sem.dsavg(torch.as_tensor(q, dtype=sem.dtype, device=sem.device))
    e = torch.sqrt(sum(sem.inner(q[..., d], q[..., d], masked=False)
                       for d in range(sem.ndim)))
    return amplitude * q / e.clamp_min(1e-30)


def make_seed(
    sem,
    mode: str = "noise",
    seed: int = 1234,
    path: str = None,
    base_u=None,
    amplitude: float = 1.0,
) -> torch.Tensor:
    """Krylov seed dispatcher: 'noise' | 'symmetric' | 'load' (a field file
    written by :func:`~nekstab_next_tpu_torch.io.save_field`, or the JAX
    package's) | 'baseflow' (the base flow, Dirichlet-masked)."""
    if mode == "noise":
        return velocity_noise(sem, seed=seed, amplitude=amplitude)
    if mode == "symmetric":
        return symmetric_seed(sem, amplitude=amplitude)
    if mode == "load":
        if path is None:
            raise ValueError("seed mode 'load' needs a file path")
        from ..io import load_field

        u = torch.as_tensor(load_field(path).u, dtype=sem.dtype, device=sem.device)
        return amplitude * sem.vmask * u
    if mode == "baseflow":
        if base_u is None:
            raise ValueError("seed mode 'baseflow' needs the base flow")
        return amplitude * sem.vmask * base_u.to(device=sem.device, dtype=sem.dtype)
    raise ValueError(
        f"unknown seed mode {mode!r}; expected noise|symmetric|load|baseflow"
    )
