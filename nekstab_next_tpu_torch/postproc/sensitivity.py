"""Structural and base-flow sensitivity maps (port of ``biorthogonalize``,
``wave_maker`` and ``bf_sensitivity`` from
``nekstab_next_tpu/postproc/sensitivity.py``; the steady-force sensitivity
and ``delta_forcing`` wait for ROADMAP item 16).

* :func:`biorthogonalize` — normalize the direct mode to unit energy norm and
  rescale the adjoint so <adj, dir>_B = 1.
* :func:`wave_maker` — Giannetti & Luchini (JFM 2007) structural sensitivity
  zeta(x) = |u_dir(x)| |u_adj(x)| after biorthogonalization.
* :func:`bf_sensitivity` — Marquet, Sipp & Jacquin (JFM 2008) base-flow
  sensitivity: transport and production terms, real and imaginary parts.

Complex fields are carried as (re, im) pairs of real (nelem, n, n, ndim)
tensors, as the reference's dRe/dIm/aRe/aIm files."""

from __future__ import annotations

from typing import Tuple

import torch

from .vortex import velocity_gradient


def _cdot(sem, x_re, x_im, y_re, y_im) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hermitian energy product <x, y> = sum_d <conj(x_d), y_d>_B."""
    nd = x_re.shape[-1]
    re = sum(
        sem.inner(x_re[..., d], y_re[..., d]) + sem.inner(x_im[..., d], y_im[..., d])
        for d in range(nd)
    )
    im = sum(
        sem.inner(x_re[..., d], y_im[..., d]) - sem.inner(x_im[..., d], y_re[..., d])
        for d in range(nd)
    )
    return re, im


def _cnorm(sem, x_re, x_im) -> torch.Tensor:
    re, _ = _cdot(sem, x_re, x_im, x_re, x_im)
    return torch.sqrt(re)


def biorthogonalize(sem, d_re, d_im, a_re, a_im):
    """Unit-normalize the direct pair; rescale the adjoint pair so that
    <adj, dir>_B = 1.  Returns (d_re, d_im, a_re, a_im)."""
    g = 1.0 / _cnorm(sem, d_re, d_im)
    d_re, d_im = g * d_re, g * d_im
    gamma, delta = _cdot(sem, a_re, a_im, d_re, d_im)
    den = gamma**2 + delta**2
    new_re = (gamma * a_re - delta * a_im) / den
    new_im = (gamma * a_im + delta * a_re) / den
    return d_re, d_im, new_re, new_im


def wave_maker(sem, d_re, d_im, a_re, a_im) -> torch.Tensor:
    """zeta(x) = |u_dir| |u_adj| after biorthogonalization (wm_ field)."""
    d_re, d_im, a_re, a_im = biorthogonalize(sem, d_re, d_im, a_re, a_im)
    nd = torch.sqrt(torch.sum(d_re**2 + d_im**2, dim=-1))
    na = torch.sqrt(torch.sum(a_re**2 + a_im**2, dim=-1))
    return nd * na


def bf_sensitivity(sem, d_re, d_im, a_re, a_im) -> dict:
    """Marquet base-flow sensitivity; returns the six reference output fields
    {tr, ti, pr, pi, sr, si} as (nelem, n, n, ndim) tensors.

    With complex d = d_re + i d_im, a = a_re + i a_im and X_b = sum_i
    conj(a_i) d(d_i)/dx_b (transport), P_b = sum_j conj(d_j) d(a_b)/dx_j
    (production):  tr = -Re X, ti = Im X, pr = Re P, pi = Im P."""
    d_re, d_im, a_re, a_im = biorthogonalize(sem, d_re, d_im, a_re, a_im)

    Gd_re = velocity_gradient(sem, d_re)  # (..., i, b) = d(d_i)/dx_b
    Gd_im = velocity_gradient(sem, d_im)
    Ga_re = velocity_gradient(sem, a_re)
    Ga_im = velocity_gradient(sem, a_im)

    # transport: X_b = sum_i conj(a_i) Gd[i, b]
    X_re = torch.einsum("...i,...ib->...b", a_re, Gd_re) + torch.einsum(
        "...i,...ib->...b", a_im, Gd_im
    )
    X_im = torch.einsum("...i,...ib->...b", a_re, Gd_im) - torch.einsum(
        "...i,...ib->...b", a_im, Gd_re
    )
    # production: P_b = sum_j conj(d_j) Ga[b, j]
    P_re = torch.einsum("...j,...bj->...b", d_re, Ga_re) + torch.einsum(
        "...j,...bj->...b", d_im, Ga_im
    )
    P_im = torch.einsum("...j,...bj->...b", d_re, Ga_im) - torch.einsum(
        "...j,...bj->...b", d_im, Ga_re
    )

    out = dict(tr=-X_re, ti=X_im, pr=P_re, pi=P_im)
    out["sr"] = out["tr"] + out["pr"]
    out["si"] = out["ti"] + out["pi"]
    return out
