"""Structural, base-flow and steady-force sensitivity (port of
``biorthogonalize``, ``wave_maker``, ``bf_sensitivity``, ``delta_forcing``,
``forced_tangent_response`` and ``steady_force_sensitivity`` from
``nekstab_next_tpu/postproc/sensitivity.py``).

* :func:`biorthogonalize` — normalize the direct mode to unit energy norm and
  rescale the adjoint so <adj, dir>_B = 1.
* :func:`wave_maker` — Giannetti & Luchini (JFM 2007) structural sensitivity
  zeta(x) = |u_dir(x)| |u_adj(x)| after biorthogonalization.
* :func:`bf_sensitivity` — Marquet, Sipp & Jacquin (JFM 2008) base-flow
  sensitivity: transport and production terms, real and imaginary parts.
* :func:`delta_forcing` — the eigenvalue drift map of a steady pointwise
  force opposing the local base flow.
* :func:`forced_tangent_response` and :func:`steady_force_sensitivity` —
  the tangent system driven by a constant force, and the time-stepper
  steady linear system on the adjoint propagator (the forced tangent steps
  of ``stepper/linearized.py`` :class:`TangentSteps` and their transpose).

Complex fields are carried as (re, im) pairs of real (nelem, n, n, ndim)
tensors, as the reference's dRe/dIm/aRe/aIm files."""

from __future__ import annotations

from typing import Tuple

import torch

from ..krylov.gmres import gmres
from ..krylov.vector import VectorSpace
from ..stepper.linearized import LinearizedOperator, TangentSteps
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


def delta_forcing(sem, base_u, fs_re, fs_im, amplitude: float = 1.0):
    """Eigenvalue drift map for a steady pointwise force opposing the local
    base flow (Marquet et al. eq. 5.1):

        delta_sigma(x) = -a |U(x)| (fs_re . U),
        delta_omega(x) = +a |U(x)| (fs_im . U).
    """
    speed = torch.sqrt(torch.sum(base_u**2, dim=-1))
    wr = torch.sum(fs_re * base_u, dim=-1)
    wi = torch.sum(fs_im * base_u, dim=-1)
    return -amplitude * speed * wr, amplitude * speed * wi


def forced_tangent_response(ns, base_u, f, nsteps: int, base_p=None):
    """Particular solution of the tangent system about the frozen base with
    the *constant* acceleration forcing f and zero initial perturbation,

        b = int_0^T exp((T-s) L) B f ds   (discretely exact).

    Returns ``(b, prop)``: ``prop(f)`` is the linear map, and
    ``prop.transpose(c)`` its transpose (Euclidean, element-local layout:
    the JAX package's ``jax.vjp(prop, f)``).  ``base_p`` is accepted for the
    JAX signature (the tangent does not depend on it)."""
    s = ns.sem
    steps = TangentSteps(ns, base_u.to(device=s.device, dtype=s.dtype), 0.0, warm=False)

    def prop(f_):
        return steps.integrate(torch.zeros_like(f_), nsteps, forcing=lambda n: f_)

    def transpose(c):
        acc = [torch.zeros_like(c)]

        def add(n, ct_fc):
            acc[0] = acc[0] + ct_fc

        steps.transpose(c, nsteps, forcing_ct=add)
        return acc[0]

    prop.transpose = transpose
    return prop(f.to(s.dtype)), prop


def steady_force_sensitivity(
    ns,
    base_u,
    f,
    nsteps: int,
    base_p=None,
    k_dim: int = 64,
    tol: float = 1e-8,
    max_restarts: int = 10,
):
    """Solve the time-stepper steady linear system driven by the force f,

        (I - exp(T L^+)) x = int_0^T exp((T-s) L^+) B f ds,

    by GMRES on the adjoint propagator (the reference's
    ts_steady_force_sensitivity).  Returns (x, info)."""
    s = ns.sem
    bm = s.bm[..., None]
    f = f.to(s.dtype)
    # the adjoint forced response: the B-adjoint of the tangent forced
    # response
    _, prop = forced_tangent_response(ns, base_u, f, nsteps, base_p=base_p)
    b = prop.transpose(f * bm) / bm

    op = LinearizedOperator(ns, base_u, base_p=base_p, nsteps=nsteps)
    space = VectorSpace(
        lambda x, y: sum(s.inner(x[..., d], y[..., d]) for d in range(x.shape[-1]))
    )
    bnorm = float(space.norm(b))
    bn = space.scale(1.0 / bnorm, b)
    x, info = gmres(
        lambda q: q - op.rmatvec(q),
        space,
        bn,
        k_dim=k_dim,
        tol=tol,
        max_restarts=max_restarts,
    )
    return space.scale(bnorm, x), info
