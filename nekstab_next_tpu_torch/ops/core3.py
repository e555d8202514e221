"""3-D spectral-element operators on ``(nelem, n, n, n)`` fields.

PyTorch port of ``nekstab_next_tpu/ops/core3.py``: the direct-stiffness
sum, gradients, divergence and curl, the weak Helmholtz apply, the FDM
element preconditioner, the Q1 coarse level, the PnPn-2 pressure space
(P_{N-2} on Gauss points) with its three preconditioners, the dealiased and
the collocated convection, the CFL number and the reductions.  Same design
as the 2-D :class:`~nekstab_next_tpu_torch.ops.core.SEM`, with which it
shares :class:`~nekstab_next_tpu_torch.ops.core.SEMBase` (the pressure
preconditioners and the reductions among it): an ``nn.Module`` whose
factors are buffers on one device, ``dssum`` as a gather over the
node->copies table (no atomics), the Q1 vertex sums the same way, and a
shard view of one rank's elements (``SEMBase.shard_view``).

Every tensor-product contraction runs one node axis at a time
(:func:`along`, :func:`tensor3`), each a batched matmul on a view of its
input: no einsum path search on the host and no permuted copies on the
device.  The vector forms (``divv``, ``grad_from_p``) take all three
components through each reference derivative at once.  The weak
pressure gradient ``D^T`` is written out (:meth:`SEM3.grad_from_p`) where
JAX takes ``jax.linear_transpose`` of ``div_to_p``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..mesh.gll import (
    diff_matrix,
    gauss_points_weights,
    gll_points_weights,
    lagrange_interp_matrix,
)
from ..mesh.mesh3 import Mesh3D
from .core import SEMBase

_METRICS = ("drdx", "drdy", "drdz", "dsdx", "dsdy", "dsdz", "dtdx", "dtdy", "dtdz")
# factor names, as the JAX SEM3's attributes
FLOAT_KEYS3 = (
    ("D", "w") + _METRICS
    + ("jac", "bm", "g11", "g12", "g13", "g22", "g23", "g33",
       "vmask", "pmask", "tmask", "bms", "sponge", "binv_assembled", "inv_mult",
       "Jd", "wf3", "jac_d")
    + tuple(k + "_d" for k in _METRICS)
    + ("Jp", "Jpg", "bp", "fdm_S", "fdm_lam", "fdm_len", "pc_Jc", "pc_Acinv")
)
INT_KEYS3 = ("gid", "pc_cid")
# the per-element factors a shard view slices (JAX's ``SEM3._ELEM_FIELDS``)
ELEM_KEYS3 = (
    _METRICS + ("jac", "bm", "bms", "sponge", "g11", "g12", "g13", "g22", "g23", "g33",
                "vmask", "pmask", "tmask", "binv_assembled", "inv_mult", "bp", "jac_d")
    + tuple(k + "_d" for k in _METRICS) + ("fdm_len", "pc_cid")
)


def along(M: torch.Tensor, u: torch.Tensor, axis: int) -> torch.Tensor:
    """sum_i M[a, i] u[.., i, ..] over node axis ``axis`` (1, 2 or 3) of a
    (nelem, n, n, n, ...) tensor: one batched matmul on a view of u, the
    axes before ``axis`` as the batch and those after it as the columns."""
    shape = tuple(u.shape)
    out = torch.matmul(M, u.reshape(math.prod(shape[:axis]), shape[axis], -1))
    return out.reshape(shape[:axis] + (M.shape[0],) + shape[axis + 1:])


def tensor3(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
            u: torch.Tensor) -> torch.Tensor:
    """sum_ijk A[a, i] B[b, j] C[c, k] u[e, i, j, k, ...]: the three node
    axes contracted one at a time, i then j then k (trailing component axes
    allowed)."""
    return along(C, along(B, along(A, u, 1), 2), 3)


def stiffness3(D, g11, g12, g13, g22, g23, g33, u: torch.Tensor) -> torch.Tensor:
    """Local weak Laplacian of (nelem, n, n, n) fields from the factors
    (``SEM3.stiffness_local``; the plain version of the fused apply calls
    it with float32 copies)."""
    ur = torch.einsum("ai,eijk->eajk", D, u)
    us = torch.einsum("aj,eijk->eiak", D, u)
    ut = torch.einsum("ak,eijk->eija", D, u)
    wr = g11 * ur + g12 * us + g13 * ut
    ws = g12 * ur + g22 * us + g23 * ut
    wt = g13 * ur + g23 * us + g33 * ut
    return (
        torch.einsum("ai,eajk->eijk", D, wr)
        + torch.einsum("aj,eiak->eijk", D, ws)
        + torch.einsum("ak,eija->eijk", D, wt)
    )


def sem3_factors(mesh: Mesh3D) -> dict:
    """Host-side (float64 numpy) factors of a 3-D mesh, named as the JAX
    SEM3's attributes, plus ``nglobal`` and ``has_pressure_dirichlet``."""
    from .fdm import coarse_setup, element_half_lengths_3d, fdm_eigensetup

    n = mesh.n
    a = {}
    a["D"] = diff_matrix(n)
    z, w = gll_points_weights(n)
    a["w"] = w
    a["gid"] = mesh.gid.reshape(-1)
    for k in _METRICS + ("jac", "bm", "g11", "g12", "g13", "g22", "g23", "g33",
                         "vmask", "pmask", "tmask"):
        a[k] = np.asarray(getattr(mesh, k), np.float64)
    a["bms"] = a["bm"]
    a["sponge"] = np.zeros_like(a["bm"])

    bmg = np.zeros(mesh.nglobal)
    np.add.at(bmg, mesh.gid.reshape(-1), mesh.bm.reshape(-1))
    a["binv_assembled"] = 1.0 / bmg[mesh.gid]
    a["inv_mult"] = 1.0 / mesh.mult

    # dealiasing (3/2 over-integration)
    nd = int(math.ceil(3 * n / 2))
    zf, wf = gauss_points_weights(nd)
    J = lagrange_interp_matrix(z, zf)
    a["Jd"] = J
    a["wf3"] = wf[:, None, None] * wf[None, :, None] * wf[None, None, :]
    # optimize=True contracts one axis at a time (the naive 4-operand loop
    # takes minutes at the cube's full size); same values to f64 roundoff
    interp3 = lambda f: np.einsum("ai,bj,ck,eijk->eabc", J, J, J, np.asarray(f),
                                  optimize=True)
    a["jac_d"] = interp3(mesh.jac)
    for k in _METRICS:
        a[k + "_d"] = interp3(getattr(mesh, k))

    # PnPn-2 pressure space: P_{N-2} on (n-2)^3 Gauss points per element
    zg, wg = gauss_points_weights(n - 2)
    Jp = lagrange_interp_matrix(z, zg)  # (npr, n): GLL -> Gauss
    a["Jp"] = Jp
    a["Jpg"] = lagrange_interp_matrix(zg, z)  # (n, npr): Gauss -> GLL
    wp3 = np.einsum("a,b,c->abc", wg, wg, wg)
    a["bp"] = wp3 * np.einsum("ai,bj,ck,eijk->eabc", Jp, Jp, Jp, mesh.jac,
                              optimize=True)

    S, lam = fdm_eigensetup(n)
    a["fdm_S"], a["fdm_lam"] = S, lam
    a["fdm_len"] = element_half_lengths_3d(mesh)

    cid, Jc, Acinv = coarse_setup(
        mesh.gid, (mesh.g11, mesh.g12, mesh.g13, mesh.g22, mesh.g23, mesh.g33),
        diff_matrix(n), z, np.asarray(mesh.pmask),
    )
    a["pc_cid"], a["pc_Jc"], a["pc_Acinv"] = cid, Jc, Acinv
    a["nglobal"] = int(mesh.nglobal)
    a["has_pressure_dirichlet"] = bool(mesh.has_pressure_dirichlet)
    return a


class SEM3(SEMBase):
    """Spectral-element operator context for one 3-D mesh on one device.

    ``SEM3(mesh, dtype=None, device=None)`` builds the factors from the mesh
    (float64 unless ``dtype`` is given) on ``device`` (the current CUDA
    device when None; raises without one); :meth:`from_arrays` builds them
    from precomputed numpy arrays (``interop.sem3_from_arrays``)."""

    ndim = 3
    float_keys = FLOAT_KEYS3
    elem_keys = ELEM_KEYS3
    _factors = staticmethod(sem3_factors)

    def _derived(self) -> None:
        # the metric as one (nelem, n, n, n, 3, 3) buffer, [..., d, r] =
        # d xi_r / d x_d: the vector forms (divv, grad_from_p) take all three
        # components through each reference derivative at once
        self.register_buffer("_metric", torch.stack([
            torch.stack([self.drdx, self.dsdx, self.dtdx], dim=-1),
            torch.stack([self.drdy, self.dsdy, self.dtdy], dim=-1),
            torch.stack([self.drdz, self.dsdz, self.dtdz], dim=-1),
        ], dim=-2))
        self._fdm_inv = {}  # (h1, h2) -> the FDM's inverse eigen-denominators

    # ------------------------------------------------------------------
    # derivatives
    # ------------------------------------------------------------------
    def grad_ref(self, u: torch.Tensor):
        """Reference derivatives (u_r, u_s, u_t); trailing component axes
        allowed."""
        return along(self.D, u, 1), along(self.D, u, 2), along(self.D, u, 3)

    def grad(self, u: torch.Tensor):
        """Physical gradient (u_x, u_y, u_z) — 3-D ``gradm1``."""
        ur, us, ut = self.grad_ref(u)
        return (
            self.drdx * ur + self.dsdx * us + self.dtdx * ut,
            self.drdy * ur + self.dsdy * us + self.dtdy * ut,
            self.drdz * ur + self.dsdz * us + self.dtdz * ut,
        )

    def divv(self, u: torch.Tensor) -> torch.Tensor:
        """du/dx + dv/dy + dw/dz of a (nelem, n, n, n, 3) velocity: each
        reference derivative of all three components at once, weighted by
        the metric and summed over the components."""
        g = self._metric
        ur, us, ut = self.grad_ref(u)
        return (g[..., 0] * ur + g[..., 1] * us + g[..., 2] * ut).sum(dim=-1)

    def divv_weak_t(self, q: torch.Tensor) -> torch.Tensor:
        """The exact transpose of ``bm * divv`` (the weak pressure gradient
        of the ``'consistent'`` scheme), (nelem, n, n, n) -> (nelem, n, n, n, 3)."""
        zb = (self.bm * q)[..., None]
        g = self._metric
        Dt = self.D.transpose(0, 1)
        return (along(Dt, g[..., 0] * zb, 1) + along(Dt, g[..., 1] * zb, 2)
                + along(Dt, g[..., 2] * zb, 3))

    def curl(self, u: torch.Tensor, v: torch.Tensor, w: torch.Tensor):
        """(curl u) components — 3-D ``comp_vort3``."""
        _, uy, uz = self.grad(u)
        vx, _, vz = self.grad(v)
        wx, wy, _ = self.grad(w)
        return wy - vz, uz - wx, vx - uy

    # ------------------------------------------------------------------
    # weak-form elliptic operators (local, unassembled)
    # ------------------------------------------------------------------
    def stiffness_local(self, u: torch.Tensor) -> torch.Tensor:
        return stiffness3(self.D, self.g11, self.g12, self.g13, self.g22,
                          self.g23, self.g33, u)

    def stiffness_diag(self) -> torch.Tensor:
        D2 = self.D * self.D
        d = (
            torch.einsum("ai,eajk->eijk", D2, self.g11)
            + torch.einsum("aj,eiak->eijk", D2, self.g22)
            + torch.einsum("ak,eija->eijk", D2, self.g33)
        )
        dd = torch.diagonal(self.D)
        return d + 2.0 * (
            self.g12 * dd[:, None, None] * dd[None, :, None]
            + self.g13 * dd[:, None, None] * dd[None, None, :]
            + self.g23 * dd[None, :, None] * dd[None, None, :]
        )

    def fdm_apply(self, r: torch.Tensor, h1, h2) -> torch.Tensor:
        """Approximate elementwise inverse of (h1 K + h2 B) by tensor-product
        fast diagonalization on each element's box (ops/fdm.py).  Accepts
        trailing component axes: (nelem, n, n, n, ...)."""
        S = self.fdm_S
        St = S.transpose(0, 1)
        return tensor3(S, S, S, tensor3(St, St, St, r) * self._bc(self.fdm_inverse(h1, h2), r))

    def fdm_inverse(self, h1, h2) -> torch.Tensor:
        """(nelem, n, n, n) inverse eigen-denominators of the FDM box
        operator, kept for the last few (h1, h2); the Neumann constant mode
        takes the lowest genuine mode's scale below 1e-8 of it (see SEM)."""
        key = (float(h1), float(h2))
        if key not in self._fdm_inv:
            if len(self._fdm_inv) >= 8:  # a time step that varies (UPO Newton)
                self._fdm_inv.pop(next(iter(self._fdm_inv)))
            lam = self.fdm_lam
            a = self.fdm_len[:, 0][:, None, None, None]
            b = self.fdm_len[:, 1][:, None, None, None]
            c = self.fdm_len[:, 2][:, None, None, None]
            denom = h1 * (
                (b * c / a) * lam[:, None, None] + (a * c / b) * lam[None, :, None]
                + (a * b / c) * lam[None, None, :]
            ) + h2 * (a * b * c)
            ref = h1 * (b * c / a + a * c / b + a * b / c) * lam[1] + h2 * (a * b * c)
            self._fdm_inv[key] = torch.where(denom > 1e-8 * ref,
                                             1.0 / denom.clamp_min(1e-300), 1.0 / ref)
        return self._fdm_inv[key]

    # ------------------------------------------------------------------
    # PnPn-2 pressure space (the 2-D SEM's, on hexahedra)
    # ------------------------------------------------------------------
    def div_to_p(self, u: torch.Tensor) -> torch.Tensor:
        """Weak divergence into the P_{N-2} Gauss pressure space (the PnPn-2
        D operator), integrated on the velocity GLL grid."""
        Jt = self.Jpg.transpose(0, 1)
        return tensor3(Jt, Jt, Jt, self.bm * self.divv(u))

    def p_to_gll(self, p: torch.Tensor) -> torch.Tensor:
        """Interpolate a Gauss pressure field to the velocity GLL nodes
        (for output and post-processing only)."""
        return tensor3(self.Jpg, self.Jpg, self.Jpg, p)

    def grad_from_p(self, q: torch.Tensor) -> torch.Tensor:
        """The exact transpose of :meth:`div_to_p` (the weak pressure
        gradient D^T), (nelem, npr, npr, npr) -> (nelem, n, n, n, 3)."""
        zb = (self.bm * self.p_to_gll(q))[..., None]
        g = self._metric
        Dt = self.D.transpose(0, 1)
        return (along(Dt, g[..., 0] * zb, 1) + along(Dt, g[..., 1] * zb, 2)
                + along(Dt, g[..., 2] * zb, 3))

    def lift_p(self, r: torch.Tensor) -> torch.Tensor:
        """Transpose-interpolation R^T of a Gauss field to the GLL grid."""
        Jt = self.Jp.transpose(0, 1)
        return tensor3(Jt, Jt, Jt, r)

    def restrict_p(self, z: torch.Tensor) -> torch.Tensor:
        """R z: GLL field back to the Gauss points (transpose of lift_p)."""
        return tensor3(self.Jp, self.Jp, self.Jp, z)

    def coarse_apply_pressure(self, r: torch.Tensor) -> torch.Tensor:
        """Q1 vertex coarse-grid correction; the vertex sums gather over the
        vertex table in table order."""
        rc_e = torch.einsum("cijk,eijk->ec", self.pc_Jc, r).reshape(-1)
        ext = torch.cat([rc_e, rc_e.new_zeros(1)])
        rc = self._reduce(ext[self._vtx_table].sum(dim=1))
        xc = self.pc_Acinv @ rc
        return torch.einsum("cijk,ec->eijk", self.pc_Jc, xc[self.pc_cid])

    # ------------------------------------------------------------------
    # convection
    # ------------------------------------------------------------------
    def _to_fine(self, a: torch.Tensor) -> torch.Tensor:
        J = self.Jd
        return tensor3(J, J, J, a)

    def convect(self, c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Dealiased weak convection  integral phi (c . grad u) with the
        3/2-rule over-integration (Nek ``convect_new``)."""
        ux, uy, uz = self.grad(u)
        F = (
            self._to_fine(c[..., 0]) * self._to_fine(ux)
            + self._to_fine(c[..., 1]) * self._to_fine(uy)
            + self._to_fine(c[..., 2]) * self._to_fine(uz)
        )
        W = self.wf3 * self.jac_d * F
        Jt = self.Jd.transpose(0, 1)
        return tensor3(Jt, Jt, Jt, W)

    def convect_colloc(self, c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Collocated (aliased) weak convection: B * (c . grad u)
        (``SolverConfig(dealias=False)``)."""
        ux, uy, uz = self.grad(u)
        return self.bm * (c[..., 0] * ux + c[..., 1] * uy + c[..., 2] * uz)

    convect_colloc_v = convect_colloc

    # ------------------------------------------------------------------
    # CFL (reference utils.f90 compute_cfl; used for dt selection)
    # ------------------------------------------------------------------
    def cfl(self, u: torch.Tensor, dt: float) -> torch.Tensor:
        """Convective CFL number max |u.grad(xi)| dt / dxi_min of a
        (nelem, n, n, n, 3) velocity."""
        dz = float(np.min(np.diff(gll_points_weights(self.n)[0])))
        ur = torch.abs(u[..., 0] * self.drdx + u[..., 1] * self.drdy + u[..., 2] * self.drdz)
        us = torch.abs(u[..., 0] * self.dsdx + u[..., 1] * self.dsdy + u[..., 2] * self.dsdz)
        ut = torch.abs(u[..., 0] * self.dtdx + u[..., 1] * self.dtdy + u[..., 2] * self.dtdz)
        return self.glmax((ur + us + ut) * dt / dz)
