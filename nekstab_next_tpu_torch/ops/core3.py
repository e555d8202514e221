"""3-D spectral-element operators on ``(nelem, n, n, n)`` fields.

PyTorch port of ``nekstab_next_tpu/ops/core3.py`` for what the
``'laplacian'`` pressure scheme and the mixed-precision step need: the
direct-stiffness sum, gradients and divergence, the weak Helmholtz apply,
the FDM element preconditioner, the Q1 coarse level, the dealiased
convection and the mass-weighted reductions.  Same design as the 2-D
:class:`~nekstab_next_tpu_torch.ops.core.SEM`, with which it shares
:class:`~nekstab_next_tpu_torch.ops.core.SEMBase`: an ``nn.Module`` whose
factors are buffers on one device, ``dssum`` as a gather over the
node->copies table (no atomics), the Q1 vertex sums the same way.

Not ported yet (ROADMAP item 15): the PnPn-2 pressure space (``div_to_p``,
``p_to_gll``, its preconditioners), ``curl``, ``cfl`` and the collocated
convection; they raise.
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
    + ("fdm_S", "fdm_lam", "fdm_len", "pc_Jc", "pc_Acinv")
)
INT_KEYS3 = ("gid", "pc_cid")

_PNPN2 = "is not ported for 3-D yet (ROADMAP item 15: 3-D PnPn-2)"


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
    _factors = staticmethod(sem3_factors)

    # ------------------------------------------------------------------
    # derivatives
    # ------------------------------------------------------------------
    def grad_ref(self, u: torch.Tensor):
        ur = torch.einsum("ai,eijk->eajk", self.D, u)
        us = torch.einsum("aj,eijk->eiak", self.D, u)
        ut = torch.einsum("ak,eijk->eija", self.D, u)
        return ur, us, ut

    def grad(self, u: torch.Tensor):
        """Physical gradient (u_x, u_y, u_z) — 3-D ``gradm1``."""
        ur, us, ut = self.grad_ref(u)
        return (
            self.drdx * ur + self.dsdx * us + self.dtdx * ut,
            self.drdy * ur + self.dsdy * us + self.dtdy * ut,
            self.drdz * ur + self.dsdz * us + self.dtdz * ut,
        )

    def divv(self, u: torch.Tensor) -> torch.Tensor:
        gx, _, _ = self.grad(u[..., 0])
        _, gy, _ = self.grad(u[..., 1])
        _, _, gz = self.grad(u[..., 2])
        return gx + gy + gz

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
        S, lam = self.fdm_S, self.fdm_lam
        a = self.fdm_len[:, 0][:, None, None, None]
        b = self.fdm_len[:, 1][:, None, None, None]
        c = self.fdm_len[:, 2][:, None, None, None]
        denom = h1 * (
            (b * c / a) * lam[:, None, None] + (a * c / b) * lam[None, :, None]
            + (a * b / c) * lam[None, None, :]
        ) + h2 * (a * b * c)
        ref = h1 * (b * c / a + a * c / b + a * b / c) * lam[1] + h2 * (a * b * c)
        inv = torch.where(denom > 1e-8 * ref, 1.0 / denom.clamp_min(1e-300), 1.0 / ref)
        inv = self._bc(inv, r)
        t = torch.einsum("ia,jb,kc,eijk...->eabc...", S, S, S, r) * inv
        return torch.einsum("ia,jb,kc,eabc...->eijk...", S, S, S, t)

    def coarse_apply_pressure(self, r: torch.Tensor) -> torch.Tensor:
        """Q1 vertex coarse-grid correction; the vertex sums gather over the
        vertex table in table order."""
        rc_e = torch.einsum("cijk,eijk->ec", self.pc_Jc, r).reshape(-1)
        ext = torch.cat([rc_e, rc_e.new_zeros(1)])
        rc = ext[self._vtx_table].sum(dim=1)
        xc = self.pc_Acinv @ rc
        return torch.einsum("cijk,ec->eijk", self.pc_Jc, xc[self.pc_cid])

    # ------------------------------------------------------------------
    # convection
    # ------------------------------------------------------------------
    def _to_fine(self, a: torch.Tensor) -> torch.Tensor:
        J = self.Jd
        return torch.einsum("ai,bj,ck,eijk->eabc", J, J, J, a)

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
        J = self.Jd
        return torch.einsum("ai,bj,ck,eabc->eijk", J, J, J, W)

    # ------------------------------------------------------------------
    # not ported yet
    # ------------------------------------------------------------------
    @property
    def p_shape(self):
        raise NotImplementedError(f"the P_(N-2) pressure space {_PNPN2}")

    def div_to_p(self, u):
        raise NotImplementedError(f"div_to_p {_PNPN2}")

    def p_to_gll(self, p):
        raise NotImplementedError(f"p_to_gll {_PNPN2}")

    def pressure_precond_pnpn2(self, r):
        raise NotImplementedError(f"pressure_precond_pnpn2 {_PNPN2}")

    def setup_pressure_blocks(self):
        raise NotImplementedError(f"the 'block' pressure preconditioner {_PNPN2}")

    def pressure_precond_block(self, r):
        raise NotImplementedError(f"the 'block' pressure preconditioner {_PNPN2}")

    def setup_pressure_schwarz(self, adjacency: str = "face"):
        raise NotImplementedError(f"the 'schwarz' pressure preconditioner {_PNPN2}")

    def pressure_precond_schwarz(self, r):
        raise NotImplementedError(f"the 'schwarz' pressure preconditioner {_PNPN2}")

    def curl(self, u, v, w):
        raise NotImplementedError("SEM3.curl is not ported yet (ROADMAP item 15)")

    def cfl(self, u, dt):
        raise NotImplementedError("SEM3.cfl is not ported yet (ROADMAP item 15)")

    def convect_colloc(self, c, u):
        raise NotImplementedError(
            "SEM3.convect_colloc (dealias=False) is not ported yet (ROADMAP item 15)"
        )
