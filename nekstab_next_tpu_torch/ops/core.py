"""Core spectral-element operators on ``(nelem, n, n)`` fields (2-D).

PyTorch port of ``nekstab_next_tpu/ops/core.py``: tensor-product
derivatives, the direct-stiffness sum, mass-weighted inner products, the
weak Helmholtz apply, the FDM element preconditioner, the PnPn-2 pressure
operators and the dealiased convection.

Differences from the JAX ``SEM``:

* ``SEM`` is an ``nn.Module``; every factor is a registered buffer on the
  device given at construction (the current CUDA device by default).
  Single device, 2-D only; the 3-D ``SEM3`` is in ``ops/core3.py``, and
  what both share (the pressure preconditioners, the reductions) in
  :class:`SEMBase`.
* ``dssum`` is a gather over the node->copies table (:func:`gather_table`):
  each local node sums every copy of its global node in table order.  No
  scatter-add, whose CUDA atomics would make sums nondeterministic; copies
  of one global node come out bit-identical.  The Q1 coarse level sums its
  vertices the same way.
* The weak pressure gradient ``D^T`` is written out (:meth:`grad_from_p`)
  where JAX takes ``jax.linear_transpose`` of :meth:`div_to_p`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import DEFAULT_DTYPE, resolve_device
from ..mesh.gll import (
    diff_matrix,
    gauss_points_weights,
    gll_points_weights,
    lagrange_interp_matrix,
)
from ..mesh.mesh import Mesh2D


def gather_table(gid_flat: np.ndarray, nglobal: int) -> np.ndarray:
    """Per-global-node padded list of contributing local flat indices
    (``nekstab_next_tpu/ops/core.py`` ``gather_table``).  Copies appear in
    increasing local index; pad entries point at an appended zero slot
    (index ``gid_flat.size``)."""
    order_idx = np.argsort(gid_flat, kind="stable")
    sorted_gid = gid_flat[order_idx]
    starts = np.searchsorted(sorted_gid, np.arange(nglobal))
    counts = np.diff(np.append(starts, gid_flat.size))
    mmax = int(counts.max())
    tbl = np.full((nglobal, mmax), gid_flat.size, dtype=np.int64)
    for k in range(mmax):
        sel = counts > k
        tbl[sel, k] = order_idx[starts[sel] + k]
    return tbl


class _DSSum(torch.autograd.Function):
    """The direct-stiffness sum as an autograd Function.  The sum is a
    symmetric linear map (Q Q^T), so its transpose is the same gather: the
    backward pass stays a deterministic gather rather than the scatter-add
    that differentiating the indexing would record."""

    @staticmethod
    def forward(u, sem):
        return sem._dssum(u)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.sem = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ctx.sem._dssum(g.contiguous()), None


# factor names, as the JAX SEM's attributes; float factors take the SEM's
# dtype, the rest stay integer
FLOAT_KEYS = (
    "D", "w", "rx", "ry", "sx", "sy", "jac", "bm", "g11", "g12", "g22",
    "vmask", "pmask", "tmask", "bms", "sponge", "binv_assembled", "inv_mult",
    "Jd", "wf2", "jac_d", "rx_d", "ry_d", "sx_d", "sy_d",
    "Jp", "Jpg", "bp", "fdm_S", "fdm_lam", "fdm_len", "pc_Jc", "pc_Acinv",
)
INT_KEYS = ("gid", "pc_cid")


def stiffness2(D, g11, g12, g22, u: torch.Tensor) -> torch.Tensor:
    """Local weak Laplacian of (nelem, n, n) fields from the factors
    (``SEM.stiffness_local``; the plain version of the fused apply calls
    it with float32 copies)."""
    ur = torch.einsum("ai,eij->eaj", D, u)
    us = torch.einsum("bj,eij->eib", D, u)
    wr = g11 * ur + g12 * us
    ws = g12 * ur + g22 * us
    return torch.einsum("ai,eaj->eij", D, wr) + torch.einsum("bj,eib->eij", D, ws)


def sem_factors(mesh: Mesh2D) -> dict:
    """Host-side (float64 numpy) factors of a mesh, named as the JAX SEM's
    attributes, plus ``nglobal`` and ``has_pressure_dirichlet``."""
    from .fdm import coarse_setup, element_half_lengths_2d, fdm_eigensetup

    n = mesh.n
    a = {}
    a["D"] = diff_matrix(n)
    z, w = gll_points_weights(n)
    a["w"] = w
    a["gid"] = mesh.gid.reshape(-1)
    for k in ("rx", "ry", "sx", "sy", "jac", "bm", "g11", "g12", "g22",
              "vmask", "pmask", "tmask"):
        a[k] = np.asarray(getattr(mesh, k), np.float64)
    a["bms"] = a["bm"]
    a["sponge"] = np.zeros_like(a["bm"])

    bmg = np.zeros(mesh.nglobal)
    np.add.at(bmg, mesh.gid.reshape(-1), mesh.bm.reshape(-1))
    a["binv_assembled"] = 1.0 / bmg[mesh.gid]
    a["inv_mult"] = 1.0 / mesh.mult

    # dealiasing (3/2 over-integration) operators
    nd = int(math.ceil(3 * n / 2))
    zf, wf = gauss_points_weights(nd)
    J = lagrange_interp_matrix(z, zf)  # (nd, n)
    a["Jd"] = J
    a["wf2"] = np.outer(wf, wf)
    interp2 = lambda f: np.einsum("ai,bj,eij->eab", J, J, f)
    a["jac_d"] = interp2(mesh.jac)
    a["rx_d"], a["ry_d"] = interp2(mesh.rx), interp2(mesh.ry)
    a["sx_d"], a["sy_d"] = interp2(mesh.sx), interp2(mesh.sy)

    # PnPn-2 pressure space: P_{N-2} on (n-2)^2 Gauss points per element
    npr = n - 2
    zg, wg = gauss_points_weights(npr)
    Jp = lagrange_interp_matrix(z, zg)  # (npr, n): GLL -> Gauss
    a["Jp"] = Jp
    a["Jpg"] = lagrange_interp_matrix(zg, z)  # (n, npr): Gauss -> GLL
    a["bp"] = np.outer(wg, wg) * np.einsum("ai,bj,eij->eab", Jp, Jp, mesh.jac)

    S, lam = fdm_eigensetup(n)
    a["fdm_S"], a["fdm_lam"] = S, lam
    a["fdm_len"] = element_half_lengths_2d(mesh)

    cid, Jc, Acinv = coarse_setup(
        mesh.gid, (mesh.g11, mesh.g12, mesh.g22), diff_matrix(n), z,
        np.asarray(mesh.pmask),
    )
    a["pc_cid"], a["pc_Jc"], a["pc_Acinv"] = cid, Jc, Acinv
    a["nglobal"] = int(mesh.nglobal)
    a["has_pressure_dirichlet"] = bool(mesh.has_pressure_dirichlet)
    return a


class SEMBase(nn.Module):
    """What :class:`SEM` (2-D) and ``SEM3`` (3-D, ops/core3.py) share:
    construction from a mesh or from factor arrays onto one device, the
    gather tables, the direct-stiffness sums, the Helmholtz apply and the
    mass-weighted reductions.  A subclass sets ``ndim``, ``float_keys`` (the
    float factors it installs) and ``_factors`` (mesh -> factor arrays)."""

    ndim: int
    float_keys: Tuple[str, ...]

    def __init__(self, mesh, dtype: Optional[torch.dtype] = None,
                 device=None, axis_name: Optional[str] = None):
        name = type(self).__name__
        if axis_name is not None:
            raise NotImplementedError(
                f"sharding ({name} axis_name) is not ported: the port's {name} "
                "is single-device"
            )
        super().__init__()
        self.mesh = mesh
        self._install(self._factors(mesh), dtype, device)

    @classmethod
    def from_arrays(cls, arrays: dict, dtype: Optional[torch.dtype] = None,
                    device=None):
        obj = cls.__new__(cls)
        nn.Module.__init__(obj)
        obj.mesh = None
        obj._install(arrays, dtype, device)
        return obj

    def _install(self, a: dict, dtype, device) -> None:
        dtype = DEFAULT_DTYPE if dtype is None else dtype
        device = resolve_device(device)
        self.dtype = dtype
        self.device = device
        D = np.asarray(a["D"])
        self.n = n = int(D.shape[0])
        self.npr = n - 2
        bm = np.asarray(a["bm"])
        if bm.ndim != self.ndim + 1:
            raise NotImplementedError(
                f"{type(self).__name__} takes {self.ndim}-D factors, got bm of "
                f"shape {bm.shape}: 2-D factors build an SEM, 3-D an SEM3"
            )
        self.nelem = int(bm.shape[0])
        self.nglobal = int(a["nglobal"])
        self.has_pressure_dirichlet = bool(a["has_pressure_dirichlet"])
        self.pc_nc = int(np.asarray(a["pc_Acinv"]).shape[0])

        for k in self.float_keys:
            self.register_buffer(
                k, torch.tensor(np.asarray(a[k]), dtype=dtype, device=device)
            )
        gid = np.asarray(a["gid"]).reshape(-1).astype(np.int64)
        cid = np.asarray(a["pc_cid"]).reshape(self.nelem, 2 ** self.ndim).astype(np.int64)
        self.gid_np, self.pc_cid_np = gid, cid
        self.register_buffer("gid", torch.as_tensor(gid, device=device))
        self.register_buffer("pc_cid", torch.as_tensor(cid, device=device))
        # dssum: every local node's padded list of copies (its global node's
        # row of the gather table), summed in table order
        gs_table = gather_table(gid, self.nglobal)
        self.register_buffer(
            "_gs_local", torch.as_tensor(gs_table[gid], device=device)
        )
        # Q1 coarse: every vertex's padded list of (element, corner) slots
        vt = gather_table(cid.reshape(-1), self.pc_nc)
        self.register_buffer("_vtx_table", torch.as_tensor(vt, device=device))

        pbi = a.get("pblock_inv")
        self.register_buffer(
            "pblock_inv",
            None if pbi is None else torch.tensor(np.asarray(pbi), dtype=dtype, device=device),
        )
        # 'schwarz': (pidx, Pinv, w, copies) of ops/schwarz.py
        # build_pressure_patches and the P0 coarse inverse; velocity 'block':
        # the block inverses by (h1, h2).  Built by the setup_* methods, or
        # carried in from the JAX SEM's arrays (interop.py).
        self.pschwarz = self.p0Acinv = None
        self.vblock_inv = {}
        if a.get("pschwarz") is not None:
            from .schwarz import patch_copies

            pidx, Pinv, w = (np.asarray(x) for x in a["pschwarz"])
            f = lambda x: torch.tensor(x, dtype=dtype, device=device)
            self.pschwarz = (
                torch.as_tensor(pidx.astype(np.int64), device=device), f(Pinv), f(w),
                torch.as_tensor(patch_copies(pidx, self.nelem * self.npr ** self.ndim),
                                device=device))
        if a.get("p0Acinv") is not None:
            self.p0Acinv = torch.tensor(np.asarray(a["p0Acinv"]), dtype=dtype, device=device)

    # ------------------------------------------------------------------
    # gather-scatter
    # ------------------------------------------------------------------
    def dssum(self, u: torch.Tensor) -> torch.Tensor:
        """Direct-stiffness sum over shared nodes; trailing component axes
        allowed: (nelem, n, .., n, ...).  Differentiable: the sum is
        symmetric, so its backward is the same gather (:class:`_DSSum`)."""
        if u.requires_grad:
            return _DSSum.apply(u, self)
        return self._dssum(u)

    def _dssum(self, u: torch.Tensor) -> torch.Tensor:
        flat = u.reshape((self.gid.shape[0],) + tuple(u.shape[self.ndim + 1:]))
        ext = torch.cat([flat, flat.new_zeros((1,) + tuple(flat.shape[1:]))])
        return ext[self._gs_local].sum(dim=1).reshape(u.shape)

    def _bc(self, w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Broadcast a (nelem, n, .., n) weight against trailing component
        axes."""
        return w.reshape(tuple(w.shape) + (1,) * (u.dim() - self.ndim - 1))

    def dsavg(self, u: torch.Tensor) -> torch.Tensor:
        """Multiplicity-weighted average at shared nodes (Nek ``dsavg``)."""
        return self.dssum(u) * self._bc(self.inv_mult, u)

    def dsavg_mass(self, u: torch.Tensor) -> torch.Tensor:
        """Mass-weighted average at shared nodes: B^-1_assembled dssum(B u)."""
        return self._bc(self.binv_assembled, u) * self.dssum(self._bc(self.bm, u) * u)

    def gradv(self, u: torch.Tensor) -> torch.Tensor:
        """Physical gradient as one (nelem, n, .., n, ndim) field."""
        return torch.stack(self.grad(u), dim=-1)

    def helmholtz_local(self, u: torch.Tensor, h1, h2) -> torch.Tensor:
        """Local weak Helmholtz: h1 * K u + h2 * B u  (Nek ``axhelm``)."""
        return h1 * self.stiffness_local(u) + h2 * self.bm * u

    # ------------------------------------------------------------------
    # PnPn-2 pressure preconditioners and velocity blocks; a subclass
    # supplies lift_p/restrict_p (R^T, R between Gauss and GLL), fdm_apply
    # and coarse_apply_pressure
    # ------------------------------------------------------------------
    @property
    def p_shape(self):
        """The P_{N-2} Gauss pressure space: (nelem, npr, .., npr)."""
        return (self.nelem,) + (self.npr,) * self.ndim

    def pressure_precond_pnpn2(self, r: torch.Tensor) -> torch.Tensor:
        """Two-level FDM + Q1 coarse preconditioner for E = D M^-1 D^T,
        applied on the lifted GLL residual (pressure_precond='fdm')."""
        rg = self.lift_p(r)
        return self.restrict_p(self.fdm_apply(rg, 1.0, 0.0)
                               + self.coarse_apply_pressure(rg))

    def setup_pressure_blocks(self) -> None:
        """Build the exact element-block pressure preconditioner once."""
        if self.pblock_inv is None:
            from .schwarz import build_pressure_blocks

            self.pblock_inv = build_pressure_blocks(self)

    def pressure_precond_block(self, r: torch.Tensor) -> torch.Tensor:
        """Exact element-block + Q1-coarse preconditioner for E = D M^-1 D^T
        (pressure_precond='block')."""
        from .schwarz import block_apply

        z = block_apply(self.pblock_inv, r)
        return z + self.restrict_p(self.coarse_apply_pressure(self.lift_p(r)))

    def setup_pressure_schwarz(self, adjacency: str = "face") -> None:
        """Build the overlapping-patch + P0 coarse pressure preconditioner
        once, from one sparse-E extraction shared by both levels; the
        patches are built unweighted.  ``adjacency``: 'face' (an element and
        its face neighbours) or 'node' (its node-sharing neighbours too)."""
        if self.pschwarz is None:
            from .schwarz import build_p0_coarse, build_pressure_patches, extract_sparse_E

            B = extract_sparse_E(self)
            self.pschwarz = build_pressure_patches(self, weighted=False, B=B,
                                                   adjacency=adjacency)
            self.p0Acinv = torch.as_tensor(build_p0_coarse(self, B=B), dtype=self.dtype,
                                           device=self.device)

    def pressure_precond_schwarz(self, r: torch.Tensor) -> torch.Tensor:
        """Three-level preconditioner for E = D M^-1 D^T
        (pressure_precond='schwarz'): the exact patch solves, the P0
        element-constant coarse level and the Q1 vertex coarse level, added."""
        from .schwarz import p0_coarse_apply, patch_apply

        z = patch_apply(*self.pschwarz, r) + p0_coarse_apply(self.p0Acinv, r)
        return z + self.restrict_p(self.coarse_apply_pressure(self.lift_p(r)))

    def setup_velocity_blocks(self, h1: float, h2: float) -> torch.Tensor:
        """Exact element-block preconditioner of the assembled velocity
        Helmholtz P(h1 K + h2 B)P (velocity_precond='block'), built once per
        (h1, h2)."""
        key = (float(h1), float(h2))
        if key not in self.vblock_inv:
            from .schwarz import build_velocity_blocks

            self.vblock_inv[key] = build_velocity_blocks(self, h1, h2)
        return self.vblock_inv[key]

    # ------------------------------------------------------------------
    # inner products / norms
    # ------------------------------------------------------------------
    def inner(self, u: torch.Tensor, v: torch.Tensor, masked: bool = True) -> torch.Tensor:
        """Mass-weighted global inner product <u, v>_B (``masked`` uses the
        sponge-masked weight bm1s)."""
        w = self.bms if masked else self.bm
        return torch.sum(u * v * self._bc(w, u))

    def norm(self, u: torch.Tensor, masked: bool = True) -> torch.Tensor:
        return torch.sqrt(self.inner(u, u, masked=masked))

    def glsum(self, u: torch.Tensor) -> torch.Tensor:
        return torch.sum(u)

    def cgdot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Multiplicity-weighted inner product (each global node counts
        once), under which the assembled elliptic operators are
        self-adjoint (Nek weights its solver dots by ``vmult``)."""
        return torch.sum(a * b * self._bc(self.inv_mult, a))

    def glmax(self, u: torch.Tensor) -> torch.Tensor:
        return torch.max(u)

    def volume(self) -> torch.Tensor:
        return self.glsum(self.bm)

    def mean(self, u: torch.Tensor) -> torch.Tensor:
        """Mass-weighted mean of a scalar field."""
        return torch.sum(u * self.bm) / self.volume()

    # ------------------------------------------------------------------
    # sponge (reference core/forcing.f90:82-252)
    # ------------------------------------------------------------------
    def set_sponge(self, strength_field) -> None:
        """Install a sponge strength field lambda(x) >= 0; zeroes the
        inner-product weight bm1s where the sponge acts."""
        lam = torch.as_tensor(np.asarray(strength_field), dtype=self.dtype,
                              device=self.device)
        self.sponge = lam
        self.bms = torch.where(lam > 0.0, torch.zeros_like(self.bm), self.bm)


class SEM(SEMBase):
    """Spectral-element operator context for one 2-D mesh on one device.

    ``SEM(mesh, dtype=None, device=None)`` builds the factors from the mesh
    (float64 unless ``dtype`` is given) on ``device`` (the current CUDA
    device when None; raises without one, see :func:`resolve_device`);
    :meth:`from_arrays` builds them from precomputed numpy arrays
    (``interop.sem_from_arrays``).  ``axis_name`` (the JAX SEM's sharded
    element axis) raises: the port is single-device."""

    ndim = 2
    float_keys = FLOAT_KEYS
    _factors = staticmethod(sem_factors)

    # ------------------------------------------------------------------
    # derivatives
    # ------------------------------------------------------------------
    def grad_ref(self, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reference-element derivatives (u_xi, u_eta)."""
        ur = torch.einsum("ai,eij->eaj", self.D, u)
        us = torch.einsum("bj,eij->eib", self.D, u)
        return ur, us

    def grad_ref_t(self, wr: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
        """Transpose of :meth:`grad_ref`: D_r^T wr + D_s^T ws."""
        return torch.einsum("ai,eaj->eij", self.D, wr) + torch.einsum(
            "bj,eib->eij", self.D, ws
        )

    def grad(self, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Physical gradient (u_x, u_y) — the reference's ``gradm1``."""
        ur, us = self.grad_ref(u)
        return self.rx * ur + self.sx * us, self.ry * ur + self.sy * us

    def div(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        ux, _ = self.grad(u)
        _, vy = self.grad(v)
        return ux + vy

    def divv(self, u: torch.Tensor) -> torch.Tensor:
        return self.div(u[..., 0], u[..., 1])

    def divv_weak_t(self, q: torch.Tensor) -> torch.Tensor:
        """The exact transpose of ``bm * divv`` (the weak pressure gradient
        of the ``'consistent'`` scheme), (nelem, n, n) -> (nelem, n, n, 2)."""
        zb = self.bm * q
        u0 = self.grad_ref_t(self.rx * zb, self.sx * zb)
        u1 = self.grad_ref_t(self.ry * zb, self.sy * zb)
        return torch.stack([u0, u1], dim=-1)

    def curl(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """z-vorticity dv/dx - du/dy (``comp_vort3`` 2-D)."""
        _, uy = self.grad(u)
        vx, _ = self.grad(v)
        return vx - uy

    # ------------------------------------------------------------------
    # weak-form elliptic operators (local, unassembled)
    # ------------------------------------------------------------------
    def stiffness_local(self, u: torch.Tensor) -> torch.Tensor:
        """Local weak Laplacian K u (integral of grad(phi).grad(u))."""
        return stiffness2(self.D, self.g11, self.g12, self.g22, u)

    def stiffness_diag(self) -> torch.Tensor:
        """Diagonal of the local stiffness (for Jacobi preconditioning)."""
        D2 = self.D * self.D
        d = torch.einsum("ai,eaj->eij", D2, self.g11) + torch.einsum(
            "bj,eib->eij", D2, self.g22
        )
        dd = torch.diagonal(self.D)
        return d + 2.0 * self.g12 * dd[:, None] * dd[None, :]

    def fdm_inverse(self, h1, h2, rel: float = 1e-8) -> torch.Tensor:
        """(nelem, n, n) inverse eigen-denominator of the FDM box operator.
        The Neumann constant mode (lam=0 twice) has denom ~ h2*ab; below
        ``rel`` times the lowest genuine mode's scale it takes that scale, so
        the preconditioner stays SPD when h2=0.  ``fdm_apply`` uses
        ``rel=1e-8``; the fused velocity solve (ops/fused_cg.py) ``1e-6``."""
        lam = self.fdm_lam
        a = self.fdm_len[:, 0][:, None, None]
        b = self.fdm_len[:, 1][:, None, None]
        denom = h1 * ((b / a) * lam[:, None] + (a / b) * lam[None, :]) + h2 * (a * b)
        ref = h1 * (b / a + a / b) * lam[1] + h2 * (a * b)
        ok = denom > rel * ref
        return torch.where(ok, 1.0 / torch.where(ok, denom, torch.ones_like(denom)),
                           1.0 / ref.clamp_min(1e-30))

    def fdm_apply(self, r: torch.Tensor, h1, h2, rel: float = 1e-8) -> torch.Tensor:
        """Approximate elementwise inverse of (h1 K + h2 B) by tensor-product
        fast diagonalization on each element's bounding box (ops/fdm.py).
        Accepts trailing component axes: (nelem, n, n, ...)."""
        S = self.fdm_S
        inv = self._bc(self.fdm_inverse(h1, h2, rel), r)
        t = torch.einsum("ia,jb,eij...->eab...", S, S, r) * inv
        return torch.einsum("ia,jb,eab...->eij...", S, S, t)

    # ------------------------------------------------------------------
    # PnPn-2 pressure space operators
    # ------------------------------------------------------------------
    def div_to_p(self, u: torch.Tensor) -> torch.Tensor:
        """Weak divergence into the P_{N-2} Gauss pressure space (the PnPn-2
        D operator), integrated on the velocity GLL grid."""
        d = self.bm * self.divv(u)
        return torch.einsum("ia,jb,eij->eab", self.Jpg, self.Jpg, d)

    def p_to_gll(self, p: torch.Tensor) -> torch.Tensor:
        """Interpolate a Gauss pressure field to the velocity GLL nodes
        (for output and post-processing only)."""
        return torch.einsum("ia,jb,eab->eij", self.Jpg, self.Jpg, p)

    def p_from_gll(self, p: torch.Tensor) -> torch.Tensor:
        """Sample a GLL nodal pressure field at the Gauss pressure points
        (e.g. an exact initial pressure)."""
        return torch.einsum("ai,bj,eij->eab", self.Jp, self.Jp, p)

    def grad_from_p(self, q: torch.Tensor) -> torch.Tensor:
        """The exact transpose of :meth:`div_to_p` (the weak pressure
        gradient D^T), (nelem, npr, npr) -> (nelem, n, n, 2)."""
        zb = self.bm * torch.einsum("ia,jb,eab->eij", self.Jpg, self.Jpg, q)
        u0 = self.grad_ref_t(self.rx * zb, self.sx * zb)
        u1 = self.grad_ref_t(self.ry * zb, self.sy * zb)
        return torch.stack([u0, u1], dim=-1)

    def lift_p(self, r: torch.Tensor) -> torch.Tensor:
        """Transpose-interpolation R^T of a Gauss field to the GLL grid."""
        return torch.einsum("ai,bj,eab->eij", self.Jp, self.Jp, r)

    def restrict_p(self, z: torch.Tensor) -> torch.Tensor:
        """R z: GLL field back to the Gauss points (transpose of lift_p)."""
        return torch.einsum("ai,bj,eij->eab", self.Jp, self.Jp, z)

    def coarse_apply_pressure(self, r: torch.Tensor) -> torch.Tensor:
        """Q1 vertex coarse-grid correction (Nek's XXT coarse solve role);
        the vertex sums gather over the vertex table in table order."""
        rc_e = torch.einsum("cij,eij->ec", self.pc_Jc, r).reshape(-1)
        ext = torch.cat([rc_e, rc_e.new_zeros(1)])
        rc = ext[self._vtx_table].sum(dim=1)
        xc = self.pc_Acinv @ rc
        return torch.einsum("cij,ec->eij", self.pc_Jc, xc[self.pc_cid])

    # ------------------------------------------------------------------
    # convection
    # ------------------------------------------------------------------
    def convect_weak(self, cx, cy, u) -> torch.Tensor:
        """Weak convection  integral of  phi * (c . grad u), dealiased by
        over-integration on the 3/2 Gauss grid (Nek ``convect_new``)."""
        ux, uy = self.grad(u)
        J = self.Jd
        to_fine = lambda f: torch.einsum("ai,bj,eij->eab", J, J, f)
        F = to_fine(cx) * to_fine(ux) + to_fine(cy) * to_fine(uy)
        W = self.wf2 * self.jac_d * F
        return torch.einsum("ai,bj,eab->eij", J, J, W)

    def convect(self, c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return self.convect_weak(c[..., 0], c[..., 1], u)

    def convect_colloc(self, cx, cy, u) -> torch.Tensor:
        """Collocated (aliased) weak convection: B * (c . grad u)
        (``SolverConfig(dealias=False)``)."""
        ux, uy = self.grad(u)
        return self.bm * (cx * ux + cy * uy)

    def convect_colloc_v(self, c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return self.convect_colloc(c[..., 0], c[..., 1], u)

    # ------------------------------------------------------------------
    # CFL (reference utils.f90 compute_cfl; used for dt selection)
    # ------------------------------------------------------------------
    def cfl(self, u: torch.Tensor, v: torch.Tensor, dt: float) -> torch.Tensor:
        """Convective CFL number max |u.grad(xi)| dt / dxi_min."""
        dz = float(np.min(np.diff(gll_points_weights(self.n)[0])))
        ur = torch.abs(u * self.rx + v * self.ry)
        us = torch.abs(u * self.sx + v * self.sy)
        return self.glmax((ur + us) * dt / dz)
