"""Plain PyTorch reference of the 2-D PnPn-2 tangent propagator and its
adjoint, for the benchmark's correctness check.

The tangent step about a frozen base flow U, with BDF_k/EXT_k (k ramps
1 -> 3) and incremental pressure correction on the P_{N-2} Gauss space:

    E^n   = -(C(U) u + C(u) U) - B lam u            (dealiased convection)
    H_k u* = (1/dt) B sum_i b_i u^{n-i} + sum_i a_i E^{n-i} + D^T p
    S dp  = -(g0/dt) D u*,   S = D M^-1 D^T
    u^{n+1} = u* + (dt/g0) M^-1 D^T dp,   p^{n+1} = p + dp

with H_k = nu K + (g0/dt) B assembled on the free (non-Dirichlet) nodes.
Both solves are exact: H_k and S are assembled once (scipy, float64) and
factorised by a sparse LU (SuperLU) on the host in the reference's
precision, so the reference's only error is round-off.  The adjoint is the transpose of the
whole map in the sponge-masked energy product, ``W^+ M^T W`` with
``W = diag(bms)``, with ``M^T`` taken by autograd through the same
operators (every linear building block carries its exact transpose).

``dtype`` sets the precision of every operator and product: float64 for
the reference, float32 for the control of a float64 configuration.
``tf32=True`` rounds the field operand of every matrix product of the
step (the derivative, interpolation and quadrature contractions, and
their transposes) to TF32's 10-bit mantissa with float32 accumulation:
the control of a float32 configuration whose products run with TF32 off.
The discretisation's constant matrices and the solves stay exact in
float32: rounding D or the interpolation matrices changes the
discretisation itself (the derivative of a constant is no longer zero,
D and D^T are no longer transposes), which the exact solves then do not
match, and the full-size step blew up; the factorisations are solvers,
not products.

Imports neither JAX nor the program.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from . import mesh2d

BDF = {0: (1.0, (1.0, 0.0, 0.0)), 1: (1.5, (2.0, -0.5, 0.0)),
       2: (11.0 / 6.0, (3.0, -1.5, 1.0 / 3.0))}
EXT = {0: (1.0, 0.0, 0.0), 1: (2.0, -1.0, 0.0), 2: (3.0, -3.0, 1.0)}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits), to nearest even."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


class _Linear(torch.autograd.Function):
    """y = f(x) for a linear f with its transpose fT; ``rnd`` rounds the
    operand of the product (and of its transpose)."""

    @staticmethod
    def forward(ctx, x, f, fT, rnd):
        ctx.fT, ctx.rnd = fT, rnd
        return f(rnd(x))

    @staticmethod
    def backward(ctx, g):
        return ctx.fT(ctx.rnd(g)), None, None, None


def _along(M: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply M (out, in) along element axis 1 or 2 of (E, n, n, ...)."""
    if axis == 1:
        return torch.einsum("ai,ei...->ea...", M, x)
    return torch.einsum("bj,eij...->eib...", M, x)


class Tangent:
    """The reference tangent propagator of one configuration about one
    base flow, on ``device`` in ``dtype`` (``tf32``: the TF32 control)."""

    def __init__(self, cfg: dict, base_u, device, dtype=torch.float64, tf32: bool = False,
                 mesh: mesh2d.Mesh = None):
        if tf32 and dtype != torch.float32:
            raise ValueError("tf32 rounds float32 products")
        self.m = m = mesh2d.build(cfg) if mesh is None else mesh
        self.dev, self.dtype = torch.device(device), dtype
        self.nu = 1.0 / float(cfg["reynolds"])
        self.dt = float(cfg["dt"])
        n, E = m.n, m.nelem
        self.n, self.npr = n, n - 2
        z, _ = mesh2d.gll(n)
        nd = mesh2d.dealias_points(n)
        zf, wf = np.polynomial.legendre.leggauss(nd)
        zg, _ = np.polynomial.legendre.leggauss(n - 2)
        Jd = mesh2d.interp(z, zf)  # (nd, n)
        Jpg = mesh2d.interp(zg, z)  # (n, npr): Gauss -> GLL
        D = mesh2d.diff(n)
        self.rnd = tf32_round if tf32 else (lambda x: x)
        mat = self._t
        self.D, self.DT = mat(D), mat(D.T)
        self.Jd, self.JdT = mat(Jd), mat(Jd.T)
        self.Jpg, self.JpgT = mat(Jpg), mat(Jpg.T)
        for k in ("rx", "ry", "sx", "sy", "bm", "vmask"):
            setattr(self, k, self._t(getattr(m, k)))
        bmg = np.zeros(m.nglobal)
        np.add.at(bmg, m.gid.ravel(), m.bm.ravel())
        self.binv = self._t(1.0 / bmg[m.gid])
        self.bm_sponge = self._t(m.bm * m.sponge)
        bms = m.bms
        self.bms = self._t(bms)
        self.bms_inv = self._t(np.where(bms > 0, 1.0 / np.where(bms > 0, bms, 1.0), 0.0))
        interp2 = lambda f: np.einsum("ai,bj,eij->eab", Jd, Jd, f)
        self.wjac_d = self._t(np.outer(wf, wf)[None] * interp2(m.jac))
        self.gid = torch.as_tensor(m.gid.reshape(-1), device=self.dev)
        free = np.flatnonzero(self._free_global())
        self.free = torch.as_tensor(free, device=self.dev)
        self.nfree = free.size

        # the base flow and what the linearised convection needs of it
        U = torch.as_tensor(np.asarray(base_u, np.float64), device=self.dev).to(dtype)
        self.U_f = [self._fine(U[..., c]) for c in range(2)]
        self.gradU_f = [[self._fine(g) for g in self._grad(U[..., c])] for c in range(2)]

        # the exact solves
        self.Hlu = {k: self._factor(self._helmholtz(BDF[k][0] / self.dt)) for k in range(3)}
        self.Slu = self._factor(self._pressure())

    # -- set-up --------------------------------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), device=self.dev).to(self.dtype)

    def _free_global(self) -> np.ndarray:
        f = np.zeros(self.m.nglobal, bool)
        f[self.m.gid.ravel()] = self.m.vmask.ravel() > 0
        return f

    def _elem_ops(self):
        """Per-element derivative operators on the flattened (i, j) index."""
        n = self.n
        D = mesh2d.diff(n)
        return np.kron(D, np.eye(n)), np.kron(np.eye(n), D)

    def _helmholtz(self, h2: float) -> sp.csr_matrix:
        """nu K + h2 B assembled on the free global nodes."""
        m, n = self.m, self.n
        Dr, Ds = self._elem_ops()
        f = lambda a: a.reshape(m.nelem, n * n)
        g11, g12, g22 = f(m.g11), f(m.g12), f(m.g22)
        K = (np.einsum("pa,ep,pb->eab", Dr, g11, Dr) + np.einsum("pa,ep,pb->eab", Dr, g12, Ds)
             + np.einsum("pa,ep,pb->eab", Ds, g12, Dr) + np.einsum("pa,ep,pb->eab", Ds, g22, Ds))
        H = self.nu * K
        H[:, np.arange(n * n), np.arange(n * n)] += h2 * f(m.bm)
        return self._assemble(H, m.gid.reshape(m.nelem, -1), m.gid.reshape(m.nelem, -1),
                              self.nfree, self.nfree, True, True)

    def _assemble(self, blocks, rows, cols, nr, nc, rows_global, cols_global):
        idx = np.full(self.m.nglobal, -1)
        idx[self._free_global()] = np.arange(self.nfree)
        r = np.broadcast_to(rows[:, :, None], blocks.shape)
        c = np.broadcast_to(cols[:, None, :], blocks.shape)
        r = idx[r] if rows_global else r
        c = idx[c] if cols_global else c
        keep = (r >= 0) & (c >= 0)
        return sp.coo_matrix((blocks[keep], (r[keep], c[keep])), shape=(nr, nc)).tocsr()

    def _pressure(self) -> sp.csr_matrix:
        """S = G^T B^-1 G on the free velocity nodes, G = D^T (the weak
        pressure gradient) assembled from the elements."""
        m, n, npr = self.m, self.n, self.npr
        Dr, Ds = self._elem_ops()
        zg, _ = np.polynomial.legendre.leggauss(npr)
        z, _ = mesh2d.gll(n)
        Jpg = mesh2d.interp(zg, z)
        P = np.kron(Jpg, Jpg)  # (n^2, npr^2)
        f = lambda a: a.reshape(m.nelem, n * n)
        bmP = f(m.bm)[:, :, None] * P[None]
        cols = (np.arange(m.nelem)[:, None] * npr * npr + np.arange(npr * npr)[None])
        bmg = np.zeros(m.nglobal)
        np.add.at(bmg, m.gid.ravel(), m.bm.ravel())
        binv = 1.0 / bmg[self._free_global()]
        S = None
        for a, b in (("rx", "sx"), ("ry", "sy")):
            Ge = (np.einsum("pa,ep,epq->eaq", Dr, f(getattr(m, a)), bmP)
                  + np.einsum("pa,ep,epq->eaq", Ds, f(getattr(m, b)), bmP))
            G = self._assemble(Ge, m.gid.reshape(m.nelem, -1), cols, self.nfree,
                               m.nelem * npr * npr, True, False)
            part = (G.T @ sp.diags(binv) @ G).tocsr()
            S = part if S is None else S + part
        return S

    def _factor(self, A: sp.csr_matrix):
        """The sparse LU factorisation of an SPD matrix (symmetrised), on
        the host in the reference's precision: a whole-mesh dense inverse
        would not fit beside the device's other work at the cells' sizes."""
        A = (0.5 * (A + A.T)).tocsc().astype(np.dtype(str(self.dtype).split(".")[-1]))
        return spla.splu(A, permc_spec="MMD_AT_PLUS_A")

    # -- linear building blocks ------------------------------------------
    def _lin(self, x, f, fT):
        return _Linear.apply(x, f, fT, self.rnd)

    def _along(self, M, MT, x, axis):
        return self._lin(x, lambda v: _along(M, v, axis), lambda g: _along(MT, g, axis))

    def _grad(self, u):
        ur = self._along(self.D, self.DT, u, 1)
        us = self._along(self.D, self.DT, u, 2)
        return self.rx * ur + self.sx * us, self.ry * ur + self.sy * us

    def _grad_t(self, wr, ws):
        return self._along(self.DT, self.D, wr, 1) + self._along(self.DT, self.D, ws, 2)

    def _fine(self, f):
        return self._along(self.Jd, self.JdT, self._along(self.Jd, self.JdT, f, 1), 2)

    def _coarse(self, F):
        return self._along(self.JdT, self.Jd, self._along(self.JdT, self.Jd, F, 1), 2)

    def _div_to_p(self, u):
        d = self.bm * (self._grad(u[..., 0])[0] + self._grad(u[..., 1])[1])
        return self._along(self.JpgT, self.Jpg, self._along(self.JpgT, self.Jpg, d, 1), 2)

    def _grad_from_p(self, q):
        zb = self.bm * self._along(self.Jpg, self.JpgT,
                                   self._along(self.Jpg, self.JpgT, q, 1), 2)
        return torch.stack([self._grad_t(self.rx * zb, self.sx * zb),
                            self._grad_t(self.ry * zb, self.sy * zb)], dim=-1)

    def _to_global(self, x):
        flat = x.reshape(self.gid.numel(), -1)
        return torch.zeros((self.m.nglobal, flat.shape[1]), dtype=x.dtype,
                           device=x.device).index_add(0, self.gid, flat)

    def _to_local(self, g, shape):
        return g[self.gid].reshape(shape)

    def _minv_free(self, g):
        vm = self.vmask[..., None]
        return vm * self.binv[..., None] * self._to_local(self._to_global(vm * g), g.shape)

    def _solve(self, b, lu):
        def solve(v, trans="N"):
            x = lu.solve(v.detach().cpu().numpy(), trans=trans)
            return torch.as_tensor(x, device=v.device, dtype=v.dtype)

        return _Linear.apply(b, solve, lambda g: solve(g, "T"), lambda v: v)

    def _vsolve(self, rhs, k):
        b = self._to_global(rhs)[self.free]
        x = self._solve(b, self.Hlu[k])
        xg = torch.zeros((self.m.nglobal, 2), dtype=rhs.dtype, device=rhs.device)
        return self._to_local(xg.index_copy(0, self.free, x), rhs.shape)

    def _psolve(self, r):
        return self._solve(r.reshape(-1, 1), self.Slu).reshape(r.shape)

    def _convect_lin(self, u):
        """C(U) u + C(u) U, component by component."""
        out = []
        for c in range(2):
            gx, gy = self._grad(u[..., c])
            F = (self.U_f[0] * self._fine(gx) + self.U_f[1] * self._fine(gy)
                 + self._fine(u[..., 0]) * self.gradU_f[c][0]
                 + self._fine(u[..., 1]) * self.gradU_f[c][1])
            out.append(self._coarse(self.wjac_d * F))
        return torch.stack(out, dim=-1)

    # -- the propagator ---------------------------------------------------
    def step(self, st, k: int):
        u, p, ul0, ul1, nl0, nl1 = st
        g0, b = BDF[k]
        a = EXT[k]
        dt = self.dt
        bm = self.bm[..., None]
        E = -self._convect_lin(u) - self.bm_sponge[..., None] * u
        rhs = ((1.0 / dt) * bm * (b[0] * u + b[1] * ul0 + b[2] * ul1)
               + a[0] * E + a[1] * nl0 + a[2] * nl1 + self._grad_from_p(p))
        us = self._vsolve(rhs, k)
        dp = self._psolve(-(g0 / dt) * self._div_to_p(us))
        un = us + (dt / g0) * self._minv_free(self._grad_from_p(dp))
        return un, p + dp, u, ul0, E, nl0

    def matvec(self, q: torch.Tensor, nsteps: int) -> torch.Tensor:
        u = q.to(device=self.dev, dtype=self.dtype)
        z = torch.zeros_like(u)
        p = torch.zeros((self.m.nelem, self.npr, self.npr), dtype=self.dtype, device=self.dev)
        st = (u, p, z, z, z, z)
        for i in range(nsteps):
            st = self.step(st, min(i, 2))
        return st[0]

    def rmatvec(self, w: torch.Tensor, nsteps: int) -> torch.Tensor:
        """The adjoint in the sponge-masked energy product, projected onto
        the admissible (Dirichlet-free) fields: vmask bms^+ M^T bms w."""
        ct = self.bms[..., None] * w.to(device=self.dev, dtype=self.dtype)
        q = torch.zeros_like(ct, requires_grad=True)
        with torch.enable_grad():
            (r,) = torch.autograd.grad(self.matvec(q, nsteps), q, ct)
        return (self.vmask * self.bms_inv)[..., None] * r.detach()

    def apply(self, direction: str, x: torch.Tensor, nsteps: int) -> torch.Tensor:
        if direction == "matvec":
            with torch.no_grad():
                return self.matvec(x, nsteps)
        return self.rmatvec(x, nsteps)
