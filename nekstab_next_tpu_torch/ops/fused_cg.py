"""Whole-solve CG kernels for the two elliptic inner solves, with their plain
PyTorch versions.

Port of ``nekstab_next_tpu/ops/fused_cg.py``.  Each class runs an entire
preconditioned-CG solve as ONE hand-written CUDA kernel launch on Hopper
(``csrc/fused_helmholtz_cg.cu``, ``csrc/fused_pressure_cg.cu``):

* :class:`FusedHelmholtzCG` — ``P (h1 K + h2 B) P x = rhs`` with the FDM
  preconditioner ``P fdm P`` (the velocity solve), C components at once;
* :class:`FusedPressureCG` — ``E q = D M^-1 D^T q = rhs`` on the Gauss
  pressure space with the exact element-block inverse + Q1 vertex coarse
  level (the pressure solve).

``solve`` launches the kernel for a CUDA tensor and runs the plain PyTorch
version (``plain``) only for a CPU tensor; there is no fallback from one to
the other.  ``plain`` is the same function — the same live-masked PCG, the
same early exit at ``rr <= tol^2 bb`` and ``maxiter`` cap, the same FDM
threshold and preconditioners — written with the ``SEM`` operators; the
tests hold it against the JAX kernels and the card holds the kernels
against it.  Each instance counts its kernel launches in ``launches`` and
keeps the last launch's grid (``grid``, ``resident``); while tracing is on
(``utils/tracing.py``) each launch's, or CPU solve's, CG iterations go to
the kernel's iteration log.

Scope: 2-D, single device, float32 fields, n = order + 1 in 4..8 (one
element's n*n nodes fit a 64-thread slot).  Unlike the TPU kernels, any
conforming mesh works: the direct-stiffness sum is a gather over the
node->copies table, not a shift decomposition.

The fused-IR route (``ir=True``, the mixed-precision stepper): the SEM is
float64 and each solve is the float32 inner solve of iterative refinement
(ops/cg.py).  The kernels' constants are cast to float32 from the float64
factors; ``solve`` takes a float64 right-hand side, runs the kernel on its
float32 copy and returns float64.  ``plain`` then computes at float32 on a
float32 copy of the SEM's factors (:func:`f32_twin`), so the card holds
the kernel against the same function.
"""

from __future__ import annotations

import copy
import ctypes
import functools

import numpy as np
import torch

from ..utils import tracing
from .cg import pcg
from .core import gather_table
from .schwarz import make_pressure_operator

KERNEL_N = range(4, 9)  # supported n = order + 1


def check_kernel_scope(sem, ir: bool = False) -> None:
    """Raise ValueError if the fused kernels cannot take this SEM; with
    ``ir`` (the kernels as the inner solves of iterative refinement) a
    float64 SEM is taken too."""
    if sem.dtype != torch.float32 and not (ir and sem.dtype == torch.float64):
        raise ValueError(
            f"fused_solves needs float32 fields (got {sem.dtype}); the f64 "
            "path runs the plain PyTorch solves, and mixed_precision the "
            "kernels as the f32 inner solves of iterative refinement"
        )
    if sem.n not in KERNEL_N:
        raise ValueError(
            f"fused CG kernels take n = order + 1 in {KERNEL_N.start}.."
            f"{KERNEL_N.stop - 1} (got n = {sem.n})"
        )


def padded_lists(keys: np.ndarray, nkeys: int) -> np.ndarray:
    """(nkeys, m) int32: the slots of each key in increasing slot order,
    padded with -1 (m: the most slots any key has).  The kernels sum over a
    row in this order."""
    tbl = gather_table(keys, nkeys)
    return np.where(tbl == keys.size, -1, tbl).astype(np.int32)


def f32_twin(sem):
    """A copy of a SEM whose float factors are cast to float32 (its integer
    tables shared): the operators the plain versions of the fused-IR route
    call, at the precision and from the values of the kernels' constants."""
    twin = copy.copy(sem)
    twin._buffers = {k: (v.to(torch.float32) if v is not None and v.is_floating_point()
                         else v) for k, v in sem._buffers.items()}
    twin.dtype = torch.float32
    return twin


class _FusedBase:
    KERNEL: str  # the kernel's name in the iteration logs
    fixed_barriers = 2  # grid barriers a launch crosses outside its iterations

    def __init__(self, sem, maxiter: int, tol: float, ir: bool = False):
        check_kernel_scope(sem, ir)
        self.sem = sem
        self.n, self.E = sem.n, sem.nelem
        self.maxiter = int(maxiter)
        self.tol = float(tol)
        self.launches = 0
        self._dev = None  # device-side kernel constants, built at first launch
        # the last launch: its grid (blocks), the most blocks that fit on the
        # card at once, and its zeroed partials + barrier-counter buffer
        self.grid = self.resident = 0
        self._sync = None

    @functools.cached_property
    def _ops(self):
        """The SEM whose operators ``plain`` calls: float32 factors (the SEM
        itself on the float32 route), built at the first plain solve."""
        return self.sem if self.sem.dtype == torch.float32 else f32_twin(self.sem)

    def _gather_consts(self, dev) -> dict:
        """The dssum as the kernels read it: every local node's list of the
        local copies of its global node (``padded_lists`` order, -1 pads)."""
        sem = self.sem
        copies = padded_lists(sem.gid_np, sem.nglobal)[sem.gid_np]
        return dict(copies=torch.as_tensor(copies, device=dev))

    def _sync_buffer(self, dev) -> torch.Tensor:
        """Zeroed float64 scratch for one launch: four rows of block partials
        (at most E / 4 blocks), then the grid barrier's arrival counter."""
        self._sync = torch.zeros(4 * self.E + 1, dtype=torch.float64, device=dev)
        return self._sync

    def _pointers(self, sync: torch.Tensor):
        """(barrier counter, partials) pointers into a ``_sync_buffer``."""
        return sync.data_ptr() + 8 * 4 * self.E, sync.data_ptr()

    def _launched(self, err: int, info, name: str) -> None:
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        self.grid, self.resident = int(info[0]), int(info[1])
        self.launches += 1
        log = tracing.iteration_log(self.KERNEL)
        if log is not None:
            log.launch(self._sync[4 * self.E:].view(torch.int32)[:1], self.grid,
                       self.fixed_barriers)

    def _plain_logged(self, *args):
        """``plain`` on a CPU tensor, its iterations logged while tracing is on."""
        log = tracing.iteration_log(self.KERNEL)
        if log is None:
            return self.plain(*args)
        x, k = self.plain(*args, return_iters=True)
        log.solve(k)
        return x

    def _check(self, x: torch.Tensor, shape) -> None:
        if x.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got device {x.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"expected float32, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"expected shape {tuple(shape)}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("expected a contiguous tensor")
        if x.device != self.sem.device:
            raise ValueError(f"tensor on {x.device}, SEM on {self.sem.device}")


class FusedHelmholtzCG(_FusedBase):
    """One-launch PCG solve of ``P (h1 K + h2 B) P x = rhs`` for rhs in
    range(P), ``P = mask inv_mult dssum(mask .)``, preconditioned by
    ``P fdm P`` with the FDM denominator rebuilt from the runtime h1, h2
    (threshold 1e-6 ref).  Early exit on ||r|| <= tol ||b|| over all
    components together, at most ``maxiter`` iterations.

    Replaces the TPU kernel ``nekstab_next_tpu/ops/fused_cg.py``
    ``FusedHelmholtzCG._build_call``."""

    KERNEL = "k1"

    def __init__(self, sem, mask: torch.Tensor, maxiter: int, tol: float,
                 ir: bool = False):
        super().__init__(sem, maxiter, tol, ir)
        mask = mask if mask.dim() == 4 else mask[..., None]
        self.C = int(mask.shape[-1])
        self.mask = mask.to(device=sem.device, dtype=torch.float32).contiguous()

    def _P(self, y: torch.Tensor) -> torch.Tensor:
        sem, m = self._ops, self.mask
        return m * (sem.inv_mult[..., None] * sem.dssum(m * y))

    def plain(self, rhs: torch.Tensor, h1, h2, return_iters: bool = False):
        """The plain PyTorch version of the kernel (any device), at float32
        and returned in ``rhs``'s dtype; with ``return_iters`` also the
        number of CG iterations it took."""
        sem = self._ops
        squeeze = rhs.dim() == 3
        b = rhs.to(torch.float32)
        b = b[..., None] if squeeze else b

        def helm(y):
            return torch.stack(
                [sem.helmholtz_local(y[..., c], h1, h2) for c in range(self.C)], dim=-1
            )

        x, k = pcg(lambda y: self._P(helm(y)), b,
                   precond=lambda r: self._P(sem.fdm_apply(r, h1, h2, rel=1e-6)),
                   tol=self.tol, maxiter=self.maxiter,
                   dot=lambda a, c: torch.sum(a * c), return_iters=True)
        x = (x[..., 0] if squeeze else x).to(rhs.dtype)
        return (x, k) if return_iters else x

    def solve(self, rhs: torch.Tensor, h1, h2) -> torch.Tensor:
        """Solve A x = rhs for rhs in range(P); rhs (E, n, n[, C]), float32,
        or float64 on the fused-IR route (solved at float32)."""
        if rhs.device.type == "cpu":
            return self._plain_logged(rhs, h1, h2)
        x = self._launch(rhs.to(torch.float32).contiguous(), float(h1), float(h2))
        return x.to(rhs.dtype)

    def _launch(self, rhs: torch.Tensor, h1: float, h2: float) -> torch.Tensor:
        from ._cuda import library

        squeeze = rhs.dim() == 3
        b = rhs[..., None] if squeeze else rhs
        self._check(b, (self.E, self.n, self.n, self.C))
        if self._dev is None:
            self._dev = self._device_consts(b.device)
        c = self._dev
        out = torch.empty_like(b)
        scratch = torch.empty((5,) + tuple(b.shape), dtype=b.dtype, device=b.device)
        sync = self._sync_buffer(b.device)
        info = (ctypes.c_int * 2)()
        lib = library()
        err = lib.nsk_fused_helmholtz_cg(
            b.device.index or 0, self.n, self.E, self.C, self.maxiter, self.tol,
            h1, h2, b.data_ptr(), out.data_ptr(),
            *(scratch[k].data_ptr() for k in range(5)), *self._pointers(sync),
            *(c[k].data_ptr() for k in ("D", "S", "lam", "fgeo", "g11", "g12",
                                        "g22", "bm", "imult", "vmask", "copies")),
            c["copies"].shape[1], torch.cuda.current_stream(b.device).cuda_stream,
            ctypes.addressof(info),
        )
        self._launched(err, info, "fused_helmholtz_cg")
        return out[..., 0] if squeeze else out

    def _device_consts(self, dev) -> dict:
        sem = self.sem
        f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
        hl = sem.fdm_len.double()
        fgeo = torch.stack(
            [hl[:, 1] / hl[:, 0], hl[:, 0] / hl[:, 1], hl[:, 0] * hl[:, 1]], dim=1
        )
        c = dict(D=f32(sem.D), S=f32(sem.fdm_S), lam=f32(sem.fdm_lam),
                 fgeo=f32(fgeo), g11=f32(sem.g11), g12=f32(sem.g12),
                 g22=f32(sem.g22), bm=f32(sem.bm), imult=f32(sem.inv_mult),
                 vmask=f32(self.mask))
        c.update(self._gather_consts(dev))
        return c


class FusedPressureCG(_FusedBase):
    """One-launch PCG solve of the PnPn-2 pressure system
    ``E q = D M^-1 D^T q = rhs`` on the Gauss space, preconditioned by the
    exact element-block inverse (``sem.pblock_inv``) + Q1 vertex coarse
    level, with the optional mean projection of enclosed flows applied to
    the rhs and the solution.

    Replaces the TPU kernel ``nekstab_next_tpu/ops/fused_cg.py``
    ``FusedPressureCG._build_call``."""

    KERNEL = "k2"

    def __init__(self, sem, maxiter: int, tol: float, project_mean: bool = False,
                 ir: bool = False):
        super().__init__(sem, maxiter, tol, ir)
        sem.setup_pressure_blocks()
        self.project_mean = bool(project_mean)
        self.fixed_barriers = 2 + 2 * self.project_mean  # the mean projection's two
        self.npr = sem.npr

    def _project(self, q: torch.Tensor) -> torch.Tensor:
        return q - torch.sum(q) / q.numel()

    def plain(self, rhs: torch.Tensor, return_iters: bool = False):
        """The plain PyTorch version of the kernel (any device), at float32
        and returned in ``rhs``'s dtype; with ``return_iters`` also the
        number of CG iterations it took."""
        b = rhs.to(torch.float32)
        b = self._project(b) if self.project_mean else b
        x, k = pcg(make_pressure_operator(self._ops), b,
                   precond=self._ops.pressure_precond_block,
                   tol=self.tol, maxiter=self.maxiter,
                   dot=lambda a, c: torch.sum(a * c), return_iters=True)
        x = (self._project(x) if self.project_mean else x).to(rhs.dtype)
        return (x, k) if return_iters else x

    def solve(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve E q = rhs; rhs (E, npr, npr), float32, or float64 on the
        fused-IR route (solved at float32)."""
        if rhs.device.type == "cpu":
            return self._plain_logged(rhs)
        return self._launch(rhs.to(torch.float32).contiguous()).to(rhs.dtype)

    def _launch(self, rhs: torch.Tensor) -> torch.Tensor:
        from ._cuda import library

        self._check(rhs, (self.E, self.npr, self.npr))
        if self._dev is None:
            self._dev = self._device_consts(rhs.device)
        c = self._dev
        dev = rhs.device
        nc = self.sem.pc_nc
        out = torch.empty_like(rhs)
        scratch = torch.empty((4,) + tuple(rhs.shape), dtype=rhs.dtype, device=dev)
        w = torch.empty((self.E, self.n, self.n, 2), dtype=rhs.dtype, device=dev)
        rc = torch.empty((self.E, 4), dtype=rhs.dtype, device=dev)
        sync = self._sync_buffer(dev)
        info = (ctypes.c_int * 2)()
        lib = library()
        err = lib.nsk_fused_pressure_cg(
            dev.index or 0, self.n, self.E, nc, self.maxiter, self.tol,
            int(self.project_mean), rhs.data_ptr(), out.data_ptr(),
            *(scratch[k].data_ptr() for k in range(4)), w.data_ptr(),
            rc.data_ptr(), *self._pointers(sync),
            *(c[k].data_ptr() for k in ("D", "Jg", "Kc", "rx", "ry", "sx", "sy",
                                        "bm", "binv", "vmask", "pinv", "Acinv",
                                        "cid", "vtx")),
            c["vtx"].shape[1], c["copies"].data_ptr(), c["copies"].shape[1],
            torch.cuda.current_stream(dev).cuda_stream, ctypes.addressof(info),
        )
        self._launched(err, info, "fused_pressure_cg")
        return out

    def _device_consts(self, dev) -> dict:
        sem = self.sem
        f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
        # Q1 restriction folded with the Gauss -> GLL lift, in float64:
        # rc[e, c] = sum_ab Kc[c, a, b] r[e, a, b]
        Kc = torch.einsum("cij,ai,bj->cab", sem.pc_Jc.double(),
                          sem.Jp.double(), sem.Jp.double())
        c = dict(D=f32(sem.D), Jg=f32(sem.Jpg), Kc=f32(Kc),
                 rx=f32(sem.rx), ry=f32(sem.ry), sx=f32(sem.sx), sy=f32(sem.sy),
                 bm=f32(sem.bm), binv=f32(sem.binv_assembled),
                 vmask=f32(sem.vmask), pinv=f32(sem.pblock_inv),
                 Acinv=f32(sem.pc_Acinv))
        # the Q1 vertex sums: every vertex's list of (element, corner) slots
        cid = sem.pc_cid_np
        c.update(cid=torch.as_tensor(cid, dtype=torch.int32, device=dev),
                 vtx=torch.as_tensor(padded_lists(cid.reshape(-1), sem.pc_nc), device=dev))
        c.update(self._gather_consts(dev))
        return c
