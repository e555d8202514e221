"""Fused element-local weak Helmholtz apply ``h1 K u + h2 B u`` (K4), with
its plain PyTorch version.

Port of ``nekstab_next_tpu/ops/pallas_kernels.py`` ``FusedHelmholtz``: the
unassembled local operator of every inner CG iteration of the
mixed-precision solves (``ops/mixed.py``), in float32, 2-D and 3-D.  On a
CUDA tensor :meth:`FusedHelmholtz.apply` launches the hand-written kernel
``csrc/fused_helmholtz.cu`` (each thread contracts whole lines of an
element along i and j through shared memory and its column along k in
registers, one launch for all C components, a persistent grid that copies
the next element group while the current one computes) or raises; only a CPU tensor takes
:meth:`plain`, which is ``sem.helmholtz_local`` on float32 copies of the
factors, per component.  There is no fallback from one to the other.
``launches`` counts kernel launches; ``grid`` and ``resident`` describe the
last one.

The TPU kernel's lanes layout (nodes x padded elements) and block padding
are not carried over: the kernel reads the fields in the SEM's own
``(nelem, n, .., n[, C])`` layout.
"""

from __future__ import annotations

import torch

from .core import stiffness2
from .core3 import stiffness3
from .fused_cg import KERNEL_N  # the same n = order + 1 as K1, K2

MAX_COMPONENTS = 3  # csrc/fused_helmholtz.cu MAXC


def launch_grid(nelem: int, per_block: int, fit: int) -> int:
    """Blocks of one launch (csrc/fused_helmholtz.cu ``geometry``): one per
    group of ``per_block`` elements, at most the ``fit`` that the card holds
    at once."""
    return min(-(-nelem // per_block), fit)


def block_groups(block: int, grid: int, nelem: int, per_block: int):
    """The element ranges ``(first, count)`` that block ``block`` of ``grid``
    computes, in order: the kernel's walk over the groups of ``per_block``
    elements with a stride of the grid."""
    groups = -(-nelem // per_block)
    return [(g * per_block, min(per_block, nelem - g * per_block))
            for g in range(block, groups, grid)]


class FusedHelmholtz:
    """Float32 apply of the element-local weak Helmholtz operator of one
    ``SEM`` (2-D) or ``SEM3`` (3-D); matches ``sem.helmholtz_local(u, h1,
    h2)`` to float32 accuracy.

    Replaces the TPU kernel ``nekstab_next_tpu/ops/pallas_kernels.py``
    ``FusedHelmholtz._build_call``."""

    def __init__(self, sem):
        if sem.n not in KERNEL_N:
            raise ValueError(
                f"the fused Helmholtz kernel takes n = order + 1 in "
                f"{KERNEL_N.start}..{KERNEL_N.stop - 1} (got n = {sem.n})"
            )
        self.sem = sem
        self.ndim = sem.ndim
        self.n = sem.n
        self.nelem = sem.nelem
        keys = (("g11", "g12", "g22") if self.ndim == 2
                else ("g11", "g22", "g33", "g12", "g13", "g23"))
        f32 = lambda t: t.to(torch.float32).contiguous()
        # float32 copies on the SEM's device, read by both versions
        self.D = f32(sem.D)
        self._D_host = self.D.cpu()  # the kernel takes D in its parameters
        self.metrics = tuple(f32(getattr(sem, k)) for k in keys)
        self.bm = f32(sem.bm)
        self.launches = 0
        self._geo = {}  # launch geometry per component count, read once
        self.grid = self.resident = 0  # the last launch's blocks; blocks that fit

    @property
    def node_shape(self):
        return (self.nelem,) + (self.n,) * self.ndim

    def plain(self, u: torch.Tensor, h1, h2) -> torch.Tensor:
        """The plain PyTorch version of the kernel (any device): the SEM's
        ``helmholtz_local`` on float32 factors, per component."""
        if self.ndim == 2:
            g11, g12, g22 = self.metrics
            K = lambda v: stiffness2(self.D, g11, g12, g22, v)
        else:
            g11, g22, g33, g12, g13, g23 = self.metrics
            K = lambda v: stiffness3(self.D, g11, g12, g13, g22, g23, g33, v)
        local = lambda v: h1 * K(v) + h2 * self.bm * v
        if u.dim() == self.ndim + 2:  # trailing component axis
            return torch.stack([local(u[..., c]) for c in range(u.shape[-1])], dim=-1)
        return local(u)

    def apply(self, u: torch.Tensor, h1, h2) -> torch.Tensor:
        """``h1 K u + h2 B u`` in float32; u (nelem, n, .., n[, C])."""
        if u.device.type == "cpu":
            return self.plain(u, h1, h2)
        return self._launch(u, float(h1), float(h2))

    def _check(self, u: torch.Tensor) -> int:
        """Raise on what the kernel does not take; return C."""
        if u.device.type != "cuda":
            raise ValueError(f"expected a CUDA tensor, got device {u.device}")
        if u.device != self.D.device:
            raise ValueError(f"tensor on {u.device}, SEM on {self.D.device}")
        if u.dtype != torch.float32:
            raise ValueError(f"expected float32, got {u.dtype}")
        shape = tuple(u.shape)
        nodes = self.node_shape
        if shape == nodes:
            C = 1
        elif shape[:-1] == nodes and 1 <= shape[-1] <= MAX_COMPONENTS:
            C = shape[-1]
        else:
            raise ValueError(
                f"expected shape {nodes} or {nodes} + (C,) with C <= "
                f"{MAX_COMPONENTS}, got {shape}"
            )
        if not u.is_contiguous():
            raise ValueError("expected a contiguous tensor")
        return C

    def geometry(self, C: int) -> dict:
        """The kernel's launch geometry for C components on this SEM's
        card, queried once: ``grid`` (blocks), ``per_sm`` (resident blocks
        per SM), ``per_block`` (elements per block), ``threads``, ``smem``
        (dynamic shared memory bytes), ``sms``."""
        if C not in self._geo:
            import ctypes

            from ._cuda import library

            info = (ctypes.c_int * 6)()
            err = library().nsk_fused_helmholtz_geometry(
                self.D.device.index or 0, self.ndim, self.n, self.nelem, C, info)
            if err != 0:
                raise RuntimeError(f"fused_helmholtz: CUDA error {err} in the geometry query")
            geo = dict(zip(("grid", "per_sm", "per_block", "threads", "smem", "sms"), info))
            if geo["grid"] != launch_grid(self.nelem, geo["per_block"],
                                          geo["per_sm"] * geo["sms"]):
                raise RuntimeError(f"fused_helmholtz: unexpected launch geometry {geo}")
            self._geo[C] = geo
        return self._geo[C]

    def _launch(self, u: torch.Tensor, h1: float, h2: float) -> torch.Tensor:
        from ._cuda import library

        C = self._check(u)
        geo = self.geometry(C)
        out = torch.empty_like(u)
        g = [m.data_ptr() for m in self.metrics] + [None] * (6 - len(self.metrics))
        err = library().nsk_fused_helmholtz(
            u.device.index or 0, self.ndim, self.n, self.nelem, C, h1, h2,
            u.data_ptr(), out.data_ptr(), self._D_host.data_ptr(), *g, self.bm.data_ptr(),
            torch.cuda.current_stream(u.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"fused_helmholtz: CUDA error {err} at launch")
        self.grid, self.resident = geo["grid"], geo["per_sm"] * geo["sms"]
        self.launches += 1
        return out
