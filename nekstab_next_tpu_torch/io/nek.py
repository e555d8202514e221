"""Reader and writer for native Nek5000 ``#std`` binary field files (a
host numpy copy of ``nekstab_next_tpu/io/nek.py``; the writer also takes
tensors, copied to the host first, and writes the JAX writer's bytes).

Loads the reference's fixtures (converged base flows ``BF_1cyl0.f00001``,
mode files) for cross-validation without a Nek5000 install, and writes
results for the Nek/VisIt/ParaView toolchain.  Format (Nek5000 prepost.f
``mfo_outfld``):

* 132-byte ASCII header:
  ``#std wdsize nx ny nz nelg nelgt time istep fid0 nfileo rdcode p0th ifpmesh``
  where ``rdcode`` is a subset of ``XUPTS`` (coords, velocity, pressure,
  temperature, passive scalars);
* 4-byte float endian tag (6.54321);
* ``nelgt`` int32 global element ids (the element map);
* per-field data blocks, each element contiguous, Fortran (i fastest) order:
  X: ndim coords per element interleaved by component block;
  U: ndim velocity components per element; P, T: one scalar per element.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Optional

import numpy as np
import torch


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


@dataclasses.dataclass
class NekField:
    nx: int
    ny: int
    nz: int
    nelem: int
    time: float
    istep: int
    rdcode: str
    elmap: np.ndarray  # (nelem,) global element ids (1-based)
    x: Optional[np.ndarray] = None  # (nelem, nz, ny, nx) per component dict
    y: Optional[np.ndarray] = None
    z: Optional[np.ndarray] = None
    u: Optional[np.ndarray] = None  # (nelem, nz, ny, nx, ndim)
    p: Optional[np.ndarray] = None  # (nelem, nz, ny, nx)
    t: Optional[np.ndarray] = None

    @property
    def ndim(self) -> int:
        return 2 if self.nz == 1 else 3


def read_nek_field(path: str) -> NekField:
    with open(path, "rb") as f:
        header = f.read(132).decode("ascii", errors="replace")
        if not header.startswith("#std"):
            raise ValueError(f"not a Nek '#std' field file: {path}")
        tok = header.split()
        wdsize = int(tok[1])
        nx, ny, nz = int(tok[2]), int(tok[3]), int(tok[4])
        nelg, nelgt = int(tok[5]), int(tok[6])
        time = float(tok[7])
        istep = int(tok[8])
        rdcode = tok[11]

        tag = f.read(4)
        (test,) = struct.unpack("<f", tag)
        if abs(test - 6.54321) < 1e-4:
            endian = "<"
        else:
            (test,) = struct.unpack(">f", tag)
            if abs(test - 6.54321) > 1e-4:
                raise ValueError("bad endian tag")
            endian = ">"

        elmap = np.frombuffer(f.read(4 * nelgt), dtype=f"{endian}i4").astype(
            np.int64
        )

        fdt = np.dtype(f"{endian}f{wdsize}")
        npts = nx * ny * nz
        ndim = 2 if nz == 1 else 3

        def read_block(ncomp: int) -> np.ndarray:
            """One field block: per element, ncomp contiguous component
            slabs of npts values each."""
            raw = np.frombuffer(
                f.read(nelgt * ncomp * npts * wdsize), dtype=fdt
            )
            a = raw.reshape(nelgt, ncomp, nz, ny, nx).astype(np.float64)
            return a

        out = NekField(
            nx=nx, ny=ny, nz=nz, nelem=nelgt, time=time, istep=istep,
            rdcode=rdcode, elmap=elmap,
        )
        code = rdcode.upper()
        if "X" in code:
            c = read_block(ndim)
            out.x, out.y = c[:, 0], c[:, 1]
            if ndim == 3:
                out.z = c[:, 2]
        if "U" in code:
            c = read_block(ndim)
            out.u = np.moveaxis(c, 1, -1)  # (nelem, nz, ny, nx, ndim)
        if "P" in code:
            out.p = read_block(1)[:, 0]
        if "T" in code:
            out.t = read_block(1)[:, 0]
        return out


def write_nek_field(
    path: str,
    u: Optional[np.ndarray] = None,
    p: Optional[np.ndarray] = None,
    T: Optional[np.ndarray] = None,
    x: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    z: Optional[np.ndarray] = None,
    time: float = 0.0,
    istep: int = 0,
    wdsize: int = 8,
) -> None:
    """Write a native Nek5000 ``#std`` binary field file — the reference's
    ``outpost`` (Nek prepost.f ``mfo_outfld``), so results drop into the
    Nek/VisIt/ParaView toolchain and the reference's own plot scripts.

    Inputs use this framework's layout: scalars ``(nelem, i, j[, k])`` with
    ``i`` the x-direction node index, vectors with a trailing component
    axis.  ``wdsize=8`` matches the reference's 64-bit ``BF_`` outputs
    (``param(63)=1``, core/newton_krylov.f90:155-163).  Tensors are copied
    to the host."""
    u, p, T, x, y, z = (None if a is None else np.asarray(_host(a))
                        for a in (u, p, T, x, y, z))
    ref = next(a for a in (u, p, T, x) if a is not None)
    nelem = ref.shape[0]
    ndim_mesh = ref.ndim - 1 - (1 if ref is u else 0)
    if u is not None:
        ndim_mesh = u.ndim - 2

    def to_nek(a):
        a = np.asarray(a, dtype=np.float64)
        if ndim_mesh == 2:  # (e, i, j) -> (e, 1, j, i)
            return np.transpose(a, (0, 2, 1))[:, None, :, :]
        return np.transpose(a, (0, 3, 2, 1))  # (e,i,j,k) -> (e,k,j,i)

    if ndim_mesh == 2:
        n = ref.shape[1]
        nx, ny, nz = n, ref.shape[2], 1
    else:
        nx, ny, nz = ref.shape[1], ref.shape[2], ref.shape[3]
    rdcode = ""
    blocks = []
    if x is not None:
        comps = [to_nek(x), to_nek(y)] + ([to_nek(z)] if ndim_mesh == 3 else [])
        blocks.append(np.stack(comps, axis=1))
        rdcode += "X"
    if u is not None:
        comps = [to_nek(u[..., d]) for d in range(u.shape[-1])]
        blocks.append(np.stack(comps, axis=1))
        rdcode += "U"
    if p is not None:
        blocks.append(to_nek(p)[:, None])
        rdcode += "P"
    if T is not None:
        Ta = T[..., 0] if T.ndim == ndim_mesh + 2 else T
        blocks.append(to_nek(Ta)[:, None])
        rdcode += "T"

    hdr = (
        f"#std {wdsize:1d} {nx:2d} {ny:2d} {nz:2d} {nelem:10d} {nelem:10d} "
        f"{time:20.13E} {istep:9d} {0:6d} {1:6d} {rdcode:<10s} "
        f"{0.0:15.7E} F"
    )
    with open(path, "wb") as f:
        f.write(hdr.ljust(132).encode("ascii"))
        f.write(struct.pack("<f", 6.54321))
        f.write(np.arange(1, nelem + 1, dtype="<i4").tobytes())
        for b in blocks:
            f.write(np.ascontiguousarray(b, dtype=f"<f{wdsize}").tobytes())


def nek_to_layout(a: np.ndarray) -> np.ndarray:
    """Convert a 2-D Nek block (nelem, 1, ny, nx[, ndim]) to this framework's
    (nelem, i, j[, ndim]) layout with i the x-direction node index."""
    if a.ndim == 4:
        return np.transpose(a[:, 0], (0, 2, 1))
    if a.ndim == 5:
        return np.transpose(a[:, 0], (0, 2, 1, 3))
    raise ValueError(a.shape)
