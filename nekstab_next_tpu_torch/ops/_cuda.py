"""Build and load the port's hand-written CUDA kernels (``csrc/``).

``nvcc`` compiles each ``csrc/*.cu`` for ``sm_90a`` (Hopper) into a shared
library of its own with a plain C interface, loaded with ``ctypes``; the
compilers of all sources run at once, so a build takes as long as its
slowest source whatever the number of kernels, and an edit to one source
rebuilds only that one.  The build happens at first use, on
the machine with the card, into ``nekstab_next_tpu_torch/_build/`` (listed in
``.gitignore``); a library's file name carries a hash of its source, the
shared headers and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import time: the CPU
tests import every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",  # -v: register report
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of the C entry points, in order; ``nsk_<stem>`` and
# ``nsk_<stem>_<query>`` are defined by ``csrc/<stem>.cu``
_SIGNATURES = {
    "nsk_fused_helmholtz_cg": (
        [_I] * 5 + [_F] * 3        # device, n, E, C, maxiter; tol, h1, h2
        + [_P] * 9                 # rhs, x, r, p, z, Ap, w, bar, part
        + [_P] * 10                # D, S, lam, fgeo, g11, g12, g22, bm, imult, vmask
        + [_P, _I] + [_P] * 2      # copies, M; stream, info
    ),
    "nsk_fused_pressure_cg": (
        [_I] * 5 + [_F] + [_I]     # device, n, E, nc, maxiter; tol; project_mean
        + [_P] * 10                # rhs, x, r, p, z, Ap, w, rc, bar, part
        + [_P] * 12                # D, Jg, Kc, rx, ry, sx, sy, bm, binv, vmask, pinv, Acinv
        + [_P] * 2 + [_I]          # cid, vtx, MV
        + [_P, _I] + [_P] * 2      # copies, M; stream, info
    ),
    "nsk_fused_helmholtz": (
        [_I] * 5 + [_F] * 2        # device, dim, n, E, C; h1, h2
        + [_P] * 2                 # u, out
        + [_P] * 8 + [_P]          # D (host), g0..g5, bm; stream
    ),
    "nsk_fused_helmholtz_geometry": [_I] * 5 + [_P],  # device, dim, n, E, C; info
}


class KernelLibrary:
    """The loaded shared libraries (one per source) plus what their build
    reported; the C entry points are its attributes."""

    def __init__(self, libs: Dict[str, ctypes.CDLL], paths: List[Path],
                 build_seconds: float, build_log: str):
        self.paths = paths
        self.build_seconds = build_seconds  # 0.0 when every library was built before
        self.build_log = build_log
        self._fns: Dict[str, object] = {}
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(libs[_source_of(name, libs)], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._fns[name] = fn

    def __getattr__(self, name):
        try:
            return self.__dict__["_fns"][name]
        except KeyError:
            raise AttributeError(name) from None


def _source_of(name: str, stems) -> str:
    """The source that defines a C entry point: the longest stem with
    ``name == nsk_<stem>`` or ``name == nsk_<stem>_<anything>``."""
    tail = name[len("nsk_"):]
    return max((s for s in stems if tail == s or tail.startswith(s + "_")), key=len)


_lock = threading.Lock()
_loaded: Optional[KernelLibrary] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built at first use and "
            "need the CUDA toolkit"
        )
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _library_path(src: Path, headers: List[Path]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in headers + [src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def library() -> KernelLibrary:
    """Build (if needed) and load the kernels' libraries; cached per process."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        cu, cuh = _sources()
        paths = [_library_path(f, cuh) for f in cu]
        jobs = []  # (process, tmp, path, source): every nvcc started at once
        t0 = time.perf_counter()
        for src, path in zip(cu, paths):
            if path.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((proc, tmp, path, src))
        failed = []
        for proc, tmp, path, src in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out}")
                continue
            path.with_suffix(".log").write_text(out)
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        seconds = time.perf_counter() - t0 if jobs else 0.0
        libs = {src.stem: ctypes.CDLL(str(p)) for src, p in zip(cu, paths)}
        log = "".join(p.with_suffix(".log").read_text()
                      for p in paths if p.with_suffix(".log").exists())
        _loaded = KernelLibrary(libs, paths, seconds, log)
        return _loaded
