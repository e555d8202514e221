"""Build and load the port's hand-written CUDA kernels (``csrc/``).

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (Hopper) into one shared
library with a plain C interface, loaded with ``ctypes``.  The build happens
at first use, on the machine with the card, into
``nekstab_next_tpu_torch/_build/`` (listed in ``.gitignore``); the library's
file name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Nothing here runs at
import time: the CPU tests import every module without ``nvcc``.
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
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",  # -v: register report
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of the C entry points, in order
_SIGNATURES = {
    "nsk_fused_helmholtz_cg": (
        [_I] * 5 + [_F] * 3        # device, n, E, C, maxiter; tol, h1, h2
        + [_P] * 8                 # rhs, x, r, p, z, Ap, w, part
        + [_P] * 10                # D, S, lam, fgeo, g11, g12, g22, bm, imult, vmask
        + [_P] * 3 + [_P]          # gid, gs_off, gs_idx; stream
    ),
    "nsk_fused_pressure_cg": (
        [_I] * 5 + [_F] + [_I]     # device, n, E, nc, maxiter; tol; project_mean
        + [_P] * 10                # rhs, x, r, p, z, Ap, w, rc, xc, part
        + [_P] * 12                # D, Jg, Kc, rx, ry, sx, sy, bm, binv, vmask, pinv, Acinv
        + [_P] * 6 + [_P]          # cid, vtx_off, vtx_idx, gid, gs_off, gs_idx; stream
    ),
}


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 build_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when loaded from a prior build
        self.build_log = build_log

    def __getattr__(self, name):
        return getattr(self.lib, name)


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


def library() -> KernelLibrary:
    """Build (if needed) and load the kernels' library; cached per process."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        cu, cuh = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in cu + cuh:
            h.update(f.name.encode())
            h.update(f.read_bytes())
        path = BUILD_DIR / f"libnekstab_cuda_{h.hexdigest()[:16]}.so"
        log_path = path.with_suffix(".log")
        seconds = 0.0
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
                )
            log_path.write_text(res.stdout + res.stderr)
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        log = log_path.read_text() if log_path.exists() else ""
        _loaded = KernelLibrary(lib, path, seconds, log)
        return _loaded
