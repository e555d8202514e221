"""Time the port's fused local Helmholtz apply (K4) of one copy of the port,
on one NVIDIA GPU, at the three shapes its paths give it.

    python3 tools_torch/k4_kernel_timing.py [--root DIR]

Imports ``nekstab_next_tpu_torch`` from DIR (default: this checkout), so two
versions of the package, for example an unpacked ``git archive`` of an
earlier commit, can be timed in turns within one call.  Uses only the
wrapper's public API and ``chip_smoke.py``'s helpers from this checkout.
For the cylinder's velocity (C = 2), the cube's velocity (C = 3) and the
cube's pressure (C = 1, h2 = 0) it prints the device time of one apply with
the L2 cache flushed and back to back (``kernel_ms``, behind a GPU spin),
the bound and the share of it, a digest of the result on a seeded input
(equal digests: bit-identical results), and the launch grid with the
resident blocks per SM where the package reports them.  Every line carries
the card's name and power limit.  Needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="directory holding the nekstab_next_tpu_torch package to time")
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    import nekstab_next_tpu_torch
    from nekstab_next_tpu_torch.cases.cube import CubeRoughnessCase
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.ops.fused_helmholtz import FusedHelmholtz

    if not torch.cuda.is_available():
        raise SystemExit("k4_kernel_timing: needs a CUDA device")
    if Path(nekstab_next_tpu_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"k4_kernel_timing: imported the package from "
                         f"{nekstab_next_tpu_torch.__file__}, not from {root}")
    tag = f"[{cs.card_line()}] [{root.name}]"
    dev = torch.device("cuda", 0)
    case = cs.make_case(torch.float32, cs.CAPS_F32, fused=True)
    cube = CubeRoughnessCase(**cs.CUBE, solver=SolverConfig(**cs.CUBE_TOL), device=dev)
    h1, h2 = 1.0 / 60.0, (11.0 / 6.0) / case.dt
    for seed, (label, sem, C, hh) in enumerate(cs.k4_shapes(case.sem, cube, h1, h2)):
        k4 = FusedHelmholtz(sem)
        u = torch.as_tensor(
            np.random.default_rng(seed).standard_normal(k4.node_shape + ((C,) if C else ())),
            dtype=torch.float32, device=dev)
        out = k4.apply(u, *hh)
        digest = cs.digest(out)
        cold = cs.kernel_ms(lambda: k4.apply(u, *hh), 50, cold=True)
        warm = cs.kernel_ms(lambda: k4.apply(u, *hh), 200)
        b = cs.k4_bound(k4, u, hh[1], C)
        if hasattr(k4, "geometry"):
            g = k4.geometry(C or 1)
            grid = (f"grid {g['grid']} blocks of {g['per_block']} elements, "
                    f"{g['threads']} threads, {g['smem']} B shared, {g['per_sm']} blocks an SM")
        else:
            grid = "grid not reported by this package"
        cs.log(f"timing {tag} K4 at the {label} shape {tuple(u.shape)}: {cold:.4f} ms L2 "
               f"flushed, {warm:.4f} ms back to back; bound {b['bound_ms'] * 1e3:.3f} us "
               f"({b['bound_by']}), share {100 * b['bound_ms'] / cold:.1f} % and "
               f"{100 * b['bound_ms'] / warm:.1f} %; digest {digest}; {grid}")


if __name__ == "__main__":
    main()
