"""Time the port's two whole-solve CG kernels (K1, K2) and the flagship f32
tangent matvec of one copy of the port, on one NVIDIA GPU.

    python3 tools_torch/cg_kernel_timing.py [--root DIR]

Imports ``nekstab_next_tpu_torch`` from DIR (default: this checkout), so two
versions of the package, for example an unpacked ``git archive`` of an
earlier commit, can be timed in turns within one call.  Uses only the
wrappers' public API and ``chip_smoke.py``'s helpers from this checkout: the
flagship K1 and K2 solves at the flagship caps (device time behind a GPU
spin), the tol = 0 ``maxiter`` sweep, the digests of chip_smoke.py's
seeded K1/K2 results (equal digests: bit-identical results) and the
flagship 50-step f32 matvec (CUDA events).  Every line carries the card's
name and power limit.  Needs a CUDA device; imports nothing of JAX.
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
    from nekstab_next_tpu_torch.ops.fused_cg import FusedHelmholtzCG, FusedPressureCG
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

    if not torch.cuda.is_available():
        raise SystemExit("cg_kernel_timing: needs a CUDA device")
    if Path(nekstab_next_tpu_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"cg_kernel_timing: imported the package from "
                         f"{nekstab_next_tpu_torch.__file__}, not from {root}")
    tag = f"[{cs.card_line()}] [{root.name}]"
    case = cs.make_case(torch.float32, cs.CAPS_F32, fused=True)
    sem = case.sem
    ns = case.make_ns()
    h1, h2 = 1.0 / 60.0, (11.0 / 6.0) / case.dt
    rhs_v, rhs_p = cs.cg_inputs(sem, np.random.default_rng(0))
    k1 = FusedHelmholtzCG(sem, sem.vmask, maxiter=10, tol=1e-6)
    digests = [cs.digest(k1.solve(rhs_v, h1, h2))] + [
        cs.digest(FusedPressureCG(sem, maxiter=m, tol=1e-6).solve(rhs_p)) for m in (300, 16)]
    cs.log(f"digests {tag}: K1 {digests[0]}, K2 maxiter 300 {digests[1]}, 16 {digests[2]}")
    fp = ns.fused_p
    ms1 = cs.kernel_ms(lambda: k1.solve(rhs_v, h1, h2), 20)
    ms2 = cs.kernel_ms(lambda: fp.solve(rhs_p), 20)
    cs.log(f"timing {tag} one flagship solve: K1 {ms1:.4f} ms, K2 {ms2:.4f} ms")
    cs.cg_sweep(sem, rhs_v, rhs_p, h1, h2, tag)
    base = case.uniform_flow()
    op = LinearizedOperator(ns, base, nsteps=cs.NSTEPS)
    state = {"x": sem.vmask * base}

    def chained():
        state["x"] = op.matvec(state["x"])

    ms = cs.cuda_ms(chained, cs.REPS)
    cs.log(f"timing {tag} matvec f32 kernels: {ms:.2f} ms/matvec")


if __name__ == "__main__":
    main()
