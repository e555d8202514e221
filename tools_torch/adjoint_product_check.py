"""Is a saved adjoint mode an eigenvector of the adjoint in the
sponge-masked product, or in the plain mass product?

    python3 tools_torch/adjoint_product_check.py [--artifacts DIR] [--preset quick|full] [--cpu]

``LinearizedOperator.rmatvec`` is the transpose of the tangent propagator M
in the sponge-masked energy product, ``W⁺ Mᵀ W`` with ``W = diag(bm1s)``
(zero inside the sponge), as the JAX package's is.  That operator is the
adjoint of M restricted to fields that vanish in the sponge, so its
eigenvalues need not be the conjugates of M's.  With ``W = diag(bm)`` (the
plain mass matrix) the transpose is the true adjoint of M.  This script
loads a preset's saved base flow and adjoint mode (``--artifacts``, default
``cylinder_out2``, the quick preset) and prints the mode's eigen-residual
``||A v - mu v|| / ||v||`` with its saved eigenvalue under both operators
(each residual in its own product), on the fused-IR mixed-precision stepper
at the example's settings.  Runs on the card, or with ``--cpu`` on the CPU
(the kernels' plain versions; minutes for the quick preset).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PRESETS = {  # examples_torch/cylinder_stability.py's geometries
    "quick": dict(nr=6, ntheta=16, order=6, outer_radius=20.0),
    "full": dict(nr=16, ntheta=48, order=6, outer_radius=40.0),
}
MIXED = dict(pressure_tol=1e-8, velocity_tol=1e-9, pressure_maxiter=500,
             velocity_maxiter=200, pressure_precond="block", fused_solves=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifacts", default="cylinder_out2")
    ap.add_argument("--preset", default="quick", choices=sorted(PRESETS))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args()

    import torch
    from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.io import load_field
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

    if args.cpu:
        torch.set_num_threads(min(8, os.cpu_count() or 1))
    dev = "cpu" if args.cpu else None
    art = ROOT / args.artifacts
    load = lambda name: load_field(str(art / f"{name}_cyl_00001.npz"))
    case = CylinderCase(reynolds=60.0, **PRESETS[args.preset], device=dev,
                        mixed_precision=True, solver=SolverConfig(**MIXED))
    nsteps = max(int(round(1.0 / case.dt)), 1)
    case.dt = 1.0 / nsteps
    ns = case.make_ns()
    s = ns.sem
    op = LinearizedOperator(ns, torch.as_tensor(load("BF").u, device=s.device),
                            nsteps=nsteps)
    lam = load("aRe").meta["eigenvalue"]
    mu = np.exp(complex(*lam) * op.T)
    re, im = (torch.as_tensor(load(k).u, device=s.device) for k in ("aRe", "aIm"))
    vjps = op._stage_vjps()

    def transpose_in(weight):
        """W⁺ Mᵀ W for W = diag(weight), then the vmask projection."""
        inv = torch.where(weight > 0, 1.0 / torch.where(weight > 0, weight,
                                                        torch.ones_like(weight)),
                          torch.zeros_like(weight))

        def apply(w):
            ct = op.steps.fields(w * weight)
            for i in reversed(range(op.nsteps)):
                (ct,) = vjps[min(i, 2)](ct)
            return ct[0] * inv * s.vmask
        return apply

    print(f"{args.artifacts}: {s.nelem} elements, {nsteps} steps, adjoint mode with "
          f"lambda {lam[0]:.9f} {lam[1]:+.9f}i; device {s.device}", flush=True)
    for name, weight in (("sponge-masked product (bm1s, rmatvec)", s.bms[..., None]),
                         ("plain mass product (bm)", s.bm[..., None])):
        A = transpose_in(weight)
        norm = lambda parts: float(sum(torch.sum(p * p * weight) for p in parts)) ** 0.5
        Ar, Ai = A(re), A(im)
        r = (Ar - mu.real * re + mu.imag * im, Ai - mu.real * im - mu.imag * re)
        print(f"  adjoint in the {name}: eigen-residual {norm(r) / norm((re, im)):.3e}",
              flush=True)


if __name__ == "__main__":
    main()
