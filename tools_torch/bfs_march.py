"""March the backward-facing-step base flow in f32 (the counterpart of
``tools/bfs_tpu_march.py``) and write ``<outdir>/bfs_march.npz``, which
``examples_torch/bfs_transient_growth.py`` continues from in f64.

The 2-D Re = 500 step is linearly stable, so plain DNS converges to the
steady state; the march runs unsponged (the steady state of pure NS).
``--fused`` runs both inner solves as the CUDA kernels K1/K2 (element-block
+ Q1 pressure preconditioner, caps 40/350); without it the plain solves
with ``'schwarz'`` at caps 40/24.

Usage: python3 tools_torch/bfs_march.py [--preset quick] [--steps 60000] [--fused]

Runs on the current CUDA device (``NEKSTAB_CPU=1``: the CPU).  Needs
``PYTHONPATH`` to hold the repository root where the package is not
installed; imports nothing of JAX.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch.bfs_transient_growth import (
    PRESETS, build_case, device_of_env, f32_solver, mesh_fingerprint,
)
from nekstab_next_tpu_torch.io import save_field


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="quick", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=60000)
    ap.add_argument("--chunk", type=int, default=2000)
    ap.add_argument("--tol", type=float, default=2e-5)
    ap.add_argument("--outdir", default="bfs_out")
    ap.add_argument("--fused", action="store_true",
                    help="both inner solves as the CUDA kernels K1/K2 (block+Q1, "
                         "caps 40/350)")
    args = ap.parse_args()
    P = PRESETS[args.preset]
    case = build_case(P, dtype=torch.float32, solver=f32_solver(args.fused), sponge=False,
                      device=device_of_env())
    sem = case.sem
    ns = case.make_ns()
    print(f"[march] nelem={case.mesh.nelem} order={P['order']} "
          f"dt={case.dt:.4f} dtype=f32 device={sem.device}", flush=True)

    st = ns.make_state(case.initial_flow())
    t0 = time.time()
    steps = 0
    res = np.inf
    while steps < args.steps:
        st1 = ns.advance(st, args.chunk - 1)
        st = ns.step(st1)
        steps += args.chunk
        du = st.u - st1.u
        res = float(torch.sqrt(sum(sem.inner(du[..., d], du[..., d], masked=False)
                                   for d in range(2))))
        print(f"[march] step {steps}  res={res:.3e}  ({time.time()-t0:.0f}s)",
              flush=True)
        # a healthy march has res ~ O(1e-3) after the initial transient
        if not np.isfinite(res) or res > 1e3:
            raise SystemExit(f"f32 march diverged (res={res:.3e})")
        if res < args.tol:
            break
    out = os.path.join(args.outdir, "bfs_march.npz")
    save_field(out, st.u, p=st.p, time=float(st.time), residual=res,
               **mesh_fingerprint(case, P))
    print(f"[march] saved {out} (res {res:.3e}, {steps} steps, "
          f"{time.time()-t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
