"""Backward-facing-step optimal transient growth in f32 (the counterpart of
``tools/bfs_tpu_tg.py``): the base flow from ``tools_torch/bfs_march.py``
(``<outdir>/bfs_march.npz``), then Golub-Kahan svds of the tangent
propagator and its adjoint per horizon, with the reference's sponges and
sponge-masked energy norm (svds tol 1e-4, ``k_dim = min(preset k_dim,
16)``).  ``--fused`` runs both inner solves as the CUDA kernels K1/K2
(element-block + Q1 pressure preconditioner, caps 40/350).

Usage: python3 tools_torch/bfs_tg.py [--preset barkley] [--outdir bfs_out]
           [--horizons 1.723 3.853] [--fused] [--no-sponge] [--unmasked]

Writes ``<outdir>/<--out>`` (default ``growth.json``: the fields of the JAX
tool's file, ``dtype`` naming the device) and prints one line a horizon.
Runs on the current CUDA device (``NEKSTAB_CPU=1``: the CPU).  Needs
``PYTHONPATH`` to hold the repository root where the package is not
installed; imports nothing of JAX.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from examples_torch.bfs_transient_growth import (
    BARKLEY_REF, PRESETS, build_case, device_of_env, f32_solver,
)
from nekstab_next_tpu_torch.algorithms import transient_growth_analysis
from nekstab_next_tpu_torch.io import load_field


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="barkley", choices=sorted(PRESETS))
    ap.add_argument("--outdir", default="bfs_out")
    ap.add_argument("--horizons", type=float, nargs="*", default=None)
    ap.add_argument("--k-dim", type=int, default=None)
    ap.add_argument("--no-sponge", action="store_true",
                    help="drop the sponge entirely (no damping forcing, "
                         "unmasked full-domain energy norm)")
    ap.add_argument("--unmasked", action="store_true",
                    help="keep the sponge damping but measure the unmasked "
                         "full-domain energy norm")
    ap.add_argument("--fused", action="store_true",
                    help="both inner solves as the CUDA kernels K1/K2 (block+Q1, "
                         "caps 40/350)")
    ap.add_argument("--out", default="growth.json")
    args = ap.parse_args()
    P = PRESETS[args.preset]
    horizons = tuple(args.horizons) if args.horizons else P["horizons"]
    k_dim = args.k_dim or min(P["k_dim"], 16)

    case = build_case(P, dtype=torch.float32, solver=f32_solver(args.fused),
                      sponge=False if args.no_sponge else None, device=device_of_env())
    sem = case.sem
    if args.unmasked:
        # the sponge forcing stays; the energy norm is the full domain's
        sem.bms = sem.bm
    device = (torch.cuda.get_device_name(sem.device) if sem.device.type == "cuda"
              else "cpu")
    t0 = time.time()
    print(f"[tg] nelem={case.mesh.nelem} order={P['order']} dt={case.dt:.4f} "
          f"sponge={case.sponge} device={device}", flush=True)

    bf = load_field(os.path.join(args.outdir, "bfs_march.npz"))
    base = torch.as_tensor(bf.u, dtype=torch.float32, device=sem.device)
    # the sponge damps toward the base flow, which stays an equilibrium
    ns = case.make_ns(sponge_ref=base if case.sponge else None)

    ref = np.loadtxt(BARKLEY_REF) if os.path.exists(BARKLEY_REF) else None
    rows = []
    for T in horizons:
        nsteps = max(int(round(T / case.dt)), 1)
        res = transient_growth_analysis(ns, base, horizon=T, nsteps=nsteps, nsv=1,
                                        k_dim=k_dim, tol=1e-4)
        G = float(res.gains[0])
        Gref = float(np.interp(T, ref[:, 0], ref[:, 1])) if ref is not None else None
        rows.append(dict(t=T, G=G, G_barkley=Gref,
                         rel=None if Gref is None else G / Gref - 1.0))
        print(f"[tg] G({T}) = {G:.6f}"
              + (f"  (Barkley {Gref:.2f}, {100*(G/Gref-1):+.1f}%)" if Gref else "")
              + f"  [{res.n_matvecs} matvecs, svds-res {float(res.residuals[0]):.1e}, "
              f"{time.time()-t0:.0f}s]", flush=True)
    os.makedirs(args.outdir, exist_ok=True)
    with open(os.path.join(args.outdir, args.out), "w") as fh:
        json.dump(dict(preset=args.preset, nelem=case.mesh.nelem,
                       order=P["order"], dtype=f"float32 ({device})",
                       sponge=bool(case.sponge), unmasked=bool(args.unmasked),
                       fused=bool(args.fused), points=rows), fh, indent=1)
    print(f"[tg] done in {time.time()-t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
