"""The bordered UPO Newton of ``examples_torch/cylinder_upo.py`` from a
saved seed, at a tolerance of the caller's choice: the example's Newton
stage (``newton_upo``) alone, to read the residual history below the
example's f32 stopping tolerance (1.5e-3, where the TPU's Newton dithered
at ~1.2e-3).

Usage: python3 tools_torch/upo_newton.py [--seed upo_out/UPO_seed.npz]
           [--tol 3e-4] [--max-iter 3] [--out upo_newton.json]

The seed's ``period_estimate`` is the initial period; the case and the
solver are the example's (f32 on K1/K2 on the card, ``NEKSTAB_CPU=1``: f64
``'schwarz'`` on the CPU).  Prints one line an iteration and writes the
history to ``--out``.  Imports nothing of JAX.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch.cylinder_upo import make_case, newton_upo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", default="upo_out/UPO_seed.npz")
    ap.add_argument("--tol", type=float, default=3e-4)
    ap.add_argument("--max-iter", type=int, default=3)
    ap.add_argument("--out", default="upo_newton.json")
    args = ap.parse_args()
    device = "cpu" if os.environ.get("NEKSTAB_CPU") else None
    case = make_case(100.0, device is None, device=device)
    t0 = time.time()
    print(f"[upo-newton] device={case.sem.device} dtype={case.sem.dtype}", flush=True)
    r, _ = newton_upo(case.make_ns(), args.seed, args.tol, max_iter=args.max_iter, t0=t0,
                      tag="upo-newton")
    out = dict(seed=args.seed, tol=args.tol, period=r.period, residual=r.residual,
               converged=r.converged, n_matvecs=r.n_matvecs, seconds=time.time() - t0,
               history=[list(h) for h in r.history])
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"[upo-newton] T={r.period:.6f} res={r.residual:.4e} converged={r.converged} "
          f"({r.n_matvecs} matvecs, {time.time()-t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
