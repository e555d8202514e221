"""Compare a run of ``examples_torch/cube_transient_growth.py`` with the JAX
package's recorded run in ``cube_out/``.

    python3 tools_torch/cube_compare.py OUTDIR [--ref cube_out]

Prints the march's steps and |du/dt| against ``report.json``'s, the base
flow's distance from ``BF_cube_00001.npz`` (max-norm and 2-norm, relative
to the reference), and each horizon's G, matvec count and svds residual
against ``growth.json``'s, with the relative difference of G.  Reads the
two directories' files only (numpy and json).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--ref", default=os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "cube_out"))
    args = ap.parse_args()
    report, ref_report = (load_json(os.path.join(d, "report.json"))
                          for d in (args.outdir, args.ref))
    bf, ref_bf = (report.get("baseflow", {}), ref_report["baseflow"])
    print(f"march: {bf.get('steps')} steps, |du/dt| {bf.get('residual')!r}, "
          f"{bf.get('wall_s', float('nan')):.1f} s; reference {ref_bf['steps']} steps, "
          f"|du/dt| {ref_bf['residual']!r}")
    u = np.load(os.path.join(args.outdir, "BF_cube_00001.npz"))["u"]
    ref_u = np.load(os.path.join(args.ref, "BF_cube_00001.npz"))["u"]
    d = u - ref_u
    print(f"base flow: max |u - u_ref| / max |u_ref| {np.abs(d).max() / np.abs(ref_u).max():.3e}, "
          f"||u - u_ref|| / ||u_ref|| {np.linalg.norm(d) / np.linalg.norm(ref_u):.3e}")
    path = os.path.join(args.outdir, "growth.json")
    if not os.path.exists(path):
        print("growth: not run")
        return
    ref_points = {p["t"]: p for p in load_json(os.path.join(args.ref, "growth.json"))["points"]}
    for p in load_json(path)["points"]:
        r = ref_points.get(p["t"])
        line = (f"G({p['t']:g}) = {p['G']!r}: {p['nsteps']} steps, {p['n_matvecs']} matvecs, "
                f"svds residual {p['svds_residual']:.3e}, adjoint identity "
                f"{p.get('adjoint_rel', float('nan')):.3e}")
        if r is not None:
            line += (f"; reference {r['G']!r} ({r['n_matvecs']} matvecs, residual "
                     f"{r['svds_residual']:.3e}), rel {abs(p['G'] / r['G'] - 1.0):.3e}")
        print(line)


if __name__ == "__main__":
    main()
