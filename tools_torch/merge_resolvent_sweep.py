"""Merge per-omega resolvent sweep partials into gains.json and
Spectre_Sd.dat (a host numpy copy of ``tools/merge_resolvent_sweep.py``).

A sweep run one omega per process
(``examples_torch/cylinder_resolvent_sweep.py --omegas W --out gains_W.json``)
leaves one partial per omega; this merges them, applies the interior-peak
gate and writes the reference-convention Spectre_Sd.dat table.

Usage: python tools_torch/merge_resolvent_sweep.py [OUTDIR]
"""

import glob
import json
import os
import sys

import numpy as np


def main(outdir: str) -> dict:
    rows = []
    meta = None
    for p in sorted(glob.glob(os.path.join(outdir, "gains_*.json"))):
        with open(p) as fh:
            d = json.load(fh)
        rows.extend(d["points"])
        meta = d
    assert rows, "no partials found"
    rows.sort(key=lambda r: r["omega"])
    sigs = [r["sigma"] for r in rows]
    imax = int(np.argmax(sigs))
    assert 0 < imax < len(sigs) - 1, f"peak at sweep boundary: {rows[imax]}"
    meta["points"] = rows
    meta.pop("partial", None)
    meta["peak"] = dict(omega=rows[imax]["omega"], sigma=rows[imax]["sigma"],
                        strouhal=rows[imax]["omega"] / (2 * np.pi))
    with open(os.path.join(outdir, "gains.json"), "w") as fh:
        json.dump(meta, fh, indent=1)
    np.savetxt(os.path.join(outdir, "Spectre_Sd.dat"),
               np.array([[r["omega"], r["sigma"]] for r in rows]),
               header="omega sigma1")
    print("merged", len(rows), "omegas; peak:", meta["peak"])
    return meta


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "resolvent_out")
