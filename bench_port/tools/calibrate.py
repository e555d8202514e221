"""Readings for the limits of the correctness check (never run by the
benchmark itself).

For each cell of one configuration, in one process: the program on many
seeds (the lower readings) and the control on a few (the upper
readings), each over a short window that completes several applications,
judged by the float64 reference as a benchmark run judges them.  The
control is the reference in the configuration's control precision put in
the program's place.  One JSON line per reading:

    python3 bench_port/tools/calibrate.py --workloads cyl_eigs_direct \\
        --seeds 12 --control-seeds 3 --seconds 8 --out chiprun_out/calibrate.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    import torch

    from bench_port.harness.check import compare
    from bench_port.harness.main import build, control_operator, start_vectors
    from bench_port.harness.spec import load_cell
    from bench_port.harness.window import Recorder, drive

    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    cells = [load_cell(ROOT, w) for w in args.workloads]
    cfg = cells[0].config
    if any(c.config["name"] != cfg["name"] for c in cells):
        raise SystemExit("calibrate: the workloads must share one configuration")
    dtype = getattr(torch, cfg["dtype"])
    mesh, base, case = build(cells[0], dev)
    from nekstab_next_tpu_torch.algorithms.stability import velocity_space

    space = velocity_space(case.sem)
    ref = cells[0].reference_module().Tangent(cfg, base, dev, mesh=mesh)
    ctrl, ctrl_space = control_operator(cells[0], base, dev, mesh)
    out = open(args.out, "a") if args.out else None
    for cell in cells:
        for side, op, sp, nseeds in (("program", case.op, space, args.seeds),
                                     ("control", ctrl, ctrl_space, args.control_seeds)):
            for k in range(nseeds):
                seed = args.first_seed + 7919 * k
                start = start_vectors(mesh, cell.traffic, seed, dev, dtype)
                if k == 0:  # warm-up, as a run's
                    for d in cell.loop.directions(cell.traffic):
                        (op.matvec if d == "matvec" else op.rmatvec)(start(0))
                rec = Recorder(sync, args.seconds)
                t = time.perf_counter()
                drive(cell.loop, cell.traffic, cfg["krylov"], op, sp, start, rec,
                      control=side == "control")
                checks, failed = compare(cell.loop.judge(
                    ref, rec.apps, rec.pending, cell.traffic, cfg["krylov"],
                    cfg["steps_per_application"], start(0), seed), cell.limits)
                line = {"cell": cell.name, "side": side, "seed": seed,
                        "applications": len(rec.apps), "failed": failed,
                        "seconds": time.perf_counter() - t,
                        "numbers": {k2: v[0] for k2, v in checks.items()}}
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
