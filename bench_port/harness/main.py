"""One run of one cell: set-up, the measured window, the correctness check
and the result's line.

``python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the checkout's root.  With ``--trace 0`` the result
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics.  The last line of standard output is the result's JSON object;
the compared numbers, each beside its limit, are the last lines of
standard error and the result's last key (``checks``).
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from typing import Optional

import numpy as np

from . import guard
from .spec import Cell, load_cell


class Run:
    """What a run measured, for the per-layer readers (``metrics/``)."""

    def __init__(self, cell: Cell, dof: int, nsteps: int):
        self.cell = cell
        self.dof = dof  # velocity degrees of freedom
        self.nsteps = nsteps  # time steps of one application
        self.apps = []
        self.gaps = []
        self.window_s = 0.0
        self.launches = {}  # K1/K2 launches in the window, by id
        self.trace = None  # trace.Trace of a --trace 1 run
        self.traced = 0  # the first applications, run under the profiler

    def spans(self):
        """The applications and Krylov-layer gaps outside the profiler."""
        return (self.apps[self.traced:],
                [g for i, g in self.gaps if i > self.traced])

    @property
    def steps(self) -> int:
        return len(self.apps) * self.nsteps


def start_vectors(mesh, traffic: dict, seed: int, device, dtype):
    """Analysis i's start vector: Gaussian noise on the global nodes (so
    continuous), masked to the admissible fields (and outside the sponge
    where the traffic asks), from a generator on the device seeded by
    ``seed``.  The same seed gives the same vectors."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    gid = torch.as_tensor(mesh.gid.reshape(-1), device=device)
    mask = mesh.vmask * (mesh.bms > 0) if traffic["start_outside_sponge"] else mesh.vmask
    mask = torch.as_tensor(mask, dtype=torch.float64, device=device)[..., None]
    shape = tuple(mesh.bm.shape) + (2,)

    def draw(i: int):
        g = torch.randn((mesh.nglobal, 2), generator=gen, dtype=torch.float64, device=device)
        return (g[gid].reshape(shape) * mask).to(dtype)

    vectors = []

    def start(i: int):
        while len(vectors) <= i:
            vectors.append(draw(len(vectors)))
        return vectors[i]

    return start


def build(cell: Cell, dev):
    """The reference's mesh (for the inputs), the base flow as the program
    holds it (rounded to the configuration's precision), and the
    program's case."""
    from bench_port.reference import mesh2d

    cfg = cell.config
    base = np.load(cell.path(cfg["base_flow"]["file"]))["u"]
    base = base.astype(np.dtype(cfg["dtype"])).astype(np.float64)
    return mesh2d.build(cfg), base, cell.case_module().build(cfg, dev, base)


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
         "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=30)
        d["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return d


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: Optional[float] = None,
             control: bool = False, cell: Optional[Cell] = None,
             bench_dir: Optional[str] = None) -> dict:
    """One run; returns the result's object (without printing it)."""
    t_process = time.perf_counter() if t_process is None else t_process
    import torch

    if cell is None:
        cell = load_cell(root, workload) if bench_dir is None else load_cell(root, workload,
                                                                            bench_dir)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    cfg, traffic = cell.config, cell.traffic
    dtype = getattr(torch, cfg["dtype"])

    mesh, base, case = build(cell, dev)
    if control:
        op, space = control_operator(cell, base, dev, mesh)
    else:
        from nekstab_next_tpu_torch.algorithms.stability import velocity_space

        op, space = case.op, velocity_space(case.sem)
    start = start_vectors(mesh, traffic, seed, dev, dtype)
    # warm-up: one application of each direction the traffic uses
    for d in cell.loop.directions(traffic):
        (op.matvec if d == "matvec" else op.rmatvec)(start(0))
    sync()
    setup_s = time.perf_counter() - t_process

    from .window import Recorder, drive

    run = Run(cell, dof=int(np.prod(mesh.bm.shape)) * 2, nsteps=cfg["steps_per_application"])
    tracer = None
    if trace:
        from .trace import Tracer

        tracer = Tracer(case.kernels, traffic["traced_applications"], cuda)
    rec = Recorder(sync, seconds, on_done=tracer.on_done if tracer else None)
    launches0 = {k: v.launches for k, v in case.kernels.items() if v is not None}
    gc.collect()  # set-up's garbage goes before the window, not inside it
    if tracer:
        tracer.start()
    drive(cell.loop, traffic, cfg["krylov"], op, space, start, rec, control=control)
    run.window_s = rec.window_s
    run.apps, run.gaps = rec.apps, rec.gaps
    run.launches = {k: case.kernels[k].launches - n for k, n in launches0.items()}
    if tracer:
        run.trace = tracer.reduce()
        run.traced = tracer.napps
        for k, its in sorted(run.trace.launches.items()):
            if its:  # each traced launch's iterations, as the rooflines count them
                print(f"kernels: {k} launches {len(its)} iterations min {min(its)} "
                      f"median {sorted(its)[len(its) // 2]} max {max(its)}", file=sys.stderr)
    dinfo = device_info(dev, cell.chips)

    # the program's state goes before the reference runs
    x0 = start(0)
    del case, op, space, start, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = cell.reference_module().Tangent(cfg, base, dev, mesh=mesh)
    from .check import compare

    checks, failed = compare(cell.loop.judge(ref, rec.apps, rec.pending, traffic,
                                             cfg["krylov"], run.nsteps, x0, seed), cell.limits)
    del ref
    correct = bool(run.apps) and failed == 0 and all(
        k in checks for k in cell.limits)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"dof_steps_per_s": run.dof * run.steps / run.window_s if run.window_s else 0.0,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(run.apps), "failed": failed,
              "metrics": metrics, "device": dinfo}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    # each application's wall, process CPU and machine-wide stolen time (ms):
    # where the wall time drifts, whether this process worked longer or waited
    print("window: applications wall/cpu/steal ms " + " ".join(
        f"{1e3 * (a.t1 - a.t0):.1f}/{1e3 * a.cpu:.1f}/{1e3 * a.steal:.0f}" for a in run.apps),
        file=sys.stderr)
    return result


def control_operator(cell: Cell, base, dev, mesh):
    """The reference in the configuration's control precision, in the
    program's place (never in a benchmark run): its propagator and the
    energy product its Krylov loops use (``reference/krylov.py``)."""
    import types

    import torch

    from bench_port.reference import krylov

    c = cell.config["control"]
    nsteps = cell.config["steps_per_application"]
    dtype = getattr(torch, c["dtype"])
    ref = cell.reference_module().Tangent(cell.config, base, dev, dtype=dtype, tf32=c["tf32"],
                                          mesh=mesh)
    op = types.SimpleNamespace(matvec=lambda x: ref.apply("matvec", x, nsteps),
                               rmatvec=lambda x: ref.apply("rmatvec", x, nsteps))
    return op, krylov.Space(ref.bms, dtype, ref.rnd)


def cli(argv, t_process: float, root: str) -> int:
    ap = argparse.ArgumentParser(prog="bench_port/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    cell = load_cell(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench_port: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", t_process=t_process, cell=cell)
    finally:
        found = guard.forbidden_modules()
    if found:
        print(f"bench_port: {guard.ForbiddenImport(found)}", file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
