"""Profile the PyTorch port's hot calls on one NVIDIA GPU.

    python3 profile_torch.py [PATH ...]

Profiles chip_smoke.py's paths: the flagship 50-step f32 matvec through K1
and K2, the same operator's rmatvec (the adjoint: the backward pass of the
tangent steps, K1 and K2 on the cotangents), one Arnoldi step of the
stability analysis on it (a matvec, then the batched orthogonalization
against k = 24 columns), the 50-step fused-IR matvec on the same mesh (f64
state, K1 and K2 as the inner solves of refinement, the example's
``--precision mixed`` settings), then the 10-step mixed-precision cube
matvec through K4.  PATH picks some of them by name (``PATHS``).  After one warm-up call, one call runs under ``torch.profiler``
(CPU and CUDA activities).  Prints the wall time, the device-busy time (the union of the
kernels' intervals) and the idle share, the number of device kernels, the
device time by kernel name (and the port's own kernels, ``nsk`` in their
names, each with its launches), and the host ops with the most CPU time, each
line tagged with the card's name and power limit.  Needs a CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import collections
import time

import numpy as np


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


ARNOLDI_K = 24  # the stability API's k_dim in chip_smoke.py
PATHS = ("cylinder", "cylinder rmatvec", "cylinder arnoldi step", "cylinder fused-IR", "cube")


def build(path: str):
    """(the call to profile, velocity dof x steps of one call) of one path,
    as chip_smoke.py builds it."""
    import torch

    import chip_smoke as cs
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

    rng = np.random.default_rng(0)
    dev = torch.device("cuda", 0)
    if path == "cylinder fused-IR":
        from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
        from nekstab_next_tpu_torch.config import SolverConfig

        case = CylinderCase(**cs.FLAGSHIP, device=dev, mixed_precision=True,
                            solver=SolverConfig(**cs.MIXED))
        base = case.uniform_flow()
        op = LinearizedOperator(case.make_ns(), base, nsteps=cs.NSTEPS)
        q = case.sem.vmask * base
        return lambda: op.matvec(q), case.mesh.npoints * 2 * cs.NSTEPS
    if path.startswith("cylinder"):
        case = cs.make_case(torch.float32, cs.CAPS_F32, fused=True)
        base = case.uniform_flow()
        op = LinearizedOperator(case.make_ns(), base, nsteps=cs.NSTEPS)
        q = case.sem.vmask * base
        work = case.mesh.npoints * 2 * cs.NSTEPS
        if path == "cylinder":
            return lambda: op.matvec(q), work
        if path == "cylinder rmatvec":
            return lambda: op.rmatvec(q), work
        from nekstab_next_tpu_torch.algorithms import velocity_space
        from nekstab_next_tpu_torch.krylov import Basis, arnoldi_step

        basis = Basis(velocity_space(case.sem), q, capacity=ARNOLDI_K + 1)
        basis.Q[:ARNOLDI_K] = torch.as_tensor(rng.standard_normal(
            (ARNOLDI_K,) + tuple(q.shape)), dtype=q.dtype, device=dev)
        H = np.zeros((ARNOLDI_K + 1, ARNOLDI_K))
        return (lambda: arnoldi_step(op.matvec, basis.space, basis, H, ARNOLDI_K - 1),
                work)
    from nekstab_next_tpu_torch.cases.cube import CubeRoughnessCase
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.stepper.navier_stokes import NavierStokes

    cube = CubeRoughnessCase(**cs.CUBE, solver=SolverConfig(**cs.CUBE_TOL), device=dev)
    ns = NavierStokes(cube.sem, viscosity=cube.h / cube.reynolds, dt=cube.dt,
                      u_bc=cube.u_bc, solver=cube.solver, mixed_precision=True)
    base = cube.initial_flow()
    op = LinearizedOperator(ns, base, nsteps=cs.CUBE_NSTEPS)
    q = cube.sem.vmask * torch.as_tensor(rng.standard_normal(tuple(base.shape)),
                                         dtype=torch.float64, device=dev)
    return (lambda: op.matvec(q)), cube.mesh.npoints * 3 * cs.CUBE_NSTEPS


def profile(path: str, tag: str) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    call, dof_steps = build(path)
    call()  # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e6
    print(f"[{tag}] {path}: wall {wall * 1e3:.1f} ms under the profiler "
          f"({dof_steps / wall:.4e} dof-steps/s), device busy {busy * 1e3:.1f} ms, "
          f"idle {100 * (1 - busy / wall):.1f} %, {len(kernels)} device kernels", flush=True)
    if not kernels:
        print(f"[{tag}] {path}: the profiler recorded no device kernels", flush=True)
        return
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        d = by_name[e.name]
        d[0] += e.time_range.end - e.time_range.start
        d[1] += 1
    print(f"[{tag}] {path}: device time by kernel (top 12)")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {us / 1e3:9.2f} ms  {100 * us / 1e6 / busy:5.1f} %  x{count:<6d} {name[:90]}")
    cpu = [a for a in prof.key_averages() if a.self_cpu_time_total > 0]
    total_cpu = sum(a.self_cpu_time_total for a in cpu)
    print(f"[{tag}] {path}: device time of the port's own kernels")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        if "nsk" in name:
            print(f"    {us / 1e3:9.2f} ms  {100 * us / 1e6 / busy:5.1f} %  x{count:<6d} "
                  f"{us / count:8.2f} us each  {name[:90]}")
    print(f"[{tag}] {path}: host self time by op (top 8 of {total_cpu / 1e3:.1f} ms)")
    for a in sorted(cpu, key=lambda a: -a.self_cpu_time_total)[:8]:
        print(f"    {a.self_cpu_time_total / 1e3:9.2f} ms  x{a.count:<6d} {a.key[:80]}")


def main() -> None:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs a CUDA device")
    tag = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    import sys

    paths = sys.argv[1:] or PATHS
    unknown = [p for p in paths if p not in PATHS]
    if unknown:
        raise SystemExit(f"profile_torch: unknown paths {unknown}; choose from {PATHS}")
    for path in paths:
        profile(path, tag)


if __name__ == "__main__":
    main()
