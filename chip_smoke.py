"""Drive the PyTorch port's main path once on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Builds the CUDA kernels from ``nekstab_next_tpu_torch/csrc`` (nvcc, sm_90a),
checks each kernel against its plain PyTorch version at the flagship shapes,
runs the flagship 50-step f32 tangent matvec (the quantity ``bench.py``
times: 768-element Re=60 cylinder, order 6, caps 16/10) through the kernels,
checks it against the plain versions and an f64 reference, runs 20
nonlinear steps, and times everything with CUDA events.  Every phase is
fatal on failure.  Imports nothing of JAX.

Output: one line per result, then a ``{"kernels": [...]}`` JSON line, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Exits nonzero, printing no result, without a CUDA device or without the
port's package beside this script.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

NSTEPS = 50
REPS = 3
# flagship: bench.py's f32 rung (bench.py:58-62,131-140)
FLAGSHIP = dict(reynolds=60.0, nr=16, ntheta=48, order=6, outer_radius=40.0)
CAPS_F32 = dict(pressure_tol=1e-5, velocity_tol=1e-6, pressure_maxiter=16,
                velocity_maxiter=10, pressure_precond="block")
CAPS_TIGHT = dict(pressure_tol=1e-10, velocity_tol=1e-10, pressure_maxiter=2000,
                  velocity_maxiter=500, pressure_precond="block")
TPU_KERNEL = {  # the pallas_call each kernel replaces
    "fused_helmholtz_cg": "nekstab_next_tpu/ops/fused_cg.py:394",
    "fused_pressure_cg": "nekstab_next_tpu/ops/fused_cg.py:665",
}
SOURCE = {
    "fused_helmholtz_cg": "nekstab_next_tpu_torch/csrc/fused_helmholtz_cg.cu",
    "fused_pressure_cg": "nekstab_next_tpu_torch/csrc/fused_pressure_cg.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps calls, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def plain_solves(ns):
    """Route the stepper's two solves through the kernels' plain versions."""
    fv, fp = ns.fused_v, ns.fused_p
    fv.solve, fp.solve = fv.plain, fp.plain
    try:
        yield
    finally:
        del fv.solve, fp.solve


def make_case(dtype, caps, fused: bool):
    import torch
    from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
    from nekstab_next_tpu_torch.config import SolverConfig

    return CylinderCase(**FLAGSHIP, dtype=dtype, device=torch.device("cuda", 0),
                        solver=SolverConfig(**caps, fused_solves=fused))


def main() -> None:
    t_start = time.perf_counter()
    # ---- 1. device -----------------------------------------------------
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    import nekstab_next_tpu_torch  # noqa: F401  (the port, beside this script)
    from nekstab_next_tpu_torch.ops import _cuda
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi name, power.limit: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    lib = _cuda.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {lib.build_seconds:.1f} s) -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. kernels against their plain versions, flagship shapes -----
    case = make_case(torch.float32, CAPS_F32, fused=True)
    sem = case.sem
    ns = case.make_ns()
    fv, fp = ns.fused_v, ns.fused_p
    log(f"flagship: {sem.nelem} elements, n={sem.n}, {case.mesh.npoints * 2} velocity dof, "
        f"{sem.pc_nc} coarse vertices, dt={case.dt:.6g}")
    from nekstab_next_tpu_torch.ops.fused_cg import FusedHelmholtzCG, FusedPressureCG
    from nekstab_next_tpu_torch.ops.elliptic import make_projector

    rng = np.random.default_rng(0)
    dev = sem.device
    h1, h2 = 1.0 / 60.0, (11.0 / 6.0) / case.dt
    rhs_v = make_projector(sem, sem.vmask)(
        torch.as_tensor(rng.standard_normal(tuple(sem.bm.shape) + (2,)),
                        dtype=torch.float32, device=dev))
    rhs_p = torch.as_tensor(rng.standard_normal(sem.p_shape), dtype=torch.float32, device=dev)
    k1 = FusedHelmholtzCG(sem, sem.vmask, maxiter=10, tol=1e-6)
    x_k, x_p = k1.solve(rhs_v, h1, h2), k1.plain(rhs_v, h1, h2)
    torch.cuda.synchronize()
    r1 = rel(x_k, x_p)
    err = {"fused_helmholtz_cg": float((x_k - x_p).abs().max())}
    log(f"K1 fused_helmholtz_cg vs plain (C=2, maxiter 10, tol 1e-6): rel {r1:.3e} (bound 1e-5)")
    if not (r1 < 1e-5):
        fail(f"K1 disagrees with its plain version: rel {r1:.3e}")
    errs_p = []
    for maxiter, bound in ((300, 1e-4), (16, 1e-3)):
        k2 = FusedPressureCG(sem, maxiter=maxiter, tol=1e-6,
                             project_mean=not sem.has_pressure_dirichlet)
        y_k, y_p = k2.solve(rhs_p), k2.plain(rhs_p)
        torch.cuda.synchronize()
        r2 = rel(y_k, y_p)
        errs_p.append(float((y_k - y_p).abs().max()))
        log(f"K2 fused_pressure_cg vs plain (maxiter {maxiter}, tol 1e-6): rel {r2:.3e} (bound {bound:g})")
        if not (r2 < bound):
            fail(f"K2 disagrees with its plain version at maxiter {maxiter}: rel {r2:.3e}")
    err["fused_pressure_cg"] = max(errs_p)

    # ---- 4. flagship tangent matvec through the kernels ----------------
    base = case.uniform_flow()
    q = sem.vmask * base  # bench.py's input
    op = LinearizedOperator(ns, base, nsteps=NSTEPS)
    fv.launches = fp.launches = 0
    t0 = time.perf_counter()
    out_k = op.matvec(q)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = {"fused_helmholtz_cg": fv.launches, "fused_pressure_cg": fp.launches}
    log(f"matvec f32 kernels: first call {t_first:.2f} s, launches {launches}")
    if tuple(out_k.shape) != tuple(q.shape) or out_k.dtype != torch.float32:
        fail(f"flagship matvec output has shape {tuple(out_k.shape)}, {out_k.dtype}")
    if not bool(torch.isfinite(out_k).all()):
        fail("flagship matvec output is not finite")
    if launches != {"fused_helmholtz_cg": NSTEPS, "fused_pressure_cg": NSTEPS}:
        fail(f"expected {NSTEPS} launches of each kernel per matvec, got {launches}")
    with plain_solves(ns):
        out_p = op.matvec(q)
    r_plain = rel(out_k, out_p)
    log(f"matvec f32 kernels vs f32 plain versions: rel {r_plain:.3e} (bound 1e-3)")
    if not (r_plain < 1e-3):
        fail(f"kernel matvec disagrees with the plain-version matvec: {r_plain:.3e}")
    case64 = make_case(torch.float64, CAPS_TIGHT, fused=False)
    ns64 = case64.make_ns()
    op64 = LinearizedOperator(ns64, case64.uniform_flow(), nsteps=NSTEPS)
    q64 = case64.sem.vmask * case64.uniform_flow()
    out_64 = op64.matvec(q64)
    drift = rel(out_k, out_64)
    log(f"f32 drift: matvec f32 kernels vs f64 plain at tight tolerances (1e-10): rel {drift:.3e} (bound 1e-3)")
    if not (drift < 1e-3):
        fail(f"f32 drift {drift:.3e} against the f64 reference")

    # ---- 5. nonlinear steps --------------------------------------------
    st = ns.advance(ns.make_state(case.uniform_flow()), 20)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(st.u).all()) and bool(torch.isfinite(st.p).all())):
        fail("20 nonlinear steps gave non-finite fields")
    log(f"nonlinear: 20 steps of ns.advance from uniform_flow(): finite, |u|max {float(st.u.abs().max()):.4f}")

    # ---- 6. timing (CUDA events; warm-up + REPS chained matvecs) --------
    ndof = case.mesh.npoints * 2
    tag = f"[{card}]"
    rates = {}

    def chained(o, x0):
        state = {"x": x0}

        def fn():
            state["x"] = o.matvec(state["x"])
        return fn

    rates["f32 kernels"] = cuda_ms(chained(op, q), REPS)
    with plain_solves(ns):
        rates["f32 plain versions"] = cuda_ms(chained(op, q), REPS)
    case64c = make_case(torch.float64, CAPS_F32, fused=False)
    op64c = LinearizedOperator(case64c.make_ns(), case64c.uniform_flow(), nsteps=NSTEPS)
    rates["f64 plain, f32 caps 16/10"] = cuda_ms(
        chained(op64c, case64c.sem.vmask * case64c.uniform_flow()), REPS)
    rates["f64 plain, tight 1e-10"] = cuda_ms(chained(op64, q64), REPS)
    for name, ms in rates.items():
        log(f"timing {tag} matvec {name}: {ms:.2f} ms/matvec, "
            f"{ndof * NSTEPS / (ms / 1e3):.4e} dof-steps/s")

    solve_ms = {
        "fused_helmholtz_cg": (cuda_ms(lambda: k1.solve(rhs_v, h1, h2), 20),
                               cuda_ms(lambda: k1.plain(rhs_v, h1, h2), 20)),
        "fused_pressure_cg": (cuda_ms(lambda: fp.solve(rhs_p), 20),
                              cuda_ms(lambda: fp.plain(rhs_p), 20)),
    }
    for name, (ms_k, ms_p) in solve_ms.items():
        log(f"timing {tag} one {name} solve (flagship caps): kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": TPU_KERNEL[name],
         "launches": launches[name], "max_abs_err": err[name],
         "ms": solve_ms[name][0], "plain_ms": solve_ms[name][1]}
        for name in ("fused_helmholtz_cg", "fused_pressure_cg")
    ]
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
