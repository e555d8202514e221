"""Tiny cells for the harness's CPU tests: a checkout root in a temporary
directory with a BENCHMARK.json of two small configurations (a 36-element
cylinder in the fused-IR configuration, a 30-element backward-facing
step in float32), their base flows, the real traffic mixes, loops and
metric readers, and limits for the tiny cells."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # bench_port/

CYL = dict(name="tiny_cyl", source="https://github.com/nekStab/nekStab/tree/master/examples/cylinder",
           case="cylinder", reference="pnpn2_2d", reynolds=60.0, order=5, nr=3, ntheta=12,
           radius=0.5, outer_radius=15.0, grading=20.0, outflow_half_angle=70.0,
           sponge_start_frac=0.5, sponge_strength=1.0, dt=0.01, steps_per_application=3,
           krylov=dict(k_dim=24, nev=2, tol=1e-6), dtype="float64", mixed_precision=True,
           solver=dict(pressure_tol=1e-8, velocity_tol=1e-9, pressure_maxiter=500,
                       velocity_maxiter=200, pressure_precond="block", fused_solves=True,
                       mixed_ir_cycles=2),
           control=dict(dtype="float32", tf32=False), reduced=[])
BFS = dict(name="tiny_bfs", source="https://doi.org/10.1017/S0022112008001109",
           case="backward_facing_step", reference="pnpn2_2d", reynolds=500.0, order=4,
           elems_upstream=3, elems_downstream=6, elems_y=4, inflow_length=10.0,
           outflow_length=20.0, step_dx=0.3, sponge=True, sponge_left=5.0, sponge_right=10.0,
           sponge_strength=2.0, dt=0.01, steps_per_application=3,
           krylov=dict(k_dim=24, nev=2, tol=1e-6), dtype="float32",
           mixed_precision=False,
           solver=dict(pressure_tol=1e-5, velocity_tol=1e-6, pressure_maxiter=350,
                       velocity_maxiter=40, pressure_precond="block", fused_solves=True),
           control=dict(dtype="float32", tf32=True), reduced=[])
CELLS = {"tiny_cyl_direct": ("tiny_cyl", "eigs_direct"),
         "tiny_cyl_adjoint": ("tiny_cyl", "eigs_adjoint"),
         "tiny_bfs_tg": ("tiny_bfs", "tg_svds")}
LIMITS = {"tiny_cyl_direct": {"prop_matvec": 1e-7, "krylov_basis": 1e-7, "start_vector": 1e-12},
          "tiny_cyl_adjoint": {"prop_rmatvec": 1e-7, "krylov_basis": 1e-7,
                               "start_vector": 1e-12},
          "tiny_bfs_tg": {"prop_matvec": 3e-4, "prop_rmatvec": 3e-4, "krylov_basis": 3e-5,
                          "start_vector": 3e-6}}


def base_flow(cfg: dict) -> np.ndarray:
    """A smooth base flow on the tiny mesh: uniform flow in x, masked."""
    from bench_port.reference import mesh2d

    m = mesh2d.build(cfg)
    u = np.stack([np.ones_like(m.x), 0.1 * np.sin(m.x) * np.cos(m.y)], axis=-1)
    return u * m.vmask[..., None]


def make_root(tmp: str) -> tuple:
    """(root, bench_dir) of the tiny benchmark under ``tmp``."""
    root = os.path.join(tmp, "root")
    bench = os.path.join(root, "bench_port")
    os.makedirs(os.path.join(bench, "configs"))
    os.makedirs(os.path.join(bench, "data"))
    os.makedirs(os.path.join(bench, "limits"))
    for d in ("traffic", "loops", "metrics"):
        shutil.copytree(os.path.join(HERE, d), os.path.join(bench, d))
    configs = []
    for cfg in (CYL, BFS):
        cfg = dict(cfg)
        f = f"bench_port/data/{cfg['name']}.npz"
        np.savez(os.path.join(root, f), u=base_flow(cfg))
        cfg["base_flow"] = {"file": f}
        with open(os.path.join(bench, "configs", f"{cfg['name']}.json"), "w") as fh:
            json.dump(cfg, fh)
        configs.append({"name": cfg["name"], "source": cfg["source"],
                        "file": f"bench_port/configs/{cfg['name']}.json", "reduced": [],
                        "why": "tiny"})
    for cell, lim in LIMITS.items():
        with open(os.path.join(bench, "limits", f"{cell}.json"), "w") as fh:
            json.dump(lim, fh)
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as fh:
        real = json.load(fh)
    bench_json = dict(real, configs=configs,
                      workloads=[{"name": c, "config": k, "traffic": t, "chips": 1, "why": "tiny"}
                                 for c, (k, t) in CELLS.items()])
    for m in bench_json["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench_json, fh)
    return root, bench
