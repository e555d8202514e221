"""The cylinder wake of a configuration with ``"case": "cylinder"``, built
through the program's own entry (``CylinderCase``) and linearised about
the configuration's base flow."""

from __future__ import annotations

import types

import numpy as np
import torch


def build(cfg: dict, device, base_u: np.ndarray) -> types.SimpleNamespace:
    from nekstab_next_tpu_torch.cases.cylinder import CylinderCase
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

    dtype = getattr(torch, cfg["dtype"])
    case = CylinderCase(
        reynolds=cfg["reynolds"], nr=cfg["nr"], ntheta=cfg["ntheta"], order=cfg["order"],
        outer_radius=cfg["outer_radius"], grading=cfg["grading"],
        outflow_half_angle=cfg["outflow_half_angle"],
        sponge_start_frac=cfg["sponge_start_frac"], sponge_strength=cfg["sponge_strength"],
        dt=cfg["dt"], solver=SolverConfig(**cfg["solver"]), dtype=dtype, device=device,
        mixed_precision=cfg["mixed_precision"],
    )
    ns = case.make_ns()
    if cfg["mixed_precision"] and not ns._mixed_ir:
        raise RuntimeError("the fused-IR path did not engage")
    base = torch.as_tensor(base_u, device=case.sem.device).to(dtype)
    op = LinearizedOperator(ns, base, nsteps=cfg["steps_per_application"])
    return types.SimpleNamespace(ns=ns, sem=case.sem, base=base, op=op,
                                 kernels={"k1": ns.fused_v, "k2": ns.fused_p})
