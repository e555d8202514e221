"""The backward-facing step of a configuration with ``"case":
"backward_facing_step"``, built through the program's own entry
(``BackwardFacingStepCase``), with the sponge damping toward the base flow
and the tangent linearised about it."""

from __future__ import annotations

import types

import numpy as np
import torch


def build(cfg: dict, device, base_u: np.ndarray) -> types.SimpleNamespace:
    from nekstab_next_tpu_torch.cases.bfs import BackwardFacingStepCase
    from nekstab_next_tpu_torch.config import SolverConfig
    from nekstab_next_tpu_torch.stepper.linearized import LinearizedOperator

    dtype = getattr(torch, cfg["dtype"])
    case = BackwardFacingStepCase(
        reynolds=cfg["reynolds"], order=cfg["order"], elems_upstream=cfg["elems_upstream"],
        elems_downstream=cfg["elems_downstream"], elems_y=cfg["elems_y"],
        inflow_length=cfg["inflow_length"], outflow_length=cfg["outflow_length"],
        step_dx=cfg["step_dx"], sponge=cfg["sponge"], sponge_left=cfg["sponge_left"],
        sponge_right=cfg["sponge_right"], sponge_strength=cfg["sponge_strength"],
        dt=cfg["dt"], solver=SolverConfig(**cfg["solver"]), dtype=dtype, device=device,
    )
    base = torch.as_tensor(base_u, device=case.sem.device).to(dtype)
    ns = case.make_ns(sponge_ref=base if cfg["sponge"] else None)
    op = LinearizedOperator(ns, base, nsteps=cfg["steps_per_application"])
    return types.SimpleNamespace(ns=ns, sem=case.sem, base=base, op=op,
                                 kernels={"k1": ns.fused_v, "k2": ns.fused_p})
