"""Flow state (port of ``nekstab_next_tpu/stepper/state.py``, velocity only,
2-D or 3-D).

All tensors carry the element axis first.  ``time`` and ``step`` are host
scalars: the BDF ramp is chosen on the host, with no device sync."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class FlowState:
    """One time level of the flow plus BDF3/EXT3 history.

    u     : (nelem, n, .., n, ndim)  velocity, 2 or 3 components
    p     : pressure: (nelem, npr, npr) on the PnPn-2 Gauss space, or the
            velocity GLL grid (nelem, n, .., n) for the 'laplacian' scheme
    ulag  : (2, *u.shape)      u at steps n-1, n-2 (BDF history)
    nlag  : (2, *u.shape)      weak explicit terms at steps n-1, n-2 (EXT)
    time  : physical time
    step  : step counter (drives the BDF startup ramp)
    dp    : previous pressure increment — warm-starts the pressure solve
    """

    u: torch.Tensor
    p: torch.Tensor
    ulag: torch.Tensor
    nlag: torch.Tensor
    time: float = 0.0
    step: int = 0
    dp: Optional[torch.Tensor] = None


def initial_state(
    u: torch.Tensor,
    p: Optional[torch.Tensor] = None,
    time: float = 0.0,
    dtype: Optional[torch.dtype] = None,
    warm_start: bool = True,
) -> FlowState:
    """Fresh state from a velocity field; lag arrays zeroed, step=0 so the
    BDF1/2/3 startup ramp applies.  ``warm_start`` allocates the ``dp``
    pressure-increment carry."""
    if dtype is not None:
        u = u.to(dtype)
    if p is None:
        p = torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
    p = p.to(u.dtype)
    return FlowState(
        u=u,
        p=p,
        ulag=torch.zeros((2,) + tuple(u.shape), dtype=u.dtype, device=u.device),
        nlag=torch.zeros((2,) + tuple(u.shape), dtype=u.dtype, device=u.device),
        time=float(time),
        step=0,
        dp=torch.zeros_like(p) if warm_start else None,
    )
