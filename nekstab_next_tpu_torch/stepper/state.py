"""Flow state (port of ``nekstab_next_tpu/stepper/state.py``), 2-D or 3-D,
with optional temperature / passive scalars.

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
            velocity GLL grid (nelem, n, .., n) for the 'laplacian' and
            'consistent' schemes
    ulag  : (2, *u.shape)      u at steps n-1, n-2 (BDF history)
    nlag  : (2, *u.shape)      weak explicit terms at steps n-1, n-2 (EXT)
    time  : physical time
    step  : step counter (drives the BDF startup ramp)
    T     : (nelem, n, .., n, nscal)  temperature + passive scalars (optional)
    tlag  : (2, *T.shape)      scalar BDF history (optional)
    ntlag : (2, *T.shape)      scalar explicit-term history (optional)
    dp    : previous pressure increment — warm-starts the pressure solve
    """

    u: torch.Tensor
    p: torch.Tensor
    ulag: torch.Tensor
    nlag: torch.Tensor
    time: float = 0.0
    step: int = 0
    T: Optional[torch.Tensor] = None
    tlag: Optional[torch.Tensor] = None
    ntlag: Optional[torch.Tensor] = None
    dp: Optional[torch.Tensor] = None


def initial_state(
    u: torch.Tensor,
    p: Optional[torch.Tensor] = None,
    time: float = 0.0,
    dtype: Optional[torch.dtype] = None,
    T: Optional[torch.Tensor] = None,
    warm_start: bool = True,
) -> FlowState:
    """Fresh state from a velocity field (and optionally the scalar block
    ``T``, temperature first); lag arrays zeroed, step=0 so the BDF1/2/3
    startup ramp applies.  ``warm_start`` allocates the ``dp``
    pressure-increment carry."""
    if dtype is not None:
        u = u.to(dtype)
    if p is None:
        p = torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
    p = p.to(u.dtype)
    lag = lambda x: torch.zeros((2,) + tuple(x.shape), dtype=u.dtype, device=u.device)
    tfields = {}
    if T is not None:
        T = T.to(device=u.device, dtype=u.dtype)
        tfields = dict(T=T, tlag=lag(T), ntlag=lag(T))
    return FlowState(
        u=u,
        p=p,
        ulag=lag(u),
        nlag=lag(u),
        time=float(time),
        step=0,
        dp=torch.zeros_like(p) if warm_start else None,
        **tfields,
    )
