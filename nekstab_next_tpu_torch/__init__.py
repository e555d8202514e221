"""nekstab_next_tpu_torch — the PyTorch/CUDA port of ``nekstab_next_tpu``.

The JAX package beside this one is the reference; this package mirrors its
layout and names (``ops/core.py`` -> ``nekstab_next_tpu_torch/ops/core.py``
...), imports ``torch``, numpy and scipy, and never jax.  The slice ported so
far is the 2-D PnPn-2 Navier-Stokes stepper and its tangent propagator on the
cylinder case, with both elliptic inner solves as hand-written CUDA kernels
(``ops/fused_cg.py``, ``csrc/``).

Defaults (mirroring ``nekstab_next_tpu/__init__.py``):

* float64 unless a dtype is given (:data:`DEFAULT_DTYPE`) — the reference is
  double precision throughout;
* full-f32 matmuls: TF32 is switched off for cuBLAS and cuDNN, since it keeps
  about three decimal digits and the f32 solver tolerances are 1e-5..1e-6.

The device is explicit: every constructor takes ``device=``; nothing here
sets a global default device or dtype.
"""

import torch as _torch

DEFAULT_DTYPE = _torch.float64

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
