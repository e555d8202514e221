"""nekstab_next_tpu_torch — the PyTorch/CUDA port of ``nekstab_next_tpu``.

The JAX package beside this one is the reference; this package mirrors its
layout and names (``ops/core.py`` -> ``nekstab_next_tpu_torch/ops/core.py``
...), imports ``torch``, numpy and scipy, and never jax.  It covers the
JAX package's scope: the 2-D and 3-D Navier-Stokes steppers (with
scalars), their tangent and adjoint propagators, the Krylov layer and the
analyses built on them, with the TPU kernels as hand-written CUDA kernels
(``ops/fused_cg.py``, ``ops/fused_helmholtz.py``, ``csrc/``), and their
element-sharded runs over a ``torch.distributed`` process group
(``parallel/``, the counterpart of JAX's ``shard_map``).

Defaults (mirroring ``nekstab_next_tpu/__init__.py``):

* float64 unless a dtype is given (:data:`DEFAULT_DTYPE`) — the reference is
  double precision throughout;
* full-f32 matmuls: TF32 is switched off for cuBLAS and cuDNN, since it keeps
  about three decimal digits and the f32 solver tolerances are 1e-5..1e-6.

The device: every constructor takes ``device=`` and runs on the current
CUDA device when it is not given (:func:`resolve_device`); without a CUDA
device that raises, and the caller asks for the CPU with ``device="cpu"``.
Nothing here sets a global default device or dtype.
"""

import torch as _torch

DEFAULT_DTYPE = _torch.float64

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> _torch.device:
    """The device an entry point runs on: ``device`` as given, else the
    current CUDA device.  Never falls back to the CPU: with no CUDA device
    and no ``device`` it raises."""
    if device is None:
        if not _torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                'device="cpu" to run on the CPU'
            )
        device = "cuda"
    device = _torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = _torch.device("cuda", _torch.cuda.current_device())
    return device

__version__ = "0.1.0"
