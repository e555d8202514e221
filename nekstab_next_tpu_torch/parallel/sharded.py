"""SPMD execution over a ``torch.distributed`` process group:
element-partitioned domain decomposition (port of
``nekstab_next_tpu/parallel/sharded.py``).

The reference's distribution axis is Nek5000's element partition over MPI
ranks, with gather-scatter face exchange and all-reduce inner products.
JAX runs one controller and splits global arrays with ``shard_map``; the
port is multi-process SPMD, as Nek5000 is: every rank runs the same Python
on its own contiguous block of ``nelem / world_size`` elements (``P('e')``'s
partition) and the SEM's sums and dots become collectives:

* :func:`make_device_mesh` joins or creates the process group: NCCL on the
  card (device ``cuda:LOCAL_RANK``), gloo on the CPU, a backend given
  explicitly as given.  A missing device or backend raises; nothing falls
  back to the CPU or to another backend;
* :class:`ShardedContext` builds the whole mesh's SEM on each rank (the
  exact pressure blocks included: they are element-local), slices its
  per-element arrays to this rank's block and steps on the shard view
  (``SEMBase.shard_view``), where ``dssum``, the reductions and the Q1
  coarse right-hand side all-reduce over the group (each an autograd
  Function whose backward is the same all-reduce, so the adjoint step's
  ``torch.func.vjp`` runs through them);
* states and fields are sliced to this rank's elements on their element
  axis (:meth:`ShardedContext.shard_state`, :meth:`shard_field`) and put
  back together with one ``all_gather`` (:meth:`gather_field`,
  :meth:`gather_state`).

Krylov vectors stay sharded end to end: a :class:`~..krylov.vector.Basis`
over the shard view's space holds this rank's elements of every column,
and its dots reduce with one all-reduce a batch.  Every rank runs the same
host algorithm on identical all-reduced scalars, so every rank builds the
same Hessenberg and takes the same branches (the CG loop's live mask too).

No kernel runs on a shard view, as in JAX (its kernels are built only
when ``sem.axis_name is None``), and ``mixed_precision=True`` raises there
(``ops/mixed.py``).

Usage (``torchrun --nproc_per_node=N script.py``, or ``python`` for one
rank)::

    ctx = ShardedContext(mesh, viscosity=1 / Re, dt=dt, u_bc=ubc)
    state = ctx.shard_state(ctx.make_host_state(u0))
    step = ctx.compile(lambda ns, st: ns.step(st))
    state = step(state)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from ..config import SolverConfig
from ..stepper.navier_stokes import NavierStokes
from ..stepper.state import FlowState, initial_state

@dataclasses.dataclass
class DeviceMesh:
    """A process group over which elements are sharded: its ``group``
    handle, this process's ``rank``, the group's ``size``, the ``device``
    this rank computes on and the ``backend``.  ``owns_group``: created by
    :func:`make_device_mesh`, so :meth:`close` destroys it."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    owns_group: bool = False

    def close(self) -> None:
        """Destroy the process group if this mesh created it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


def make_device_mesh(n_devices: Optional[int] = None, *, rank: Optional[int] = None, device=None,
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None) -> DeviceMesh:
    """Join the default process group if one exists, else create it.

    ``n_devices`` is the world size and ``rank`` this process's rank;
    unset, they come from ``WORLD_SIZE``/``RANK`` as ``torchrun`` sets
    them, else 1 and 0.  ``device``: unset, ``cuda:LOCAL_RANK`` (raises
    without a CUDA device; pass ``device="cpu"`` for the CPU).  ``backend``:
    unset, NCCL on a CUDA device and gloo on the CPU; given, used as given
    (gloo on a CUDA device runs two ranks on one card).  ``init_method``:
    a ``file://`` or ``tcp://`` address; unset, ``env://`` (``torchrun``'s
    ``MASTER_ADDR``/``MASTER_PORT``), or for one rank with no
    ``MASTER_ADDR`` an in-process store."""
    if device is None:
        if not torch.cuda.is_available():
            resolve_device(None)  # raises: no CUDA device and no device given
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    available = {"nccl": dist.is_nccl_available, "gloo": dist.is_gloo_available}
    if backend not in available:
        raise ValueError(f"unknown backend {backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, got {device}")
    if not (dist.is_available() and available[backend]()):
        raise RuntimeError(f"torch.distributed backend {backend!r} is not available")
    if device.type == "cuda":
        torch.cuda.set_device(device)

    owns = not dist.is_initialized()
    if owns:
        rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
        size = (int(os.environ.get("WORLD_SIZE", 1)) if n_devices is None
                else int(n_devices))
        if init_method is None and size == 1 and "MASTER_ADDR" not in os.environ:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            dist.init_process_group(backend, init_method=init_method or "env://",
                                    rank=rank, world_size=size)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, not {backend!r}")
    group = dist.group.WORLD
    mesh = DeviceMesh(group, dist.get_rank(group), dist.get_world_size(group), device,
                      backend, owns)
    if n_devices is not None and mesh.size != int(n_devices):
        raise ValueError(f"the process group has {mesh.size} ranks, not {n_devices}")
    return mesh


class ShardedContext:
    """A device mesh, this rank's slices of the SEM's per-element arrays,
    and the stepper on them.

    Usage::

        ctx = ShardedContext(mesh, viscosity=1/Re, dt=dt, u_bc=ubc)
        state = ctx.shard_state(ctx.make_host_state(u0))
        step = ctx.compile(lambda ns, st: ns.step(st))
        state = step(state)

    ``mesh`` is the whole mesh (every rank builds its SEM, then keeps its
    elements); ``dmesh`` a :class:`DeviceMesh` (default:
    :func:`make_device_mesh`).  The keyword arguments are JAX's: ``u_bc``,
    ``forcing``, ``sponge_strength``, ``sponge_ref`` and, for the stepper,
    ``viscosity``, ``dt``, ``solver``, ``mixed_precision`` and ``u_bc_fn``.
    """

    def __init__(
        self,
        mesh,
        dmesh: Optional[DeviceMesh] = None,
        dtype=torch.float64,
        u_bc: Optional[torch.Tensor] = None,
        forcing: Optional[Callable] = None,
        sponge_strength=None,
        sponge_ref: Optional[torch.Tensor] = None,
        **ns_kwargs,
    ):
        self.mesh = mesh
        self.dmesh = dmesh if dmesh is not None else make_device_mesh()
        ndev = self.dmesh.size
        if mesh.nelem % ndev != 0:
            raise ValueError(
                f"nelem={mesh.nelem} must be divisible by the {ndev}-device mesh "
                "(choose element counts accordingly; padding lands later)"
            )
        device = self.dmesh.device
        if getattr(mesh, "ndim", 2) == 3:
            from ..ops.core3 import SEM3

            self._sem_host = SEM3(mesh, dtype=dtype, device=device)
        else:
            from ..ops.core import SEM

            self._sem_host = SEM(mesh, dtype=dtype, device=device)
        s = self._sem_host
        if sponge_strength is not None:
            s.set_sponge(sponge_strength)
        self.ns_kwargs = dict(ns_kwargs)
        self._forcing = forcing

        # the exact element blocks are element-local, so they shard like any
        # geometry array ('schwarz' patches address the whole mesh and fall
        # back to 'block' on the shard view)
        solver = self.ns_kwargs.get("solver", SolverConfig())
        if (solver.pressure_precond in ("block", "schwarz")
                and solver.pressure_operator == "pnpn2"):
            s.setup_pressure_blocks()

        arrays = s.elem_arrays()
        shape = tuple(s.bm.shape) + (s.ndim,)
        on = lambda x: x.to(device=device, dtype=s.dtype)
        arrays["u_bc"] = (torch.zeros(shape, dtype=s.dtype, device=device) if u_bc is None
                          else (1.0 - s.vmask) * on(u_bc))
        arrays["sponge_ref"] = (torch.zeros(shape, dtype=s.dtype, device=device)
                                if sponge_ref is None else on(sponge_ref))
        self._has_sponge_ref = sponge_ref is not None
        self.nelem_local = mesh.nelem // ndev
        self.lo = self.dmesh.rank * self.nelem_local
        self.arrays = {k: v[self.lo:self.lo + self.nelem_local].contiguous()
                       for k, v in arrays.items()}
        self.sem = s.shard_view(self.arrays, self.dmesh.group)
        self._ns: Optional[NavierStokes] = None

    # ------------------------------------------------------------------
    def make_ns(self) -> NavierStokes:
        """The stepper on this rank's shard view, through the real
        constructor."""
        return NavierStokes(
            self.sem,
            viscosity=self.ns_kwargs.get("viscosity", 1.0),
            dt=self.ns_kwargs.get("dt", 1e-3),
            u_bc=self.arrays["u_bc"],
            forcing=self._forcing,
            sponge_ref=self.arrays["sponge_ref"] if self._has_sponge_ref else None,
            solver=self.ns_kwargs.get("solver", SolverConfig()),
            mixed_precision=self.ns_kwargs.get("mixed_precision", False),
            u_bc_fn=self.ns_kwargs.get("u_bc_fn", None),
        )

    @property
    def ns(self) -> NavierStokes:
        """This rank's stepper, built once."""
        if self._ns is None:
            self._ns = self.make_ns()
        return self._ns

    # ------------------------------------------------------------------
    def state_spec(self, thermal: bool = False, warm: bool = True) -> FlowState:
        """Each FlowState field's element axis (None: a host scalar) --
        JAX's PartitionSpecs: the lag axes shard on their second axis."""
        extra = dict(T=0, tlag=1, ntlag=1) if thermal else {}
        if warm:
            extra["dp"] = 0
        return FlowState(u=0, p=0, ulag=1, nlag=1, time=None, step=None, **extra)

    def field_spec(self) -> int:
        """A field's element axis."""
        return 0

    def make_host_state(self, u: torch.Tensor, time: float = 0.0, T=None) -> FlowState:
        """A fresh whole-mesh state matching this context's stepper config
        (pressure space and the warm-start carry)."""
        solver = self.ns_kwargs.get("solver", SolverConfig())
        s = self._sem_host
        scheme = ("laplacian" if self.ns_kwargs.get("mixed_precision")
                  else solver.pressure_operator)
        p = torch.zeros(s.p_shape if scheme == "pnpn2" else tuple(s.bm.shape),
                        dtype=s.dtype, device=s.device)
        return initial_state(u.to(device=s.device, dtype=s.dtype), p=p, time=time, T=T,
                             warm_start=solver.warm_start)

    def _slice(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        idx = (slice(None),) * axis + (slice(self.lo, self.lo + self.nelem_local),)
        return x[idx].to(self.dmesh.device).contiguous()

    def shard_state(self, state: FlowState) -> FlowState:
        """This rank's elements of a whole-mesh state."""
        return self._map_state(state, self._slice)

    def shard_field(self, u: torch.Tensor) -> torch.Tensor:
        """This rank's elements of a whole-mesh field."""
        return self._slice(u, self.field_spec())

    def gather_field(self, u: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The whole-mesh field from every rank's elements (one
        ``all_gather``; every rank gets it), for output and checks."""
        parts = [torch.empty_like(u) for _ in range(self.dmesh.size)]
        dist.all_gather(parts, u.contiguous(), group=self.dmesh.group)
        return torch.cat(parts, dim=axis)

    def gather_state(self, state: FlowState) -> FlowState:
        """The whole-mesh state from every rank's elements."""
        return self._map_state(state, self.gather_field)

    def _map_state(self, state: FlowState, fn) -> FlowState:
        """``fn(field, element axis)`` on each field of ``state`` that
        :meth:`state_spec` shards."""
        spec = self.state_spec(thermal=state.T is not None, warm=state.dp is not None)
        out = {}
        for f in dataclasses.fields(FlowState):
            x, axis = getattr(state, f.name), getattr(spec, f.name)
            out[f.name] = x if axis is None else fn(x, axis)
        return FlowState(**out)

    # ------------------------------------------------------------------
    def compile(self, fn: Callable) -> Callable:
        """``fn(ns_local, *args)`` on this rank's stepper (JAX's
        shard_map + jit): there is nothing to trace, and the arguments are
        this rank's slices already."""
        ns = self.ns
        return lambda *args: fn(ns, *args)
