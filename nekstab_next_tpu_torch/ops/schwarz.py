"""Exact element-block preconditioner for the PnPn-2 pressure solve.

Port of the ``'block'`` part of ``nekstab_next_tpu/ops/schwarz.py``: the
diagonal blocks ``E_ee`` of the pressure operator E = D M^-1 D^T are
extracted exactly with a graph-colored set of operator applies (elements of
one color share no velocity node, so one apply of E to a same-color sum of
unit basis fields yields one block column for every element of that color),
inverted on the host in float64, and applied as one batched small matmul.
Combined additively with the Q1 vertex coarse level (``SEM.
pressure_precond_block``).  The overlapping-Schwarz patches are not ported.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def make_pressure_operator(sem) -> Callable:
    """Standard-layout PnPn-2 pressure operator E = D M^-1 D^T (the operator
    the stepper solves each step), with D^T written out."""
    vmask = sem.vmask
    binv = sem.binv_assembled[..., None]

    def E_op(q):
        g = sem.grad_from_p(q)
        return sem.div_to_p(vmask * (binv * sem.dssum(vmask * g)))

    return E_op


def element_adjacency(gid: np.ndarray):
    """Element coupling graph: e ~ e' iff they share a global velocity node
    (the stencil of E = D M^-1 D^T).  Returns a list of sets (self
    included)."""
    E = gid.shape[0]
    flat = gid.reshape(E, -1)
    nodes = flat.reshape(-1)
    elem_of = np.repeat(np.arange(E), flat.shape[1])
    order = np.argsort(nodes, kind="stable")
    sn, se = nodes[order], elem_of[order]
    bnd = np.flatnonzero(np.diff(sn)) + 1
    starts = np.concatenate([[0], bnd])
    ends = np.concatenate([bnd, [sn.size]])
    adj = [{e} for e in range(E)]
    for s, e in zip(starts, ends):
        members = np.unique(se[s:e])
        if members.size > 1:
            for a in members:
                adj[a].update(members)
    return adj


def element_coupling_colors(gid: np.ndarray) -> np.ndarray:
    """Greedy coloring of the element coupling graph: same-colored elements
    are not E-coupled."""
    adj = element_adjacency(gid)
    E = len(adj)
    colors = -np.ones(E, dtype=np.int64)
    for e in range(E):
        used = {colors[nb] for nb in adj[e] if colors[nb] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[e] = c
    return colors


def build_pressure_blocks(sem) -> torch.Tensor:
    """Exact per-element diagonal blocks of E, inverted: (nelem, nloc, nloc)
    with nloc = npr^2, in the SEM's dtype on its device.  The operator
    applies run in the SEM's dtype; the inversion runs in float64 on the
    host (as the JAX package does)."""
    E_op = make_pressure_operator(sem)
    nelem, npr = sem.nelem, sem.npr
    nloc = npr * npr
    colors = element_coupling_colors(sem.gid_np.reshape(nelem, -1))
    blocks = np.zeros((nelem, nloc, nloc))
    with torch.no_grad():
        for c in range(int(colors.max()) + 1):
            sel = colors == c
            sel_t = torch.as_tensor(sel, device=sem.device)
            for k in range(nloc):
                basis = torch.zeros((nelem, nloc), dtype=sem.dtype,
                                    device=sem.device)
                basis[sel_t, k] = 1.0
                out = E_op(basis.reshape(sem.p_shape)).reshape(nelem, nloc)
                # out[e, l] = E[e,l ; e,k] for e of this color
                blocks[sel, :, k] = out[sel_t].double().cpu().numpy()
    blocks = 0.5 * (blocks + blocks.transpose(0, 2, 1))
    try:
        inv = np.linalg.inv(blocks)
    except np.linalg.LinAlgError:
        inv = np.zeros_like(blocks)
        for e in range(nelem):
            try:
                inv[e] = np.linalg.inv(blocks[e])
            except np.linalg.LinAlgError:
                inv[e] = np.linalg.pinv(blocks[e], rcond=1e-10)
    return torch.as_tensor(inv, dtype=sem.dtype, device=sem.device)


def block_apply(pblock_inv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """z = E_ee^-1 r elementwise — one batched small matmul."""
    nelem, nloc = pblock_inv.shape[0], pblock_inv.shape[1]
    z = torch.einsum("elk,ek->el", pblock_inv, r.reshape(nelem, nloc))
    return z.reshape(r.shape)
