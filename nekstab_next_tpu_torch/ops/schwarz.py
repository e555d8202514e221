"""Exact element-block and overlapping-Schwarz preconditioners for the
PnPn-2 pressure solve, and exact element blocks of the velocity Helmholtz
operator (port of ``nekstab_next_tpu/ops/schwarz.py``).

* The blocks of the pressure operator E = D M^-1 D^T are extracted exactly
  with graph-colored operator applies: elements of one color share no
  velocity node (distance 1: enough for the diagonal blocks) or no
  responder (distance 2: every nonzero block, :func:`extract_sparse_E`), so
  one apply of E to a same-color sum of unit basis fields yields one block
  column for every element of that color.  For the sparse E and the
  velocity blocks the applies of one color run as one batched call over
  the ``nloc`` basis columns (``torch.func.vmap``); the ``'block'``
  inverses are extracted one column at a time (:func:`build_pressure_blocks`).
* ``'block'``: the diagonal blocks, inverted on the host in float64,
  applied as one batched small matmul (:func:`block_apply`), plus the Q1
  vertex coarse level (``SEM.pressure_precond_block``).
* ``'schwarz'``: overlapping patches (an element and its face or node
  neighbours) assembled from the sparse blocks and inverted on the host
  (:func:`build_pressure_patches`, :func:`patch_apply`), the exact
  element-constant P0 coarse level (:func:`build_p0_coarse`) and the Q1
  vertex coarse level, added (``SEM.pressure_precond_schwarz``).
* Velocity ``'block'``: the exact element-diagonal blocks of the assembled
  ``P (h1 K + h2 B) P`` per component (:func:`build_velocity_blocks`).

The patch apply adds the patch solutions back into the pressure vector by a
gather over each dof's padded list of patch slots (:func:`patch_copies`),
summed in slot order, where JAX takes ``segment_sum``: the scatter-add's
CUDA atomics would make the sum's order, and so its last bits, vary from
run to run.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Optional

import numpy as np
import torch

from .core import gather_table


def make_pressure_operator(sem) -> Callable:
    """Standard-layout PnPn-2 pressure operator E = D M^-1 D^T (the operator
    the stepper solves each step), with D^T written out."""
    vmask = sem.vmask
    binv = sem.binv_assembled[..., None]

    def E_op(q):
        g = sem.grad_from_p(q)
        return sem.div_to_p(vmask * (binv * sem.dssum(vmask * g)))

    return E_op


def _node_runs(gid: np.ndarray):
    """(elements of each local node sorted by global node, run starts, run
    ends): one run per global node, its elements in local-node order."""
    E = gid.shape[0]
    flat = gid.reshape(E, -1)
    nodes = flat.reshape(-1)
    elem_of = np.repeat(np.arange(E), flat.shape[1])
    order = np.argsort(nodes, kind="stable")
    sn, se = nodes[order], elem_of[order]
    bnd = np.flatnonzero(np.diff(sn)) + 1
    starts = np.concatenate([[0], bnd])
    ends = np.concatenate([bnd, [sn.size]])
    return se, starts, ends


def element_adjacency(gid: np.ndarray):
    """Element coupling graph: e ~ e' iff they share a global velocity node
    (the stencil of E = D M^-1 D^T).  Returns a list of sets (self
    included)."""
    se, starts, ends = _node_runs(gid)
    adj = [{e} for e in range(gid.shape[0])]
    for s, e in zip(starts, ends):
        members = np.unique(se[s:e])
        if members.size > 1:
            for a in members:
                adj[a].update(members)
    return adj


def element_coupling_colors(gid: np.ndarray, distance: int = 1) -> np.ndarray:
    """Greedy coloring of the element coupling graph.

    ``distance=1``: same-colored elements are not E-coupled (enough for the
    diagonal blocks: the response is read only at the source).
    ``distance=2``: same-colored elements share no responder (needed for
    the off-diagonal blocks)."""
    adj = element_adjacency(gid)
    E = len(adj)
    if distance == 2:
        adj = [set().union(*(adj[nb] for nb in a)) for a in adj]
    colors = -np.ones(E, dtype=np.int64)
    for e in range(E):
        used = {colors[nb] for nb in adj[e] if colors[nb] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[e] = c
    return colors


def _nearest_colored_source(gid: np.ndarray, colors: np.ndarray, c: int) -> np.ndarray:
    """For each element, the unique element of color ``c`` in its coupling
    patch (itself or a node-sharing neighbour), or -1 if none."""
    se, starts, ends = _node_runs(gid)
    src = -np.ones(gid.shape[0], dtype=np.int64)
    sel = colors == c
    src[sel] = np.flatnonzero(sel)  # each colored element is its own source
    for s, e in zip(starts, ends):
        members = np.unique(se[s:e])
        colored = members[sel[members]]
        if colored.size == 1:
            src[members] = colored[0]
    return src


def _colored_responses(sem, op: Callable, colors: np.ndarray, shape) -> list:
    """For each color c, the responses out[k, e, l] (float64 host numpy) of
    ``op`` to the unit fields that put 1 at local index k of every element
    of color c, from one batched call over k.  ``shape``: the field shape
    (element axis first)."""
    nelem = shape[0]
    nloc = int(np.prod(shape[1:]))
    batched = torch.func.vmap(op)
    out = []
    with torch.no_grad():
        for c in range(int(colors.max()) + 1):
            sel = torch.as_tensor(colors == c, device=sem.device)
            basis = torch.zeros((nloc, nelem, nloc), dtype=sem.dtype, device=sem.device)
            basis[:, sel, :] = torch.eye(nloc, dtype=sem.dtype, device=sem.device)[:, None, :]
            res = batched(basis.reshape((nloc,) + tuple(shape)))
            out.append(res.reshape(nloc, nelem, nloc).double().cpu().numpy())
    return out


def _invert(blocks: np.ndarray) -> np.ndarray:
    """Batched inverse; per block with a pinv (rcond 1e-10) for the singular
    ones if the batch fails."""
    try:
        return np.linalg.inv(blocks)
    except np.linalg.LinAlgError:
        inv = np.zeros_like(blocks)
        for e in range(blocks.shape[0]):
            try:
                inv[e] = np.linalg.inv(blocks[e])
            except np.linalg.LinAlgError:
                inv[e] = np.linalg.pinv(blocks[e], rcond=1e-10)
        return inv


def extract_sparse_E(sem, E_op: Optional[Callable] = None) -> dict:
    """Every nonzero element block of E = D M^-1 D^T, exactly: with a
    distance-2 coloring one batched apply per color reads off every block
    column attributable to a unique source.

    Returns {(e_responder, e_source): (nloc, nloc) float64 numpy block} with
    block[l, k] = E[(e_resp, l), (e_src, k)]."""
    if E_op is None:
        E_op = make_pressure_operator(sem)
    gid = sem.gid_np.reshape(sem.nelem, -1)
    colors = element_coupling_colors(gid, distance=2)
    B: dict = {}
    for c, out in enumerate(_colored_responses(sem, E_op, colors, sem.p_shape)):
        src = _nearest_colored_source(gid, colors, c)
        for e in np.flatnonzero(src >= 0):
            B[(int(e), int(src[e]))] = out[:, e].T.copy()
    return B


def build_pressure_blocks(sem) -> torch.Tensor:
    """Exact per-element diagonal blocks of E, inverted: (nelem, nloc, nloc)
    with nloc = npr^2, in the SEM's dtype on its device.  The operator
    applies run in the SEM's dtype one basis column at a time, unbatched,
    so the f32 inverses K2 reads keep their exact bits; the inversion runs
    in float64 on the host (as the JAX package does)."""
    E_op = make_pressure_operator(sem)
    nelem, nloc = sem.nelem, int(np.prod(sem.p_shape[1:]))
    colors = element_coupling_colors(sem.gid_np.reshape(nelem, -1))
    blocks = np.zeros((nelem, nloc, nloc))
    with torch.no_grad():
        for c in range(int(colors.max()) + 1):
            sel = colors == c
            sel_t = torch.as_tensor(sel, device=sem.device)
            for k in range(nloc):
                basis = torch.zeros((nelem, nloc), dtype=sem.dtype, device=sem.device)
                basis[sel_t, k] = 1.0
                out = E_op(basis.reshape(sem.p_shape)).reshape(nelem, nloc)
                # out[e, l] = E[e,l ; e,k] for e of this color
                blocks[sel, :, k] = out[sel_t].double().cpu().numpy()
    blocks = 0.5 * (blocks + blocks.transpose(0, 2, 1))
    return torch.as_tensor(_invert(blocks), dtype=sem.dtype, device=sem.device)


def block_apply(pblock_inv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """z = E_ee^-1 r elementwise — one batched small matmul."""
    nelem, nloc = pblock_inv.shape[0], pblock_inv.shape[1]
    z = torch.einsum("elk,ek->el", pblock_inv, r.reshape(nelem, nloc))
    return z.reshape(r.shape)


def face_adjacency(gid: np.ndarray):
    """Face-neighbour lists (elements sharing >= 2 global nodes, i.e. an
    edge; vertex-diagonal neighbours excluded), self not included."""
    se, starts, ends = _node_runs(gid)
    pair_counts: Counter = Counter()
    for s, e in zip(starts, ends):
        members = np.unique(se[s:e])
        for i in range(members.size):
            for j in range(i + 1, members.size):
                pair_counts[(int(members[i]), int(members[j]))] += 1
    nbrs = [[] for _ in range(gid.shape[0])]
    for (a, b), cnt in pair_counts.items():
        if cnt >= 2:
            nbrs[a].append(b)
            nbrs[b].append(a)
    return [sorted(x) for x in nbrs]


def patch_copies(pidx: np.ndarray, N: int) -> np.ndarray:
    """(N, m) int64: for each pressure dof, the flat patch slots
    (``e * pdim + a``) that hold it in increasing order, padded with the
    index ``pidx.size`` of an appended zero slot: the gather that adds the
    patch solutions back (:func:`patch_apply`)."""
    return gather_table(np.asarray(pidx).reshape(-1), N + 1)[:N]


def build_pressure_patches(sem, E_op: Optional[Callable] = None,
                           weighted: bool = True,
                           B: Optional[dict] = None,
                           adjacency: str = "face"):
    """Overlapping element-patch Schwarz solves for the pressure operator.

    The patch of element e is e and its face neighbours (``'face'``) or all
    its node-sharing neighbours (``'node'``); the patch matrix is the exact
    restriction of E (assembled from :func:`extract_sparse_E`), inverted on
    the host in float64.

    Returns (pidx, Pinv, w, copies) on the SEM's device:
    pidx   : (nelem, pdim) int64 indices into the flat pressure vector,
             padded with N (a dead slot)
    Pinv   : (nelem, pdim, pdim) patch inverses (identity on pad slots)
    w      : (nelem, pdim) partition weights (1/count if ``weighted``, the
             symmetric-weighted additive Schwarz M = sum R^T W Pinv W R;
             ones: plain additive Schwarz), zero on pad slots
    copies : :func:`patch_copies` of pidx
    Pinv and w take the SEM's dtype."""
    if adjacency not in ("face", "node"):
        raise ValueError(f"adjacency must be 'face' or 'node', got {adjacency!r}")
    nelem = sem.nelem
    nloc = int(np.prod(sem.p_shape[1:]))
    N = nelem * nloc
    if B is None:
        B = extract_sparse_E(sem, E_op)
    gidf = sem.gid_np.reshape(nelem, -1)
    if adjacency == "node":
        adj = element_adjacency(gidf)
        members = [[e] + sorted(adj[e] - {e}) for e in range(nelem)]
    else:
        nbrs = face_adjacency(gidf)
        members = [[e] + nbrs[e] for e in range(nelem)]
    pdim = max(len(m) for m in members) * nloc

    pidx = np.full((nelem, pdim), N, dtype=np.int64)
    Pmats = np.zeros((nelem, pdim, pdim))
    counts = np.zeros(N)
    for e, mem in enumerate(members):
        P = Pmats[e]
        for i, ei in enumerate(mem):
            for j, ej in enumerate(mem):
                blk = B.get((ei, ej))
                if blk is not None:
                    P[i * nloc:(i + 1) * nloc, j * nloc:(j + 1) * nloc] = blk
        idx = np.concatenate([np.arange(m * nloc, (m + 1) * nloc) for m in mem])
        pidx[e, :idx.size] = idx
        counts[idx] += 1.0
        # pad slots get an identity so the batch inverts in one LAPACK call
        # (their rows are masked by w)
        pad = np.arange(idx.size, pdim)
        P[pad, pad] = 1.0
    Pmats = 0.5 * (Pmats + Pmats.transpose(0, 2, 1))
    Pinv = _invert(Pmats)
    w = np.ones((nelem, pdim))
    if weighted:
        w = 1.0 / np.concatenate([counts, [1.0]])[pidx]
    w[pidx == N] = 0.0
    dev = sem.device
    return (torch.as_tensor(pidx, device=dev),
            torch.as_tensor(Pinv, dtype=sem.dtype, device=dev),
            torch.as_tensor(w, dtype=sem.dtype, device=dev),
            torch.as_tensor(patch_copies(pidx, N), device=dev))


def patch_apply(pidx: torch.Tensor, Pinv: torch.Tensor, w: torch.Tensor,
                copies: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """z = sum_e R_e^T W_e Pinv_e W_e R_e r: gather, batched matmul, and the
    deterministic gather-sum back over ``copies``."""
    rf = torch.cat([r.reshape(-1), r.new_zeros(1)])
    z = torch.einsum("eab,eb->ea", Pinv, rf[pidx] * w) * w
    zf = torch.cat([z.reshape(-1), z.new_zeros(1)])
    return zf[copies].sum(dim=1).reshape(r.shape)


def build_velocity_blocks(sem, h1: float, h2: float) -> torch.Tensor:
    """Exact element-diagonal blocks of the assembled velocity Helmholtz
    P (h1 K + h2 B) P per component (P = mask dsavg mask, the solve
    operator of ops/elliptic.py), inverted on the host in float64.

    Returns (ndim, nelem, nloc, nloc) block inverses in the SEM's dtype.
    ``h2`` is the g0/dt of the final BDF stage; the two ramp steps see a
    mismatched but still SPD preconditioner."""
    fshape = tuple(int(s) for s in sem.bm.shape)
    nloc = int(np.prod(fshape[1:]))
    colors = element_coupling_colors(sem.gid_np.reshape(sem.nelem, -1))
    out = []
    for c_comp in range(sem.ndim):
        mask = sem.vmask[..., c_comp]

        def P(x):
            return mask * sem.dsavg(mask * x)

        def E_op(x):
            return P(sem.helmholtz_local(P(x), h1, h2))

        blocks = np.zeros((sem.nelem, nloc, nloc))
        for c, res in enumerate(_colored_responses(sem, E_op, colors, fshape)):
            sel = colors == c
            blocks[sel] = res[:, sel].transpose(1, 2, 0)
        blocks = 0.5 * (blocks + blocks.transpose(0, 2, 1))
        # Dirichlet-masked rows/cols are zero: a 1 on those diagonal entries
        # lets the batch invert (the apply re-masks through P)
        diag = np.einsum("eii->ei", blocks)
        for e, k in zip(*np.nonzero(diag <= 0.0)):
            blocks[e, k, k] = 1.0
        try:
            inv = np.linalg.inv(blocks)
        except np.linalg.LinAlgError:
            inv = np.stack([np.linalg.pinv(b, rcond=1e-10) for b in blocks])
        out.append(inv)
    return torch.as_tensor(np.stack(out), dtype=sem.dtype, device=sem.device)


def velocity_block_apply(vblock_inv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """z[..., c] = B_c^-1 r[..., c] elementwise — one batched matmul per
    component (r: (nelem, ..., ndim))."""
    nelem, nloc = vblock_inv.shape[1], vblock_inv.shape[2]
    z = torch.einsum("celk,ekc->elc", vblock_inv, r.reshape(nelem, nloc, -1))
    return z.reshape(r.shape)


def build_p0_coarse(sem, B: Optional[dict] = None) -> np.ndarray:
    """Element-constant (P0) coarse operator of the discontinuous pressure
    space, A_c[e, e'] = the sum of E's (e, e') block, assembled exactly from
    the sparse blocks and inverted on the host (pinv, rcond 1e-12, when the
    pressure has no Dirichlet boundary and the constant is in its null
    space).  Returns the dense (nelem, nelem) float64 inverse."""
    if B is None:
        B = extract_sparse_E(sem)
    nelem = sem.nelem
    Ac = np.zeros((nelem, nelem))
    for (e, es), blk in B.items():
        Ac[e, es] = blk.sum()
    Ac = 0.5 * (Ac + Ac.T)
    if sem.has_pressure_dirichlet:
        return np.linalg.inv(Ac)
    return np.linalg.pinv(Ac, rcond=1e-12)


def p0_coarse_apply(Acinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """z = phi A_c^-1 phi^T r: restrict by element sums, dense coarse solve,
    prolong by broadcast."""
    nelem = Acinv.shape[0]
    rf = r.reshape(nelem, -1)
    xc = Acinv @ rf.sum(dim=1)
    return xc[:, None].expand(rf.shape).reshape(r.shape)
