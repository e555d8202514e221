"""The shared comparison of one run against the plain reference.

Once the window has closed and the program's state is freed, the
reference (float64, exact solves) judges what the timed path produced.
Each loop module (``loops/<loop>.py``) says which numbers its traffic
has, from these pieces:

* ``start_vector``: the first basis column the program formed, against
  the seed's start vector normalised in the energy product;
* ``prop_<direction>``: for applications drawn from the seed among those
  the window completed (at least one of each direction), the program's
  output against the reference's application to the same input, as
  ||y - y_ref||_B / ||y_ref||_B (B the mass; every node counts);
* ``krylov_basis``: for the same applications, the next basis column the
  Krylov layer formed from the program's output, against the reference's
  classical Gram-Schmidt with one re-orthogonalisation (as ``eigs`` and
  ``svds`` specify it) of that output against the program's earlier
  columns of the same basis, in the sponge-masked energy product.

The reference follows the program step by step: each application starts
from the program's own basis column, and each orthogonalisation from the
program's own earlier columns; ``start_vector`` checks the start that this
skips.  Each number is compared with its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .window import Application


def sample(apps: List[Application], directions: List[str], count: int, seed: int) -> List[int]:
    """Indices of ``count`` completed applications drawn from the seed,
    with at least one of each direction that the window completed."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 7])
    chosen: List[int] = []
    for d in directions:
        idx = [i for i, a in enumerate(apps) if a.direction == d]
        if idx:
            chosen.append(int(rng.choice(idx)))
    rest = [i for i in range(len(apps)) if i not in chosen]
    more = max(min(count - len(chosen), len(rest)), 0)
    if more:
        chosen += [int(i) for i in rng.choice(rest, size=more, replace=False)]
    return sorted(chosen)


def _worst(numbers: dict, key: str, value: float) -> None:
    """Keep the largest reading of ``key``; a NaN stays."""
    old = numbers.get(key, 0.0)
    numbers[key] = value if (np.isnan(value) or value > old) and not np.isnan(old) else old


def _norm(x: torch.Tensor, w: torch.Tensor) -> float:
    return float(torch.sqrt(torch.sum(x * x * w[..., None])))


def _orthonormalise(w: torch.Tensor, Q: List[torch.Tensor], wt: torch.Tensor) -> torch.Tensor:
    """Classical Gram-Schmidt of w against Q with one re-orthogonalisation
    in the product <a, b> = sum a b wt, then normalised."""
    dot = lambda a, b: torch.sum(a * b * wt[..., None])
    for _ in range(2):
        if Q:
            h = torch.stack([dot(q, w) for q in Q])
            w = w - torch.einsum("k,k...->...", h, torch.stack(Q))
    return w / torch.sqrt(dot(w, w))


def _on(ref, t: torch.Tensor) -> torch.Tensor:
    return t.to(device=ref.dev, dtype=torch.float64)


def start_vector(ref, apps: List[Application], x0: torch.Tensor) -> Dict[str, float]:
    """{'start_vector': ...} where the window completed an application."""
    if not apps:
        return {}
    bms = ref.bms.to(torch.float64)
    q0 = _on(ref, x0) / _norm(_on(ref, x0), bms)
    return {"start_vector": _norm(_on(ref, apps[0].x) - q0, bms)}


def propagator(ref, a: Application, nsteps: int, numbers: dict) -> None:
    """Keeps the worst ``prop_<direction>`` reading."""
    bm = ref.bm.to(torch.float64)
    y_ref = ref.apply(a.direction, _on(ref, a.x), nsteps).to(torch.float64)
    err = _norm(_on(ref, a.y) - y_ref, bm) / max(_norm(y_ref, bm), 1e-300)
    _worst(numbers, f"prop_{a.direction}", err)


def next_column(ref, apps: List[Application], pending, i: int, capacity: int,
                numbers: dict) -> None:
    """Keeps the worst ``krylov_basis`` reading: the input that followed
    application i in its analysis (before the basis's first restart,
    ``capacity`` applications), against the reference's CGS2 of
    application i's output against the earlier columns of that basis."""
    inputs = apps + ([pending] if pending is not None else [])
    a = apps[i]
    nxt = inputs[i + 1] if i + 1 < len(inputs) else None
    if nxt is None or nxt.analysis != a.analysis or nxt.index >= capacity:
        return
    Q = [_on(ref, b.x) for b in inputs[:i + 1]
         if b.analysis == a.analysis and b.direction == nxt.direction]
    bms = ref.bms.to(torch.float64)
    q_ref = _orthonormalise(_on(ref, a.y), Q, bms)
    _worst(numbers, "krylov_basis", _norm(_on(ref, nxt.x) - q_ref, bms))


def compare(numbers: Dict[str, float], limits: dict) -> Tuple[Dict[str, list], int]:
    """Every number beside its limit, and how many exceed it (a NaN, or a
    number without a limit, exceeds it)."""
    checks = {k: [v, float(limits.get(k, float("nan")))] for k, v in numbers.items()}
    failed = sum(1 for v, lim in checks.values() if not (np.isfinite(v) and v <= lim))
    return checks, failed
