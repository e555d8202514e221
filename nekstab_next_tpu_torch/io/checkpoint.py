"""Arnoldi checkpoint/restart (a copy of ``nekstab_next_tpu/io/checkpoint.py``,
host numpy: the files either package writes, the other reads).

Every outer iteration of ``krylov.krylov_schur.eigs`` can persist the
current Krylov basis and Hessenberg so a crashed or preempted run resumes
where it stopped (the reference's ``KRY*`` field files + ``HES*`` ascii;
one ``.npz`` bundle here), and with ``checkpoint_steps`` every Arnoldi
column as it is produced."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


class ArnoldiCheckpoint:
    """Persist/restore (basis columns, H, j) for a running factorization.

    The basis is stored as the stacked leading-axis array(s) of the
    :class:`~nekstab_next_tpu_torch.krylov.vector.Basis` pytree (host
    copy), one ``q{i}`` per leaf in pytree order."""

    def __init__(self, directory: str, session: str = "run"):
        self.directory = directory
        self.session = session
        os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"KRY_{self.session}.npz")

    def save(self, basis_stacked, H: np.ndarray, ncols: int, **meta) -> str:
        """``basis_stacked``: array (capacity, ...) or list of pytree leaves."""
        leaves = (
            basis_stacked if isinstance(basis_stacked, (list, tuple))
            else [basis_stacked]
        )
        payload = {f"q{i}": np.asarray(l) for i, l in enumerate(leaves)}
        payload["H"] = np.asarray(H)
        payload["ncols"] = np.asarray(int(ncols))
        for k, v in meta.items():
            payload[f"meta_{k}"] = np.asarray(v)
        tmp = self.path + ".tmp.npz"  # np.savez appends .npz otherwise
        np.savez(tmp, **payload)
        os.replace(tmp, self.path)  # atomic: a crash never corrupts the last good checkpoint
        return self.path

    def load(self) -> Optional[Tuple[list, np.ndarray, int, dict]]:
        if not os.path.exists(self.path):
            return None
        with np.load(self.path) as z:
            nq = sum(1 for k in z.files if k.startswith("q"))
            leaves = [z[f"q{i}"] for i in range(nq)]
            meta = {
                k[5:]: z[k] for k in z.files if k.startswith("meta_")
            }
            return leaves, z["H"], int(z["ncols"]), meta

    # ------------------------------------------------------------------
    # per-Arnoldi-step incremental checkpointing (the reference outposts
    # every Krylov vector + the ascii Hessenberg each step when ifres —
    # core/eigensolvers.f90:758-857; here one .npz per column + one small
    # atomically-replaced state file, so a crash costs at most one matvec)
    # ------------------------------------------------------------------
    def _col_path(self, j: int) -> str:
        return os.path.join(self.directory,
                            f"KRY_{self.session}_c{j:05d}.npz")

    @property
    def state_path(self) -> str:
        return os.path.join(self.directory, f"HES_{self.session}.npz")

    def save_column(self, j: int, col_leaves, H: np.ndarray, ncols: int,
                    **meta) -> None:
        """Persist basis column ``j`` plus the (H, ncols) state.  ``ncols``
        is the next Arnoldi index to run on resume; columns 0..ncols must
        exist on disk for the state to be resumable.  Column first, state
        second, both atomic — a crash in between leaves the previous state
        valid (the extra column file is simply ignored)."""
        leaves = (col_leaves if isinstance(col_leaves, (list, tuple))
                  else [col_leaves])
        payload = {f"q{i}": np.asarray(l) for i, l in enumerate(leaves)}
        tmp = self._col_path(j) + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, self._col_path(j))
        st = {"H": np.asarray(H), "ncols": np.asarray(int(ncols))}
        for k, v in meta.items():
            st[f"meta_{k}"] = np.asarray(v)
        tmp = self.state_path + ".tmp.npz"
        np.savez(tmp, **st)
        os.replace(tmp, self.state_path)

    def load_columns(self) -> Optional[Tuple[dict, np.ndarray, int, dict]]:
        """Resume state for a mid-factorization restart: ({j: leaves}, H,
        ncols, meta), or None.  Only columns <= ncols are returned."""
        if not os.path.exists(self.state_path):
            return None
        with np.load(self.state_path) as z:
            H = z["H"]
            ncols = int(z["ncols"])
            meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
        cols = {}
        for j in range(ncols + 1):
            p = self._col_path(j)
            if not os.path.exists(p):
                continue
            with np.load(p) as z:
                nq = sum(1 for k in z.files if k.startswith("q"))
                cols[j] = [z[f"q{i}"] for i in range(nq)]
        return cols, H, ncols, meta

    def clear_columns(self) -> None:
        """Drop per-step state (called when a Schur restart rewrites the
        basis — the restart bundle supersedes the step files)."""
        import glob

        for p in glob.glob(
            os.path.join(self.directory, f"KRY_{self.session}_c*.npz")
        ):
            os.remove(p)
        if os.path.exists(self.state_path):
            os.remove(self.state_path)

    def clear(self) -> None:
        if os.path.exists(self.path):
            os.remove(self.path)
        self.clear_columns()
