"""The Krylov-Schur loop of ``eigs`` on one direction of the propagator.

A traffic mix with ``"loop": "krylov_schur"`` runs one analysis at a
time through the program's ``eigs`` on ``direction`` (``matvec`` for the
direct modes, ``rmatvec`` for the adjoint), with the configuration's
``krylov`` settings (``k_dim``, ``nev``, ``tol``) and the mix's
``schur_del`` and ``max_restarts``.  The control runs the reference's
Arnoldi loop (``reference/krylov.py``) on the reference's operator.

Checked: ``start_vector``; ``prop_<direction>`` of sampled applications;
``krylov_basis``, the next Arnoldi column formed from each sampled output
(``harness/check.py``).
"""

from __future__ import annotations

from bench_port.harness import check

KEYS = {"direction", "schur_del", "max_restarts"}


def directions(traffic: dict) -> list:
    return [traffic["direction"]]


def analysis(traffic: dict, krylov: dict, op, space, x0, rec, control: bool) -> None:
    """One analysis from x0, every application through ``rec``."""
    d = traffic["direction"]
    apply = rec.wrap(d, op.matvec if d == "matvec" else op.rmatvec)
    if control:
        from bench_port.reference import krylov as plain

        plain.arnoldi(apply, x0, krylov["k_dim"], space)
        return
    from nekstab_next_tpu_torch.krylov.krylov_schur import eigs

    eigs(apply, space, x0, k_dim=krylov["k_dim"], nev=krylov["nev"], tol=krylov["tol"],
         schur_del=traffic["schur_del"], max_restarts=traffic["max_restarts"])


def judge(ref, apps, pending, traffic: dict, krylov: dict, nsteps: int, x0, seed: int) -> dict:
    """The compared numbers of one run (worst over the sampled
    applications); a basis is followed up to its first restart."""
    numbers = check.start_vector(ref, apps, x0)
    for i in check.sample(apps, directions(traffic), traffic["checked_applications"], seed):
        check.propagator(ref, apps[i], nsteps, numbers)
        check.next_column(ref, apps, pending, i, krylov["k_dim"], numbers)
    return numbers
