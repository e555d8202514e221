"""The Golub-Kahan loop of ``svds`` (optimal transient growth).

A traffic mix with ``"loop": "golub_kahan"`` runs one analysis at a time
through the program's ``svds``, alternating ``matvec`` and ``rmatvec``,
with the configuration's ``krylov`` settings (``k_dim``; ``nev`` singular
values; ``tol``) and the mix's ``max_restarts``.  The control runs the
reference's bidiagonalisation (``reference/krylov.py``) on the
reference's operator.

Checked: ``start_vector``; ``prop_matvec`` and ``prop_rmatvec`` of
sampled applications (one of each at least); ``krylov_basis``, the next
left or right column formed from each sampled output
(``harness/check.py``).
"""

from __future__ import annotations

from bench_port.harness import check

KEYS = {"max_restarts"}


def directions(traffic: dict) -> list:
    return ["matvec", "rmatvec"]


def analysis(traffic: dict, krylov: dict, op, space, x0, rec, control: bool) -> None:
    """One analysis from x0, every application through ``rec``."""
    mv, rmv = rec.wrap("matvec", op.matvec), rec.wrap("rmatvec", op.rmatvec)
    if control:
        from bench_port.reference import krylov as plain

        plain.golub_kahan(mv, rmv, x0, krylov["k_dim"], space)
        return
    from nekstab_next_tpu_torch.krylov.svd import svds

    svds(mv, rmv, space, x0, nsv=krylov["nev"], k_dim=krylov["k_dim"], tol=krylov["tol"],
         max_restarts=traffic["max_restarts"])


def judge(ref, apps, pending, traffic: dict, krylov: dict, nsteps: int, x0, seed: int) -> dict:
    """The compared numbers of one run (worst over the sampled
    applications); the bases are followed up to their first restart,
    2 k_dim applications."""
    numbers = check.start_vector(ref, apps, x0)
    for i in check.sample(apps, directions(traffic), traffic["checked_applications"], seed):
        check.propagator(ref, apps[i], nsteps, numbers)
        check.next_column(ref, apps, pending, i, 2 * krylov["k_dim"], numbers)
    return numbers
