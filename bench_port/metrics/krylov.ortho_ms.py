"""krylov.ortho_ms: the mean, over the window, of the Krylov layer's time
between two applications of one analysis (orthogonalisation, norm and
basis update of one Krylov step): the benchmark's spans, each ended by a
synchronise, outside the applications run under the profiler."""

LAYER = "Krylov layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "dof_steps_per_s"


def read(run):
    gaps = run.spans()[1]
    if not gaps:
        return None
    return 1e3 * sum(gaps) / len(gaps)
