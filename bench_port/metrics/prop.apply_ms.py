"""prop.apply_ms: the median wall time of one propagator application
(``LinearizedOperator.matvec`` or ``rmatvec``) in the window: the
benchmark's span, synchronised at both ends, outside the applications
run under the profiler."""

import statistics

LAYER = "Propagator"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "dof_steps_per_s"


def read(run):
    apps = run.spans()[0]
    if not apps:
        return None
    return 1e3 * statistics.median(a.t1 - a.t0 for a in apps)
