"""step.kernel_launches: K1 + K2 launches per time step over the window,
from the kernel instances' ``launches`` counters (a count that repeats
exactly)."""

LAYER = "Step and its solves"
UNIT = "launches"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "dof_steps_per_s"


def read(run):
    if not run.launches or not run.steps:
        return None
    return sum(run.launches.values()) / run.steps
