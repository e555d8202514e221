"""device.idle_pct: the share of the traced window in which no kernel ran
on the card: 100 (1 - busy / window), busy the union of the kernels'
intervals in the device trace."""

LAYER = "Device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "dof_steps_per_s"


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
