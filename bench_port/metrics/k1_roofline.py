"""k1_roofline: the share of its roofline of K1, the velocity solve (csrc/fused_helmholtz_cg.cu),
over the traced applications: the least time the card could take for
every launch (the larger of its operations over 67 TFLOP/s and its bytes
over 3.35 TB/s, at the iterations that launch ran) over the kernel's time
summed by name in the device trace (``harness/roofline.py``)."""

from bench_port.harness import roofline

LAYER = "Kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "dof_steps_per_s"


def read(run):
    return roofline.share(run, "k1")
