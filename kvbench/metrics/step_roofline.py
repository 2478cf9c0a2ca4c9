"""step_roofline: the least time for a step's bytes at the device's peak
HBM rate (kvbench/work.py), as a share of the step's device time."""

from kvbench import work


def read(ctx):
    tl, step = ctx["trace"], ctx["step"]
    if tl is None or step is None or tl.kernels() == 0:
        return None
    least = work.least_step_s(step, ctx["device_kind"])
    if least is None:
        return None
    return 100.0 * least / tl.step_kernel_s(step["steps"])
