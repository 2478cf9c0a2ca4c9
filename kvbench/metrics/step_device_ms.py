"""step_device_ms: device time of the kernels of one step in the traced
slice (torch.profiler): each kernel's mean launch time times its launches
a step, so that launches the trace missed do not count as faster steps."""


def read(ctx):
    tl, step = ctx["trace"], ctx["step"]
    if tl is None or step is None or tl.kernels() == 0:
        return None
    return tl.step_kernel_s(step["steps"]) * 1e3
