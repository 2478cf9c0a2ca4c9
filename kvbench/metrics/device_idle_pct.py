"""device_idle_pct: the share of the untraced window in which the device
ran nothing, reckoned from the traced slice: the device's busy seconds a
step there (the union of its kernels, copies and memsets, from
torch.profiler's timeline) times the window's steps, over the window's
wall seconds. The traced slice's own idle share, which the profiler's
host cost inflates where the host paces the loop, is the result line's
`busy_s` and `window_s`."""


def read(ctx):
    tl, step, w = ctx["trace"], ctx["step"], ctx["window"]
    if tl is None or step is None or tl.busy_s() <= 0 or w["seconds"] <= 0:
        return None
    busy = tl.busy_s() / step["steps"] * w["batches"]
    return 100.0 * (1.0 - busy / w["seconds"])
