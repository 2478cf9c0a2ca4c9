"""setup_s: from the process's start to the window's: imports, the card,
the kernel library (built by a checkout's first run), the traffic, the
encode, the graphs and the untimed warm-up pass (host clock)."""


def read(ctx):
    return ctx["setup_s"]
