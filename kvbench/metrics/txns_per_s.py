"""txns_per_s: every txn the window decided, over the window's wall time
(host clock, from the first batch's enqueue to the last batch's verdicts)."""


def read(ctx):
    w = ctx["window"]
    return w["txns"] / w["seconds"] if w["seconds"] > 0 else None
