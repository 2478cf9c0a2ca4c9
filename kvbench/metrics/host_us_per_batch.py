"""host_us_per_batch: the harness's span around its calls into the port
that dispatch one batch (the copy into the StepGraph's buffer, the
replay, the asynchronous readback, the DetectHandle), mean microseconds
over the window's batches."""


def read(ctx):
    spans = ctx["spans"].get("dispatch_s")
    if spans is None or len(spans) == 0:
        return None
    return float(spans.mean()) * 1e6
