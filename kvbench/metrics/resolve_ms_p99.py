"""resolve_ms_p99: the 99th percentile of a batch's resolve time, from its
copy's enqueue to its verdicts on the host (host clock), over every batch
of the window."""

import numpy as np


def read(ctx):
    lat = ctx["window"]["latencies_s"]
    return float(np.percentile(lat, 99)) * 1e3 if len(lat) else None
