"""The profiler's trace of a run's traced slice, reduced to what the
metrics and the breakdown read: the device operations inside the slice's
range (WINDOW), their union (busy), their idle gaps, and the host range of
the harness that each gap fell in.

The trace is torch.profiler's Chrome trace export: "X" events with "ts"
and "dur" in microseconds on one clock for the host and the device.
Device operations are the categories "kernel", "gpu_memcpy" and
"gpu_memset"; the harness's own ranges are "user_annotation" events named
"kvbench.*".
"""

from __future__ import annotations

import json
from pathlib import Path

WINDOW = "kvbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Timeline:
    def __init__(self, lo: float, hi: float, ops: list, host: list):
        self.lo, self.hi = lo, hi
        self.ops = ops  # (cat, name, start, end) clipped to [lo, hi], us
        self.host = host  # (name, start, end) of the harness's ranges

    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def kernel_counts(self) -> dict:
        """{kernel name: (launches traced, their seconds)}."""
        out: dict = {}
        for cat, n, s, e in self.ops:
            if cat == "kernel":
                count, secs = out.get(n, (0, 0.0))
                out[n] = (count + 1, secs + (e - s) / 1e6)
        return out

    def kernels(self) -> int:
        return sum(count for count, _s in self.kernel_counts().values())

    def step_kernel_s(self, steps: int) -> float:
        """Device seconds of the kernels of one step. The trace can miss
        launches (CUPTI drops records), so a kernel that launches about
        once a step or more counts its mean launch times its launches a
        step; a rarer one (the rebase's) its seconds spread over the
        steps."""
        total = 0.0
        for count, secs in self.kernel_counts().values():
            per_step = round(count / steps)
            total += secs / count * per_step if per_step else secs / steps
        return total

    def coverage(self, steps: int) -> float:
        """Launches traced over the launches the steps made by the
        reckoning of `step_kernel_s` (1.0: none missed)."""
        made = sum(max(round(count / steps), count / steps) * steps
                   for count, _s in self.kernel_counts().values())
        return self.kernels() / made if made else 1.0

    def _union(self) -> list:
        spans = []
        for _c, _n, s, e in sorted(self.ops, key=lambda o: o[2]):
            if spans and s <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], e)
            else:
                spans.append([s, e])
        return spans

    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        return sum(e - s for s, e in self._union()) / 1e6

    def gaps(self) -> list:
        """(start, end) of the window's stretches with no device op."""
        out, at = [], self.lo
        for s, e in self._union():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.hi > at:
            out.append((at, self.hi))
        return out

    def _host_at(self, s: float, e: float) -> str:
        best, name = 0.0, "host"
        for n, hs, he in self.host:
            overlap = min(e, he) - max(s, hs)
            if overlap > best:
                best, name = overlap, n
        return name

    def breakdown(self) -> dict:
        by_name: dict = {}
        for _c, n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n[:200], v] for n, v in ops],
                "idle_gaps": [[self._host_at(s, e), (e - s) / 1e6]
                              for s, e in gaps]}


def load(path: Path) -> Timeline:
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = [e for e in spans if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError(f"the trace holds no {WINDOW} range")
    lo = float(window[0]["ts"])
    hi = lo + float(window[0]["dur"])
    ops, host = [], []
    for e in spans:
        s = float(e["ts"])
        t = s + float(e["dur"])
        if e.get("cat") in DEVICE_CATS and t > lo and s < hi:
            ops.append((e["cat"], e["name"], max(s, lo), min(t, hi)))
        elif e.get("cat") == "user_annotation" and \
                e["name"].startswith("kvbench.") and e["name"] != WINDOW:
            host.append((e["name"], s, t))
    return Timeline(lo, hi, ops, host)
