"""Sampling profiler: where does the host loop spend its time?

Reference: flow/Profiler.actor.cpp — a SIGPROF-driven sampler that records
the running stack at a fixed interval into the trace stream, so production
stalls can be attributed without instrumenting the code. The Python host's
analogue samples the TARGET THREAD's frame stack from a background thread
(sys._current_frames — no signal needed, safe with the GIL), aggregates
(function, file, line) counts and flame-style stacks, and dumps the top
entries through a TraceEvent on stop.

Enable in a server with FDBTPU_SAMPLING_PROFILE=1 (server_main) or
programmatically:

    p = SamplingProfiler(interval=0.005)
    p.start()
    ...
    report = p.stop()       # [(frames_tuple, count)] hottest first
    p.trace_report()        # emits ProfilerReport trace events
"""

from __future__ import annotations

import sys
import threading
import time


class SamplingProfiler:
    def __init__(self, interval: float = 0.005, target_thread: int | None = None,
                 max_depth: int = 40):
        self.interval = interval
        self.target_thread = target_thread or threading.main_thread().ident
        self.max_depth = max_depth
        self.samples: dict[tuple, int] = {}
        self.total_samples = 0
        self._running = False
        self._thread: threading.Thread | None = None

    def start(self):
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._sample_loop,
                                        name="fdbtpu-profiler", daemon=True)
        self._thread.start()

    def _sample_loop(self):
        while self._running:
            frames = sys._current_frames()
            frame = frames.get(self.target_thread)
            if frame is not None:
                stack = []
                f = frame
                while f is not None and len(stack) < self.max_depth:
                    code = f.f_code
                    stack.append((code.co_name, code.co_filename, f.f_lineno))
                    f = f.f_back
                key = tuple(reversed(stack))
                self.samples[key] = self.samples.get(key, 0) + 1
                self.total_samples += 1
            time.sleep(self.interval)

    def stop(self) -> list[tuple[tuple, int]]:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        return sorted(self.samples.items(), key=lambda kv: -kv[1])

    def hottest_functions(self, top: int = 10) -> list[tuple[str, int]]:
        """Leaf-function attribution: which function was EXECUTING."""
        counts: dict[str, int] = {}
        for stack, n in self.samples.items():
            name, filename, _line = stack[-1]
            label = f"{name} ({filename.rsplit('/', 1)[-1]})"
            counts[label] = counts.get(label, 0) + n
        return sorted(counts.items(), key=lambda kv: -kv[1])[:top]

    def trace_report(self, top: int = 10, who: str = "profiler"):
        """Dump the hottest leaves through the trace stream (the reference
        writes its samples into the trace the same way)."""
        from foundationdb_tpu_torch.utils.trace import TraceEvent
        for label, n in self.hottest_functions(top):
            TraceEvent("ProfilerSample", who) \
                .detail("Where", label) \
                .detail("Samples", n) \
                .detail("Fraction", round(n / max(1, self.total_samples), 4)) \
                .log()
