"""The conflict step and the conflict scan as CUDA graphs over fixed state
buffers.

Counterpart of `_compiled_step` and `_compiled_scan`
(foundationdb_tpu/ops/conflict.py:750-758, 771-799): one device dispatch
for a step, or for M steps, with the state donated
(`_donate_state_argnums`, :741-747). Here the state lives in fixed buffers
that every step overwrites (`conflict_ref.conflict_step(..., out=)`), and
the program is a CUDA graph captured once per key (shapes, window,
evaluator, rounds, layout, ablation; and M for the scan), so a replay is
one launch from the host in place of some 12 wrapper calls a step.

- `StepGraph`: one step over a packed int32 batch buffer (the resolver's
  chunk, `batch_layout`), writing the state in place and the (2T+2,)
  readback row [statuses | eligible | overflow | converged] (K13). The
  resolver's engine keeps one per shape bucket.
- `ScanGraph`: M steps over stacked batch fields (the kernel bench's
  chunk). Inside the graph the steps' states are the graph pool's own
  tensors; the last step writes the caller's fixed buffers. Each step
  writes its row of the (M, T) int8 statuses and of the (M,) committed
  and overflow outputs (K13).

Building a graph warms up first: one eager step of the program's shape on
a copy of the state, on a side stream, so that the kernel library and
every cached scratch buffer of ops/kernels.py exist before capture (a
scratch buffer made during capture would be the graph's memory, and a
zeroed one would not be zero). The capture fails, and raises, if a
scratch buffer appears during it. A program keeps the scratch buffers its
graph uses alive, so `kernels.release_scratch` cannot free them under it. The kernels' launch counts
(`kernels.LAUNCHES`) are incremented on the host, so a replay counts
nothing by itself: the program records the counts its capture added (and
takes them back: a capture launches nothing) and adds them at each
replay.

On CUDA a capture or replay that fails raises FDBError("internal_error");
nothing runs the eager step in its place. `graphed=False` runs the same
step function eagerly at each call (the yardstick the smoke times the
graphs against, and the only mode on the CPU). The legacy evaluator's
fixpoint loop is unbounded and read on the host (`run_legacy`, as the JAX
`while_loop`), so it cannot be captured: both programs refuse
intra_mode="legacy" with invalid_option, in either mode, and its callers
run `conflict_step` eagerly by name.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.utils.errors import FDBError

_I32 = torch.int32

# the batch fields of a step, with their shapes and whether they are bool
_BOOL_FIELDS = ("txn_valid", "advance_floor")


def _field_shapes(L: int, T: int, NR: int, NW: int) -> tuple:
    return (("rb", (L, NR)), ("re", (L, NR)), ("wb", (L, NW)),
            ("we", (L, NW)), ("rtxn", (NR,)), ("wtxn", (NW,)),
            ("snapshot", (T,)), ("commit_version", ()),
            ("txn_valid", (T,)), ("advance_floor", ()))


def batch_layout(L: int, T: int, NR: int, NW: int) -> tuple[dict, int]:
    """({field: (offset, shape)}, size in int32 words) of one packed batch
    buffer, so a chunk moves to the device in a single copy. The bool
    fields are bytes (four to a word) that a bool tensor views directly,
    so a step needs no conversion op."""
    out, off = {}, 0
    for name, shape in _field_shapes(L, T, NR, NW):
        out[name] = (off, shape)
        n = math.prod(shape)
        off += -(-n // 4) if name in _BOOL_FIELDS else n
    return out, off


def batch_views(buf, layout: dict) -> dict:
    """The fields of a packed batch buffer (an int32 tensor or numpy
    array) as views of their shapes; bool fields are byte views (bool
    tensors, uint8 arrays)."""
    views = {}
    for name, (off, shape) in layout.items():
        n = math.prod(shape)
        if name in _BOOL_FIELDS:
            words = buf[off:off + -(-n // 4)]
            if isinstance(buf, np.ndarray):
                raw = words.view(np.uint8)[:n]
            else:
                raw = words.view(torch.uint8)[:n].view(torch.bool)
            views[name] = raw.reshape(shape)
        else:
            views[name] = buf[off:off + n].reshape(shape)
    return views


def fill_empty_batch(batch: dict, T: int):
    """An all-padding batch in place: no valid txn, every range the
    padding key, owners T; a step over it is a valid no-op step."""
    for name in ("rb", "re", "wb", "we"):
        batch[name].fill_(ref.PAD_LIMB)
    for name in ("rtxn", "wtxn"):
        batch[name].fill_(T)
    for name in ("snapshot", "commit_version"):
        batch[name].fill_(0)
    for name in _BOOL_FIELDS:
        batch[name].fill_(False)


def _check_modes(intra_mode: str, ablate: str):
    if intra_mode != "scan":
        raise FDBError(
            "invalid_option",
            f"a step graph runs the scan evaluator only, not "
            f"intra_mode={intra_mode!r}: the legacy fixpoint is read on the "
            f"host every round, so its callers run conflict_step eagerly")
    if ablate not in ref.ABLATE_MODES:
        raise FDBError("invalid_option",
                       f"ablate must be one of {ref.ABLATE_MODES}, got "
                       f"{ablate!r}")


def _launch_delta(before: dict) -> dict:
    return {k: n - before[k] for k, n in kernels.LAUNCHES.items()
            if n != before[k]}


class _Program:
    """What both programs share: the fixed state, the step's options, the
    warm-up, the capture and the replay with its launch counts."""

    def __init__(self, state: dict, *, max_write_life: int, intra_rounds: int,
                 strided: bool, ablate: str, intra_mode: str, phases,
                 graphed: bool):
        _check_modes(intra_mode, ablate)
        self.state = state
        self.device = state["bval"].device
        if graphed and self.device.type != "cuda":
            raise FDBError("invalid_option",
                           f"a CUDA graph needs the state on a CUDA device, "
                           f"not {self.device}")
        self.graphed = graphed
        self.step_kw = dict(max_write_life=max_write_life,
                            intra_rounds=intra_rounds, intra_mode=intra_mode,
                            strided=strided, ablate=ablate,
                            phases=kernels.PHASES if phases is None
                            else phases)
        # the kernel launches of one run: recorded at capture (graphed) or
        # measured at the last run (eager)
        self.launches: dict = {}
        self.graph = None
        self.outputs = None
        self._scratch = None  # the kernel scratch the graph uses

    def _body(self, state: dict):
        raise NotImplementedError

    def _warm_step(self, state: dict):
        raise NotImplementedError

    def _capture(self):
        """Warm up, then capture `_body` over the fixed state."""
        dev = self.device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._warm_step({k: v.clone() for k, v in self.state.items()})
            torch.cuda.current_stream(dev).wait_stream(side)
            before = dict(kernels.LAUNCHES)
            caches = (kernels._zeroed, kernels._scratches)
            known = [set(c) for c in caches]
            graph = torch.cuda.CUDAGraph()
            failure = None
            try:
                with torch.cuda.graph(graph):
                    outputs = self._body(self.state)
            except Exception as e:
                failure = e
            finally:
                captured = _launch_delta(before)
                kernels.LAUNCHES.update(before)  # a capture launches nothing
            new = [set(c) - k for c, k in zip(caches, known)]
            if failure is not None or any(new):
                # nothing ran: forget any scratch made during the capture
                # (graph memory, never zeroed), so later launches make it anew
                for c, keys in zip(caches, new):
                    for key in keys:
                        del c[key]
                what = (f"failed: {type(failure).__name__}: {failure}"
                        if failure else "made a kernel scratch buffer that "
                        "the warm-up did not")
                raise FDBError("internal_error", f"capturing the "
                               f"{type(self).__name__} {what}") from failure
        # the graph holds the scratch buffers' addresses: keep them alive
        # past `kernels.release_scratch`, which only drops the caches' hold
        self._scratch = [list(c.values()) for c in caches]
        self.graph, self.outputs, self.launches = graph, outputs, captured

    def capture(self):
        """Capture the graph now (a graphed program otherwise captures at
        its first run): outside any timed region."""
        if self.graphed and self.graph is None:
            self._capture()

    def _replay(self):
        try:
            with torch.cuda.device(self.device):
                self.graph.replay()
        except Exception as e:
            raise FDBError("internal_error",
                           f"replaying the {type(self).__name__} failed: "
                           f"{type(e).__name__}: {e}") from e
        for name, n in self.launches.items():
            kernels.LAUNCHES[name] += n

    def _run(self):
        """The outputs of one run: a replay, or the eager body."""
        if self.graphed:
            self.capture()
            self._replay()
            return self.outputs
        before = dict(kernels.LAUNCHES)
        outputs = self._body(self.state)
        self.launches = _launch_delta(before)
        return outputs


class StepGraph(_Program):
    """One step over the packed batch buffer `buffer` (fill it, then
    `run()`): the `_compiled_step` counterpart. `run()` returns the (2T+2,)
    int32 readback row; a graphed program returns the same tensor at
    every run, overwritten by the next."""

    def __init__(self, state: dict, *, txns: int, reads: int, writes: int,
                 max_write_life: int, intra_rounds: int = 0,
                 strided: bool = False, ablate: str = "",
                 intra_mode: str = "scan", phases=None, graphed: bool = True):
        super().__init__(state, max_write_life=max_write_life,
                         intra_rounds=intra_rounds, strided=strided,
                         ablate=ablate, intra_mode=intra_mode, phases=phases,
                         graphed=graphed)
        self.txns = txns
        self.layout, size = batch_layout(state["bkeys"].shape[0], txns, reads,
                                         writes)
        self.buffer = torch.empty(size, dtype=_I32, device=self.device)
        self.batch = batch_views(self.buffer, self.layout)
        fill_empty_batch(self.batch, txns)

    def _body(self, state: dict):
        _s, _st, info = ref.conflict_step(state, self.batch, out=state,
                                          **self.step_kw)
        return info["readback"]

    _warm_step = _body

    def run(self) -> torch.Tensor:
        return self._run()


class ScanGraph(_Program):
    """M steps over stacked batch fields: the `_compiled_scan`
    counterpart. `run(stacked)` copies each field of `stacked` (leading
    axis M) into the static inputs, runs, and returns (statuses (M, T)
    int8, committed (M,) int32, overflow (M,) bool); the state is left in
    the fixed buffers. A graphed program returns the same tensors at every
    run: clone what must outlive the next."""

    def __init__(self, state: dict, *, steps: int, txns: int, reads: int,
                 writes: int, max_write_life: int, intra_rounds: int = 0,
                 strided: bool = False, ablate: str = "",
                 intra_mode: str = "scan", phases=None, graphed: bool = True):
        super().__init__(state, max_write_life=max_write_life,
                         intra_rounds=intra_rounds, strided=strided,
                         ablate=ablate, intra_mode=intra_mode, phases=phases,
                         graphed=graphed)
        if steps < 1:
            raise FDBError("invalid_option", f"a scan of {steps} steps")
        self.steps, self.txns = steps, txns
        L = state["bkeys"].shape[0]
        self.inputs = None
        if graphed:
            self.inputs = {
                name: torch.empty(
                    (steps, *shape), device=self.device,
                    dtype=torch.bool if name in _BOOL_FIELDS else _I32)
                for name, shape in _field_shapes(L, txns, reads, writes)}
            for i in range(steps):
                fill_empty_batch({k: v[i] for k, v in self.inputs.items()},
                                 txns)

    def _body(self, state: dict):
        _s, statuses, committed, overflow = ref.conflict_scan(
            state, self.inputs, out=state, **self.step_kw)
        return statuses, committed, overflow

    def _warm_step(self, state: dict):
        dev = self.device
        scan_out = (torch.empty((1, self.txns), dtype=torch.int8, device=dev),
                    torch.empty(1, dtype=_I32, device=dev),
                    torch.empty(1, dtype=torch.bool, device=dev))
        ref.conflict_step(state, {k: v[0] for k, v in self.inputs.items()},
                          out=state, scan_out=scan_out, **self.step_kw)

    def run(self, stacked: dict):
        if stacked["snapshot"].shape[0] != self.steps:
            raise FDBError("invalid_option",
                           f"a scan of {self.steps} steps was given "
                           f"{stacked['snapshot'].shape[0]} batches")
        if not self.graphed:  # the eager steps read the caller's tensors
            self.inputs = stacked
        else:
            for name, t in self.inputs.items():
                t.copy_(stacked[name])
        return self._run()
