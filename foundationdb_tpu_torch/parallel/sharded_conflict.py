"""Key-partitioned conflict engine over a list of devices.

Counterpart of foundationdb_tpu/parallel/sharded_conflict.py, the
reference's multi-resolver scale-out (SURVEY.md §2.0): the proxy splits each
transaction's conflict ranges across resolvers by a key-range map
(MasterProxyServer.actor.cpp:283-306) and a transaction commits only if
every resolver it touched said Committed, the min over their verdicts
(:492-504). Here each entry of a device list is one resolver shard:

- Shard d keeps its own step-function state and owns keys in
  [cut_d, cut_{d+1}); the cuts are state, so resolutionBalancing moves
  them between batches without touching the step.
- A chunk is one K10 launch (`clip_ranges`: every range clipped to every
  shard), the step of each shard on its clipped copy (the kernels of the
  single-device step), then one K11 launch (`shard_combine`: the proxy's
  min over the shards' statuses, with the `info` the JAX `local_step`
  gets from `pmin`/`pmax`). A range clipped to empty is inert in every
  phase of the step, which is "this resolver was not touched" without
  dynamic shapes.
- As JAX's `shard_map`, one process drives every shard. A device may
  repeat: W shards may share one card, or the CPU (the tests). A shard on
  another card gets its clipped batch with a non-blocking copy, and its
  verdicts come back to the first shard's card for K11.
- The engine's state lives in fixed buffers (each shard's, the cuts) that
  every chunk, rebase, re-cut and clear writes in place, as JAX donates
  its state. `ShardedStepGraph` runs a chunk over them from one packed
  batch buffer: with every shard on one card, as one CUDA graph (K10, the
  W shard steps, K11: one replay from the host, the `shard_map` program's
  counterpart); with shards on several cards, eagerly. The engine makes
  that choice at construction and reports it (`graphed`). K11 writes the
  readback row the engine copies back.

Per-shard "earlier txns win" is the reference's resolver semantics: each
shard merges the writes of the txns IT judged committed, so a txn aborted
only on another shard still leaves its writes here. That can only make a
false conflict, never a false commit (Resolver.actor.cpp resolveBatch never
learns other resolvers' verdicts). The exact host pass for an unconverged
chunk has single-resolver semantics, so this engine runs full sandwich
rounds (T // 2 + 1) and treats an unconverged chunk as an error.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from foundationdb_tpu_torch.ops import conflict_ref as ref
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.ops.batch import TxnConflictInfo
from foundationdb_tpu_torch.ops.conflict import (_REBASE_THRESHOLD,
                                                 BatchEncoder, ConflictShapes,
                                                 _resolve_shapes,
                                                 detect_async_impl)
from foundationdb_tpu_torch.ops.step_graph import (_Program, batch_layout,
                                                   batch_views,
                                                   fill_empty_batch)
from foundationdb_tpu_torch.utils import cudaenv
from foundationdb_tpu_torch.utils import keys as keylib
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS

L = keylib.NUM_LIMBS
NEG = ref.NEG


def make_resolver_mesh(n_devices: int | None = None, device=None
                       ) -> list[torch.device]:
    """The devices of the shards, one per shard (`make_resolver_mesh`).
    `device` (default: the CONFLICT_DEVICE knob) "cuda": cards 0..n-1, n
    every attached card when None or 0; more than are attached raises
    invalid_option, and no CUDA at all platform_error. "cpu": n shards that
    share the CPU (one when None or 0)."""
    kind = torch.device(KNOBS.CONFLICT_DEVICE if device is None
                        else device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise FDBError("platform_error",
                           "CUDA shards asked for, but CUDA is not available "
                           "to this process")
        avail = torch.cuda.device_count()
        n = n_devices or avail
        if n > avail:
            raise FDBError(
                "invalid_option",
                f"CONFLICT_NUM_SHARDS={n} exceeds the {avail} attached "
                f"device(s); set 0 to span all of them")
        return [torch.device("cuda", i) for i in range(n)]
    return [cudaenv.resolve_device(kind)] * (n_devices or 1)


def shard_cut_bytes(n_shards: int) -> list[bytes]:
    """Byte-space begin boundaries of the n equal key partitions
    (cuts[0] == b""); usable directly in host range maps."""
    return [b""] + [((d * (1 << 32)) // n_shards).to_bytes(4, "big")
                    for d in range(1, n_shards)]


def shard_cut_bytes_range(n_shards: int, begin: bytes = b"",
                          end: bytes | None = None) -> list[bytes]:
    """Equal cuts of the resolver's OWNED range [begin, end), the inner
    split under an outer ResolverMap partition. cuts[0] stays b"": shard 0
    also absorbs the space below `begin`, so clipping stays total without a
    per-range ownership check. `end=None` means the end of the keyspace. A
    range too narrow to cut n ways at 4-byte granularity falls back to
    whole-space cuts (extra shards then sit idle on keys the resolver never
    sees)."""
    lo = int.from_bytes(begin[:4].ljust(4, b"\x00"), "big")
    hi = (1 << 32) if end is None else int.from_bytes(
        end[:4].ljust(4, b"\x00"), "big")
    if hi - lo < n_shards:
        return shard_cut_bytes(n_shards)
    return [b""] + [(lo + (d * (hi - lo)) // n_shards).to_bytes(4, "big")
                    for d in range(1, n_shards)]


def _cut_limbs(cut_bytes: list[bytes]) -> np.ndarray:
    """(n + 1, L) uint32: the encodings of the n cuts, then the all-ones
    sentinel, after every real key."""
    n = len(cut_bytes)
    cuts = np.zeros((n + 1, L), dtype=np.uint32)
    for d, kb in enumerate(cut_bytes):
        cuts[d] = keylib.encode_key(kb)
    cuts[n, :] = 0xFFFFFFFF
    return cuts


def shard_cut_keys(n_shards: int) -> np.ndarray:
    """(n_shards + 1, L) int32 limbs (the port's sign-flipped encoding):
    shard d owns [cuts[d], cuts[d + 1]). Rows 0..n-1 encode
    shard_cut_bytes exactly; the last row is the all-ones sentinel, which
    is PAD_LIMB in every limb."""
    return keylib.to_signed_limbs(_cut_limbs(shard_cut_bytes(n_shards)))


def _on(dev: torch.device):
    """Make `dev` current for the kernels' launches (CUDA only)."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def graph_fits(devices, phases) -> bool:
    """Whether a sharded chunk over shards on `devices` with `phases` runs
    as one CUDA graph: every shard on one card, and the phases the kernels
    (the plain phases read the host). Shards on several cards run eagerly
    (ROADMAP B13)."""
    home = devices[0]
    return (home.type == "cuda" and phases is kernels.PHASES
            and all(d == home for d in devices))


def _sharded_chunk(state: dict, batch: dict, *, max_write_life: int,
                   intra_mode: str, intra_rounds: int, strided: bool, phases,
                   ablate: str = "", out: dict | None = None, clipped=None):
    """(state, batch) -> (state', statuses, info, row), as the JAX sharded
    step, with K11's (2T+2,) readback row. state: {"shards": W state
    dicts, "lo", "hi": (W, L) int32 on the first shard's device}; batch:
    one encoded batch on that device. With `out` (a sharded state of fixed
    buffers, which may be `state`) every shard's step writes its state
    there and `out` is returned; with `clipped` (four (W, L, N) int32
    tensors) K10 writes the clipped ranges there."""
    lo, hi = state["lo"], state["hi"]
    home = lo.device
    clipped = phases.clip_ranges(batch["rb"], batch["re"], batch["wb"],
                                 batch["we"], lo, hi,
                                 **({} if clipped is None
                                    else {"out": clipped}))
    shards, outs = [], []
    for d, shard in enumerate(state["shards"]):
        dev = shard["bval"].device
        sub = dict(batch, **{k: c[d] for k, c in zip(("rb", "re", "wb", "we"),
                                                     clipped)})
        if dev != home:
            sub = {k: v.to(dev, non_blocking=True) for k, v in sub.items()}
        with _on(dev):
            new, st, info = ref.conflict_step(
                shard, sub, max_write_life=max_write_life,
                intra_rounds=intra_rounds, intra_mode=intra_mode,
                strided=strided, phases=phases, ablate=ablate,
                **({} if out is None else {"out": out["shards"][d]}))
        shards.append(new)
        outs.append((st, info))

    def at_home(t):
        return t if t.device == home else t.to(home, non_blocking=True)
    statuses, info, row = phases.shard_combine(
        [at_home(st) for st, _i in outs],
        *([at_home(i[k]) for _st, i in outs]
          for k in ("eligible", "overflow", "boundaries", "converged")),
        batch["txn_valid"])
    new_state = {"shards": shards, "lo": lo, "hi": hi} if out is None else out
    return new_state, statuses, info, row


def _sharded_step(state: dict, batch: dict, **kw):
    """(state, batch) -> (state', statuses, info), as the JAX sharded step
    (`_sharded_chunk` without the row)."""
    new_state, statuses, info, _row = _sharded_chunk(state, batch, **kw)
    return new_state, statuses, info


class ShardedStepGraph(_Program):
    """One sharded chunk over the fixed sharded state `state` (as
    `init_sharded_state` lays it out) from the packed batch buffer
    `buffer` (fill it, then `run()`): K10 into fixed clipped buffers, each
    shard's step writing its fixed state, K11. `run()` returns (row,
    info): K11's (2T+2,) int32 readback row and the chunk's `info`; a
    graphed program returns the same tensors at every run, overwritten by
    the next. Graphed (one CUDA graph, one replay a chunk) needs every
    shard on the cuts' card; `graphed=False` runs the same chunk eagerly,
    on any devices (the yardstick on the card, the only mode on the CPU
    and across cards)."""

    def __init__(self, state: dict, *, txns: int, reads: int, writes: int,
                 max_write_life: int, intra_rounds: int = 0,
                 strided: bool = False, intra_mode: str = "scan",
                 phases=None, graphed: bool = True):
        home = state["lo"].device
        if graphed and any(s["bval"].device != home for s in state["shards"]):
            raise FDBError("invalid_option",
                           f"a sharded CUDA graph needs every shard on "
                           f"{home}; shards on several cards run eagerly")
        super().__init__(state, home, max_write_life=max_write_life,
                         intra_rounds=intra_rounds, strided=strided,
                         ablate="", intra_mode=intra_mode, phases=phases,
                         graphed=graphed)
        W, L = state["lo"].shape
        self.layout, size = batch_layout(L, txns, reads, writes)
        self.buffer = torch.empty(size, dtype=torch.int32, device=home)
        self.batch = batch_views(self.buffer, self.layout)
        fill_empty_batch(self.batch, txns)
        self.clipped = tuple(torch.empty((W, L, n), dtype=torch.int32,
                                         device=home)
                             for n in (reads, reads, writes, writes))

    def _state_copy(self) -> dict:
        return clone_sharded_state(self.state)

    def _body(self, state: dict):
        _s, _st, info, row = _sharded_chunk(state, self.batch, out=state,
                                            clipped=self.clipped,
                                            **self.step_kw)
        return row, info

    _warm_step = _body

    def run(self):
        return self._run()


def clone_sharded_state(state: dict) -> dict:
    """A copy of a sharded state, every shard's tensors and the cuts."""
    return {"shards": [{k: v.clone() for k, v in s.items()}
                       for s in state["shards"]],
            "lo": state["lo"].clone(), "hi": state["hi"].clone()}


def sharded_conflict_step(devices, shapes: ConflictShapes,
                          max_write_life: int, intra_mode: str = "scan",
                          intra_rounds: int = 0, phases=None):
    """The sharded step, (state, batch) -> (state', statuses, info), over
    the shards of `devices` (one per shard, as `init_sharded_state` lays
    them out), with `phases` (default the kernels, `kernels.PHASES`).
    The shard's owned range [lo, hi) is part of the state, so
    resolutionBalancing re-cuts between batches without a new step."""
    if shapes.key_bytes != keylib.KEY_BYTES:
        raise ValueError(
            f"sharded engine only supports the default key width "
            f"({keylib.KEY_BYTES}B); got key_bytes={shapes.key_bytes}")
    if intra_mode not in ref.INTRA_MODES:
        raise FDBError("invalid_option",
                       f"CONFLICT_INTRA_MODE must be one of "
                       f"{ref.INTRA_MODES}, got {intra_mode!r}")
    return functools.partial(
        _sharded_step, max_write_life=max_write_life, intra_mode=intra_mode,
        intra_rounds=intra_rounds, strided=shapes.strided,
        phases=kernels.PHASES if phases is None else phases)


def init_sharded_state(shapes: ConflictShapes, devices, oldest: int = 0,
                       cut_bytes: list[bytes] | None = None,
                       phases=None) -> dict:
    """Empty per-shard states, shard d's on devices[d]; each shard owns
    [cut_d, cut_{d+1}), the cuts held as state (lo, hi: (W, L) int32 on
    devices[0])."""
    phases = kernels.PHASES if phases is None else phases
    n = len(devices)
    shards = []
    for dev in devices:
        with _on(dev):
            shards.append(ref.init_state(shapes.capacity, shapes.limbs, dev,
                                         oldest=oldest, phases=phases))
    cuts = torch.from_numpy(keylib.to_signed_limbs(
        _cut_limbs(cut_bytes or shard_cut_bytes(n)))).to(devices[0])
    return {"shards": shards, "lo": cuts[:n].clone(), "hi": cuts[1:].clone()}


class ShardedDeviceConflictSet:
    """Multi-device conflict set: the host interface of DeviceConflictSet
    with the state split by key range over `devices` (default: every
    shard the CONFLICT_DEVICE knob gives, `make_resolver_mesh()`). One
    logical resolver spanning devices: the reference's N-resolver topology
    collapsed into one program; the Resolver role's ordering and recovery
    are unchanged. `phases` defaults to the kernels (`kernels.PHASES`).

    The state is fixed buffers, and every chunk runs through one
    `ShardedStepGraph`: a CUDA graph, one replay a chunk, where
    `graph_fits` (every shard on one card, the kernels' phases), else
    eagerly (shards on several cards, the CPU, other phases). The choice
    is made here and kept in `graphed`."""

    # the exact host pass has single-resolver semantics: an unconverged
    # chunk is an error here (full sandwich rounds make it unreachable)
    host_fallback = False

    def __init__(self, devices=None, capacity: int | None = None,
                 txns: int | None = None, reads_per_txn: int | None = None,
                 writes_per_txn: int | None = None, oldest_version: int = 0,
                 cut_bytes: list[bytes] | None = None, phases=None):
        self.devices = [cudaenv.resolve_device(d)
                        for d in (devices or make_resolver_mesh())]
        self.device = self.devices[0]
        self.n_shards = len(self.devices)
        self.shapes = _resolve_shapes(capacity, txns, reads_per_txn,
                                      writes_per_txn)
        self.encoder = BatchEncoder(self.shapes, self.device,
                                    base_version=oldest_version)
        self.oldest_version = oldest_version
        self.cut_bytes = list(cut_bytes or shard_cut_bytes(self.n_shards))
        assert self.cut_bytes[0] == b"" and len(self.cut_bytes) == self.n_shards
        self.phases = kernels.PHASES if phases is None else phases
        self._state = init_sharded_state(self.shapes, self.devices, oldest=0,
                                         cut_bytes=self.cut_bytes,
                                         phases=self.phases)
        # full sandwich rounds (T // 2 + 1): per-shard "earlier txns win"
        # plus the min does not reduce to the host pass's single-resolver
        # semantics, so every chunk must converge on the device; the
        # sandwich skips the rounds it does not need once it has pinched
        intra_mode = str(KNOBS.CONFLICT_INTRA_MODE)
        intra_rounds = self.shapes.txns // 2 + 1 if intra_mode == "scan" else 0
        self.graphed = graph_fits(self.devices, self.phases)
        sh = self.shapes
        self._program = ShardedStepGraph(
            self._state, txns=sh.txns, reads=sh.reads, writes=sh.writes,
            max_write_life=KNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
            intra_rounds=intra_rounds, intra_mode=intra_mode,
            phases=self.phases, graphed=self.graphed)
        # resolutionBalancing inputs (masterserver.actor.cpp:955-1012 via
        # the Resolver's iops sampling :146-151): per-shard range counts
        # and a bounded reservoir of range-begin prefixes
        self._load_counts = np.zeros(self.n_shards, dtype=np.int64)
        self._samples: list[int] = []  # first-4-byte ints of range begins
        self._batches_since_check = 0
        # cuts scheduled by rebalance_from_conflicts, applied by the next
        # detect_async (the dispatch path owns every state restructure)
        self._pending_cuts: list[bytes] | None = None
        self._sample_rng = np.random.RandomState(0)
        self.rebalances = 0

    @property
    def base_version(self) -> int:
        return self.encoder.base_version

    def _maybe_rebase(self, commit_version: int):
        # every shard's K1 rebase, in <= 2^30 steps (see DeviceConflictSet)
        while commit_version - self.encoder.base_version > _REBASE_THRESHOLD:
            delta = min(commit_version - self.encoder.base_version - (1 << 24),
                        1 << 30)
            for shard in self._state["shards"]:
                with _on(shard["bval"].device):
                    ref.rebase_state(shard, delta, phases=self.phases,
                                     out=shard)
            self.encoder.base_version += delta

    def plan_chunk(self, nr: int, nw: int) -> ConflictShapes:
        """One shape: no buckets, unlike the single-device engine."""
        return self.shapes

    def dispatch_chunk(self, sub, commit_version: int, skip: list[bool],
                       shapes: ConflictShapes,
                       advance_floor: bool) -> torch.Tensor:
        """Encode one chunk into the program's batch buffer (one H2D copy)
        and run it, a replay where `graphed`: K11's (2T+2,) int32 readback
        row [statuses | eligible | overflow | converged] on the first
        shard's device."""
        self.encoder.encode_batch(sub, commit_version, skip=skip,
                                  shapes=shapes, advance_floor=advance_floor,
                                  dest=self._program.buffer)
        row, _info = self._program.run()
        return row

    def warmup(self):
        """Capture the chunk's graph (building the kernels; its warm-up
        step runs on a copy of the state), then serve one empty batch."""
        self._program.capture()
        self.detect([], self.encoder.base_version + 1)

    def detect(self, txns: list[TxnConflictInfo],
               commit_version: int) -> list[int]:
        return self.detect_async(txns, commit_version).result()

    def detect_async(self, txns: list[TxnConflictInfo], commit_version: int):
        if self._pending_cuts is not None:
            cuts, self._pending_cuts = self._pending_cuts, None
            if cuts != self.cut_bytes:
                self.rebalance_cuts(cuts, commit_version)
        self._record_load(txns)
        self._batches_since_check += 1
        if self._batches_since_check >= KNOBS.RESOLUTION_BALANCE_CHECK_BATCHES:
            self._batches_since_check = 0
            self.maybe_rebalance(commit_version)
        return detect_async_impl(self, txns, commit_version)

    def clear(self, oldest_version: int = 0):
        """clearConflictSet: every shard's buffers refilled in place, the
        cuts kept."""
        self.encoder.base_version = oldest_version
        self.oldest_version = oldest_version
        for shard in self._state["shards"]:
            with _on(shard["bval"].device):
                ref.init_state(self.shapes.capacity, self.shapes.limbs,
                               shard["bval"].device, oldest=0,
                               phases=self.phases, out=shard)
        # stale load and samples must not drive a rebalance of the fresh
        # state
        self._load_counts[:] = 0
        self._samples.clear()
        self._batches_since_check = 0
        self._pending_cuts = None

    # -- resolutionBalancing --

    def _record_load(self, txns):
        """One vectorised pass a batch (it rides the resolver's hot path)."""
        begins = [b for t in txns for b, _e in t.read_ranges]
        wbegins = [b for t in txns for b, _e in t.write_ranges]
        if not begins and not wbegins:
            return
        prefixes = np.array(
            [int.from_bytes(b[:4].ljust(4, b"\x00"), "big")
             for b in begins + wbegins], dtype=np.uint64)
        cut_pref = np.array(
            [int.from_bytes(cb[:4].ljust(4, b"\x00"), "big")
             for cb in self.cut_bytes], dtype=np.uint64)
        shard_idx = np.searchsorted(cut_pref, prefixes, side="right") - 1
        np.add.at(self._load_counts, shard_idx, 1)
        wpref = prefixes[len(begins):]
        cap = 8192
        room = cap - len(self._samples)
        if room > 0:
            self._samples.extend(wpref[:room].tolist())
            wpref = wpref[room:]
        if len(wpref):
            js = self._sample_rng.randint(0, cap, size=len(wpref))
            for j, v in zip(js.tolist(), wpref.tolist()):
                self._samples[j] = v

    def maybe_rebalance(self, at_version: int) -> bool:
        """Re-cut the key partition when per-shard load skews (sampled load
        -> new cuts -> state restructure, between batches). Returns True if
        a rebalance ran."""
        total = int(self._load_counts.sum())
        if (total < KNOBS.RESOLUTION_BALANCE_MIN_SAMPLES
                or len(self._samples) < self.n_shards * 4):
            return False
        mean = total / self.n_shards
        if self._load_counts.max() <= KNOBS.RESOLUTION_BALANCE_SKEW * mean:
            return False
        qs = np.quantile(np.asarray(self._samples, dtype=np.float64),
                         [d / self.n_shards for d in range(1, self.n_shards)])
        new_cuts = [b""]
        for q in qs:
            cb = int(min(max(q, 0), (1 << 32) - 1)).to_bytes(4, "big")
            if cb <= new_cuts[-1]:
                return False  # degenerate sample (mass on one prefix)
            new_cuts.append(cb)
        self.rebalance_cuts(new_cuts, at_version)
        return True

    def rebalance_from_conflicts(self, ranges) -> bool:
        """Conflict-mass re-cut: `ranges` is [(begin, end, rate)] from the
        resolver's HotRangeSketch. Pure host numpy: it only plans and
        schedules the cuts (safe on the event loop, no device sync);
        detect_async applies them at the next batch, so cuts never move
        under a batch in flight. Returns True iff a re-cut was
        scheduled."""
        if not ranges:
            return False
        prefs = np.array(
            [int.from_bytes(b[:4].ljust(4, b"\x00"), "big")
             for b, _e, _r in ranges], dtype=np.float64)
        mass = np.array([r for _b, _e, r in ranges], dtype=np.float64)
        total = float(mass.sum())
        if total <= 0.0:
            return False
        cut_pref = np.array(
            [int.from_bytes(cb[:4].ljust(4, b"\x00"), "big")
             for cb in self.cut_bytes], dtype=np.float64)
        shard_idx = np.searchsorted(cut_pref, prefs, side="right") - 1
        per_shard = np.zeros(self.n_shards, dtype=np.float64)
        np.add.at(per_shard, shard_idx, mass)
        skew = KNOBS.RESOLUTION_BALANCE_SKEW * (total / self.n_shards)
        if per_shard.max() <= skew:
            return False
        # weighted-quantile cuts: hot ranges in key-prefix order, a cut
        # where the cumulative mass crosses each d/n target
        order = np.argsort(prefs, kind="stable")
        cum = np.cumsum(mass[order])
        targets = [total * d / self.n_shards
                   for d in range(1, self.n_shards)]
        idxs = np.searchsorted(cum, targets, side="left")
        sorted_prefs = prefs[order]
        new_cuts = [b""]
        for i in idxs:
            i = min(int(i), len(order) - 1)
            cb = int(sorted_prefs[i]).to_bytes(4, "big")
            while cb <= new_cuts[-1]:
                # the target fell on or behind the previous cut: take the
                # next distinct hot prefix; none left means the mass sits
                # on one prefix, which no cut can split
                i += 1
                if i >= len(order):
                    return False
                cb = int(sorted_prefs[i]).to_bytes(4, "big")
            new_cuts.append(cb)
        if new_cuts == self.cut_bytes:
            return False
        self._pending_cuts = new_cuts
        return True

    def rebalance_cuts(self, new_cut_bytes: list[bytes], at_version: int):
        """Move the partition to `new_cut_bytes`. Conflict state is soft
        (clearConflictSet, SkipList.cpp:957): a shard's newly acquired
        subranges are filled at `at_version` (conservative: stale reads
        there conflict, never a false commit), retained subranges keep
        their exact history. No state moves between shards; each shard's
        keys and values are written into its fixed buffers and its table
        rebuilt there (K1), and the cuts are written in place."""
        assert len(new_cut_bytes) == self.n_shards and new_cut_bytes[0] == b""
        K = self.shapes.capacity
        st = ref.sharded_state_to_numpy(self._state)
        vfill = np.int32(self.encoder._clamp_off(at_version))
        cuts = _cut_limbs(new_cut_bytes)

        old_lo, old_hi = st["lo"], st["hi"]  # (n, L)
        nb = st["nb"]
        new_bkeys = np.full_like(st["bkeys"], 0xFFFFFFFF)
        new_bval = np.full_like(st["bval"], int(NEG))
        new_nb = np.zeros_like(nb)

        def np_lt1(a, b):  # lexicographic a < b over (L,) uint32
            for i in range(L):
                if a[i] != b[i]:
                    return a[i] < b[i]
            return False

        def np_cmp_vec(keys, q):  # (L, N) keys vs (L,) q -> (lt, eq) masks
            lt = np.zeros(keys.shape[1], bool)
            eq = np.ones(keys.shape[1], bool)
            for i in range(L):
                lt |= eq & (keys[i] < q[i])
                eq &= keys[i] == q[i]
            return lt, eq

        for d in range(self.n_shards):
            lo, hi = cuts[d], cuts[d + 1]
            a = old_lo[d] if np_lt1(lo, old_lo[d]) else lo  # retained begin
            b = old_hi[d] if np_lt1(hi, old_hi[d]) else hi  # retained end
            keys_d = st["bkeys"][d]  # (L, K)
            vals_d = st["bval"][d]
            live = np.arange(K) < int(nb[d])
            out_k: list[np.ndarray] = []  # (L, ni) pieces
            out_v: list[np.ndarray] = []
            if np_lt1(a, b):  # retained interval non-empty
                if np_lt1(lo, a):  # acquired prefix [lo, a)
                    out_k.append(lo[:, None])
                    out_v.append(np.asarray([vfill], np.int32))
                # value in effect at `a` = last live boundary <= a
                lt_a, eq_a = np_cmp_vec(keys_d, a)
                le_a = live & (lt_a | eq_a)
                n_le = int(le_a.sum())
                at_a = int(vals_d[n_le - 1]) if n_le else int(NEG)
                out_k.append(a[:, None])
                out_v.append(np.asarray([at_a], np.int32))
                lt_b, _ = np_cmp_vec(keys_d, b)
                interior = live & ~(lt_a | eq_a) & lt_b
                out_k.append(keys_d[:, interior])
                out_v.append(vals_d[interior])
                if np_lt1(b, hi):  # acquired suffix [b, hi)
                    out_k.append(b[:, None])
                    out_v.append(np.asarray([vfill], np.int32))
            else:
                # nothing retained: the whole new range conservative
                out_k.append(lo[:, None])
                out_v.append(np.asarray([vfill], np.int32))
            kcat = np.concatenate(out_k, axis=1)
            vcat = np.concatenate(out_v)
            if kcat.shape[1] > K:
                # cannot represent: collapse to fully conservative (safe)
                kcat = lo[:, None]
                vcat = np.asarray([vfill], np.int32)
            n = kcat.shape[1]
            new_bkeys[d, :, :n] = kcat
            new_bval[d, :n] = vcat
            new_nb[d] = n

        for d, shard in enumerate(self._state["shards"]):
            with _on(shard["bval"].device):
                shard["bkeys"].copy_(torch.from_numpy(np.ascontiguousarray(
                    keylib.to_signed_limbs(new_bkeys[d]))))
                shard["bval"].copy_(torch.from_numpy(new_bval[d]))
                shard["nb"].fill_(int(new_nb[d]))
                self.phases.build_table(shard["bval"], out=shard["table"])
        signed = torch.from_numpy(keylib.to_signed_limbs(cuts))
        self._state["lo"].copy_(signed[:self.n_shards])
        self._state["hi"].copy_(signed[1:])
        self.cut_bytes = list(new_cut_bytes)
        self._load_counts[:] = 0
        self._samples.clear()
        self.rebalances += 1
