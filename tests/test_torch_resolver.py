"""The port's Resolver role against the JAX Resolver.

Both resolvers boot in their own package's EventLoop/SimNetwork and get the
same stream of chained ResolveTransactionBatchRequests (prev_version ->
version, sent all at once so the resolver orders them) from a proxy-like
driver actor: the `committed` lists and `state_mutations` of every reply
must be equal, and equal to the port's oracle backend. The JAX side runs
its JAX engine (CONFLICT_CPU_FALLBACK="jax"; "host" would silently run the
oracle), pinned to one compiled program as in test_torch_conflict.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from foundationdb_tpu.core import eventloop as j_eventloop
from foundationdb_tpu.core import sim as j_sim
from foundationdb_tpu.ops import batch as j_batch
from foundationdb_tpu.ops import conflict as jconf
from foundationdb_tpu.server import interfaces as j_interfaces
from foundationdb_tpu.server import resolver as j_resolver
from foundationdb_tpu.utils import rng as j_rng
from foundationdb_tpu.utils.knobs import KNOBS as JKNOBS
from foundationdb_tpu_torch.core import eventloop as t_eventloop
from foundationdb_tpu_torch.core import sim as t_sim
from foundationdb_tpu_torch.ops import batch as t_batch
from foundationdb_tpu_torch.ops import kernels
from foundationdb_tpu_torch.ops.batch import COMMITTED, CONFLICT, TOO_OLD
from foundationdb_tpu_torch.server import interfaces as t_interfaces
from foundationdb_tpu_torch.server import resolver as t_resolver
from foundationdb_tpu_torch.utils import rng as t_rng
from foundationdb_tpu_torch.utils.errors import FDBError
from foundationdb_tpu_torch.utils.knobs import KNOBS as TKNOBS

SHAPE_KNOBS = dict(CONFLICT_STATE_CAPACITY=1024, CONFLICT_BATCH_TXNS=64,
                   CONFLICT_BATCH_READS_PER_TXN=4,
                   CONFLICT_BATCH_WRITES_PER_TXN=4)

PORT = SimpleNamespace(eventloop=t_eventloop, sim=t_sim, batch=t_batch,
                       interfaces=t_interfaces, resolver=t_resolver,
                       rng=t_rng)
JAX = SimpleNamespace(eventloop=j_eventloop, sim=j_sim, batch=j_batch,
                      interfaces=j_interfaces, resolver=j_resolver, rng=j_rng)


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    """Port knobs reset around each test; both banks get the test shape.
    The JAX engine keeps one program: its bucket is pinned to the full
    shape (decisions do not depend on the bucket)."""
    TKNOBS.reset()
    TKNOBS.overrides(CONFLICT_DEVICE="cpu", **SHAPE_KNOBS)
    JKNOBS.overrides(CONFLICT_BACKEND="device", CONFLICT_CPU_FALLBACK="jax",
                     **SHAPE_KNOBS)

    def plan_chunk(self, nr, nw):
        return self.shapes, jconf._compiled_step(
            self.shapes, JKNOBS.MAX_WRITE_TRANSACTION_LIFE_VERSIONS,
            *self._intra)
    monkeypatch.setattr(jconf.DeviceConflictSet, "plan_chunk", plan_chunk)
    yield
    TKNOBS.reset()


def point(k):
    return (k, k + b"\x00")


def request_stream(seed, n_batches, step=10_000):
    """[(prev_version, version, [(snapshot, reads, writes)], state_idx)]."""
    rng = np.random.default_rng(seed)
    space = [b"key%03d" % i for i in range(120)]
    out, prev = [], 0
    for i in range(n_batches):
        version = prev + step
        txns = []
        for _ in range(rng.integers(0, 150)):
            snap = max(0, prev - int(rng.integers(0, 4)) * step)
            reads = [point(space[k]) for k in rng.integers(0, 120,
                                                           rng.integers(0, 4))]
            writes = [point(space[k]) for k in rng.integers(0, 120,
                                                            rng.integers(0, 4))]
            if rng.integers(10) == 0:
                a, b = sorted(rng.integers(0, 120, 2))
                writes.append((space[a], space[b]))
            txns.append((snap, reads, writes))
        state_idx = ([int(j) for j in rng.integers(0, len(txns), 2)]
                     if txns and i % 3 == 0 else None)
        out.append((prev, version, txns, state_idx))
        prev = version
    return out


def serve(stack, stream, address="resolver", sequential=False):
    """Boot one resolver of `stack`, send the whole stream at once (or each
    request after the previous reply) from a proxy-like actor, return
    [(committed, state_mutations) or error name]."""
    loop = stack.eventloop.EventLoop()
    net = stack.sim.SimNetwork(loop, stack.rng.DeterministicRandom(1))
    res_proc = net.new_process(address)
    proxy = net.new_process("proxy")
    stack.resolver.Resolver(res_proc)
    ep = stack.sim.Endpoint(address, stack.interfaces.Token.RESOLVER_RESOLVE)
    Txn = stack.batch.TxnConflictInfo
    Req = stack.interfaces.ResolveTransactionBatchRequest

    async def drive():
        futs, out = [], []
        for prev, version, txns, state_idx in stream:
            # the proxy acknowledges two batches late, so the resolver hands
            # back the state txns of the versions in between
            req = Req(prev_version=prev, version=version,
                      last_receive_version=max(0, prev - 2 * (version - prev)),
                      transactions=[Txn(s, list(r), list(w))
                                    for s, r, w in txns],
                      state_txn_indices=state_idx,
                      state_txn_mutations=(
                          [[f"m{version}.{j}"] for j in state_idx]
                          if state_idx else None))
            futs.append(net.request(proxy, ep, req))
            if sequential:
                out.append(await collect(futs.pop()))
        for f in futs:
            out.append(await collect(f))
        return out

    async def collect(f):
        try:
            rep = await f
            return list(rep.committed), rep.state_mutations
        except Exception as e:  # noqa: BLE001 — compared by name
            return getattr(e, "name", repr(e))

    # bounded in virtual time: the resolver's counter loop never idles
    return loop.run_future(proxy.spawn(drive(), "driver"), max_time=600.0)


@pytest.mark.parametrize("seed", [1, 2])
def test_resolver_replies_match_jax_and_oracle(seed):
    stream = request_stream(seed, 12)
    port_out = serve(PORT, stream)
    jax_out = serve(JAX, stream)
    assert port_out == jax_out
    TKNOBS.set("CONFLICT_BACKEND", "oracle")
    assert serve(PORT, stream) == port_out
    decided = [s for rep in port_out for s in rep[0]]
    assert {COMMITTED, CONFLICT} <= set(decided)
    assert any(rep[1] for rep in port_out)  # state txns were handed back


def test_resolver_too_old_and_retransmit():
    TKNOBS.set("MAX_WRITE_TRANSACTION_LIFE_VERSIONS", 5_000)
    stream = [(0, 10_000, [(0, [], [point(b"a")])], None),
              (10_000, 30_000, [(0, [point(b"a")], [])], None),
              (10_000, 30_000, [(0, [point(b"a")], [])], None)]
    out = serve(PORT, stream, sequential=True)
    assert out[0][0] == [COMMITTED]
    assert out[1][0] == out[2][0] == [TOO_OLD]  # the retransmit is cached


def test_overflow_poisons_the_resolver():
    TKNOBS.overrides(CONFLICT_STATE_CAPACITY=32)  # a batch adds 16
    stream = [(i * 10, (i + 1) * 10,
               [(0, [], [point(b"%03d" % (i * 8 + j))]) for j in range(8)],
               None) for i in range(4)]
    out = serve(PORT, stream, sequential=True)
    assert out[0][0] == [COMMITTED] * 8
    assert "internal_error" in out
    # every later batch errors too: poisoned replies, then (the version
    # chain stops at the poison) a timeout; never a decision
    first = out.index("internal_error")
    assert out[first + 1] == "internal_error"
    assert all(isinstance(o, str) for o in out[first:])


def test_backends_sharded_refuses_and_cuda_raises_without_a_card(
        monkeypatch):
    TKNOBS.set("CONFLICT_BACKEND", "sharded")
    with pytest.raises(FDBError) as ei:
        t_resolver.new_conflict_set()
    assert ei.value.name == "invalid_option"
    TKNOBS.overrides(CONFLICT_BACKEND="device", CONFLICT_DEVICE="cuda")
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(FDBError) as ei:
        t_resolver.new_conflict_set()
    assert ei.value.name == "platform_error"


def test_metrics_report_backend_and_launch_counts():
    loop = t_eventloop.EventLoop()
    net = t_sim.SimNetwork(loop, t_rng.DeterministicRandom(2))
    proc = net.new_process("r")
    client = net.new_process("c")
    t_resolver.Resolver(proc)
    fut = net.request(client, t_sim.Endpoint(
        "r", t_interfaces.Token.RESOLVER_METRICS), None)
    snap = loop.run_future(fut)
    assert snap["Backend"] == "cpu"
    assert set(f"KernelLaunches.{k}" for k in kernels.KERNELS) <= set(snap)
